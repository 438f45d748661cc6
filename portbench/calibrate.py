"""Readings that a cell's limits are set from, on the CUDA device at the
cell's own size: the program's numbers over many seeds (the lower
readings), the control's (the plain reference one precision lower, in the
program's place) and, for a training cell, a fault planted in the program
(half of the batch left out, the mean taken over the rest).  The benchmark's
runs do not run this; its readings and the limits set from them are in
``PERF.md``.

    python -m portbench.calibrate --workload <cell> --seeds 12 \
        --first-seed 7000000000 [--control 3] [--faults 3]

Prints one JSON line a seed and reading.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import harness


# every number a training cell can compare, read whether or not the mix
# holds it to a limit
ALL = {"packing_mismatches": 0, "loss_gap": 0, "grad_gap": 0,
       "change_gap": 0, "moment2_gap": 0}


def _emit(**row) -> None:
    print(json.dumps(row), flush=True)


def mve(cell, seeds, control, device) -> None:
    import torch
    from repro_torch.core.engine import compile_program
    from portbench import mve as mvedata

    config, traffic = cell.config, cell.traffic
    ref = harness.reference_module(config)
    machine = mvedata.machine(config)
    ex = config["executor"]
    patterns = config["patterns"]
    programs = {n: compile_program(mvedata.program(patterns[n]), machine,
                                   mode=ex["mode"], opt_level=ex["opt_level"],
                                   device=device)
                for n in mvedata.pattern_names(config)}
    for i, seed in enumerate(seeds):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        mismatched = lowered = 0
        for name, cp in programs.items():
            for _ in range(traffic["distinct_batches"]):
                images = mvedata.images(patterns[name],
                                        traffic["images_per_batch"], gen,
                                        device)
                out, _, _ = cp.run_batch(images)
                want = ref.expected(name, patterns[name], images)
                mismatched += int((out.view(torch.int32)
                                   != want.view(torch.int32)).sum())
                if i < control:
                    low = ref.expected(name, patterns[name], images,
                                       lower=True)
                    lowered += int((low.view(torch.int32)
                                    != want.view(torch.int32)).sum())
        _emit(seed=seed, kind="program", mismatched_values=mismatched)
        if i < control:
            _emit(seed=seed, kind="control", mismatched_values=lowered)


def train(cell, seeds, control, faults, device) -> None:
    import gc
    import torch
    from portbench import lm
    from portbench.trace import Spans, synchronize
    loop = cell.loop

    config, traffic = cell.config, cell.traffic
    ref_mod = harness.reference_module(config)

    def free():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def program_readings(seed, half=False):
        trainer = loop.build(cell, seed, device, Spans())
        if half:
            step = trainer.step_fn

            def half_step(params, opt, batch):
                rows = batch["tokens"].shape[0] // 2
                return step(params, opt, {k: x[:rows] for k, x in batch.items()})
            trainer.step_fn = half_step
        t = time.perf_counter()
        out = loop.first_steps(trainer, config)
        synchronize(device)
        seconds = time.perf_counter() - t
        batches = list(trainer.host_batches)
        del trainer
        free()
        return out, batches, seconds

    for i, seed in enumerate(seeds):
        prog, batches, prog_s = program_readings(seed)
        ref_batches = lm.reference_batches(config, traffic, seed, len(batches))
        t = time.perf_counter()
        ref = ref_mod.readings(config, seed, ref_batches, device)
        synchronize(device)
        ref_s = time.perf_counter() - t
        free()
        checks = loop.compare(prog, ref, batches, ref_batches, ALL)
        _emit(seed=seed, kind="program", program_s=prog_s, reference_s=ref_s,
              losses=prog["losses"], ref_losses=ref["losses"],
              **{k: c.value for k, c in checks.items()},
              worst=_worst(prog, ref))
        if i < control:
            low = ref_mod.readings(config, seed, ref_batches, device,
                                   lower=True)
            free()
            checks = loop.compare(low, ref, ref_batches, ref_batches, ALL)
            _emit(seed=seed, kind="control",
                  **{k: c.value for k, c in checks.items()})
        if i < faults:
            bad, batches, _ = program_readings(seed, half=True)
            checks = loop.compare(bad, ref, batches, ref_batches, ALL)
            _emit(seed=seed, kind="fault_half_batch",
                  **{k: c.value for k, c in checks.items()})


def _worst(prog: dict, ref: dict) -> dict:
    """Each leaf's gradient, change and second moment, program and
    reference, for the record."""
    return {k: [prog[n][k] for n in _NORMS] + [ref[n][k] for n in _NORMS]
            for k in sorted(ref["grad_norms"])}


_NORMS = ("grad_norms", "change_norms", "moment2_norms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=7_000_000_000)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_environment())
    harness.use_program()
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.find_cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    device = torch.device("cuda")
    if cell.config["kind"] == "mve":
        mve(cell, seeds, args.control, device)
    else:
        train(cell, seeds, args.control, args.faults, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
