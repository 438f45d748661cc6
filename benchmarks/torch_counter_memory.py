"""The dry run's memory count held against the card's allocator, op by op.

Runs ``chip_smoke.py``'s two dry-run cells (``DRYRUN_CELLS``:
whisper-base's train cell, 4 x 384 text tokens over 4 x 1500 frames;
qwen2-0.5b's prefill, 4 x 1024) once each through ``jitted_cell`` on a
``(data 1, model 1)`` mesh of one rank, random bf16 weights from a seed,
under :class:`~repro_torch.launch.hlo_analysis.CostCounter`.  After every
op the rank dispatches it records the counter's live bytes beside
``torch.cuda.memory_allocated()`` less the bytes before the step, and
prints, for each cell, the two peaks (the counter's, and
``max_memory_allocated`` less the bytes before) and the ops where the two
curves part most, each way.  Needs a CUDA device.

    PYTHONPATH=src python benchmarks/torch_counter_memory.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import DRYRUN_CELLS, _dryrun_batch  # noqa: E402
from repro_torch.configs import ShapeCell, get_config  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402
from repro_torch.launch.hlo_analysis import (local_tensors,  # noqa: E402
                                             storage_key)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.specs import (prefill_batch_specs,  # noqa: E402
                                      train_batch_specs)
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.parallel.axes import sharding_context  # noqa: E402

TOP = 5


class AllocatorTrace(hlo_analysis.CostCounter):
    """The counter, and after each op the rank runs: (op, live bytes,
    allocated bytes less ``base``)."""

    def __init__(self, known, base: int):
        super().__init__(known)
        self.base, self.trace = base, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented:
            self.trace.append((str(func), self.live,
                               torch.cuda.memory_allocated() - self.base))
        return out


def measure_cell(arch: str, spec, mesh) -> dict:
    cfg, cell = get_config(arch), ShapeCell(*spec)
    params = LM(cfg).init_params(
        torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(9)
    if cell.kind == "train":
        specs, _ = train_batch_specs(cfg, cell)
        args = (params, adamw_init(params),
                _dryrun_batch(specs, cfg.vocab_size, gen))
    else:
        specs, _ = prefill_batch_specs(cfg, cell)
        args = (params, _dryrun_batch(specs, cfg.vocab_size, gen))
    with sharding_context(mesh) as ctx:
        step, args = dryrun.prepare_cell(cfg, cell, ctx, args=args)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        known = {storage_key(t) for t in local_tensors(args)}
        with AllocatorTrace(known, base) as counter:
            step(*args)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base
    trace = counter.trace
    gaps = sorted(range(len(trace)), key=lambda i: trace[i][2] - trace[i][1])
    row = (lambda i: {"op": i, "name": trace[i][0], "live": trace[i][1],
                      "allocated": trace[i][2]})
    return {"cell": list(spec), "ops": len(trace),
            "counter_peak": counter.peak_bytes,
            "allocator_peak": measured,
            "peak_ratio": measured / counter.peak_bytes,
            "allocated_above_live": [row(i) for i in gaps[::-1][:TOP]],
            "live_above_allocated": [row(i) for i in gaps[:TOP]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_counter_memory needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    out = {"card": card, "torch": torch.__version__}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "cpu:gloo,cuda:nccl", rank=0, world_size=1,
            store=dist.FileStore(str(Path(tmp) / "store"), 1))
        try:
            mesh = make_mesh({"data": 1, "model": 1})
            for arch, spec in DRYRUN_CELLS:
                out[arch] = measure_cell(arch, spec, mesh)
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
