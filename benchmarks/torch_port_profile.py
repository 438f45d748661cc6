"""Where the time goes in the PyTorch/CUDA port's main path, on the card.

For every Section-IV pattern this times ``CompiledProgram.run`` on one
image (host clock around work that ends in a synchronise) and, for the
patterns whose program does not depend on the seed, ``run_batch`` over a
device-resident batch of images; a ``torch.profiler`` window over each
gives the device's busy share and the share of device time spent in the
hand-written ``mdgather`` / ``mdscatter`` kernels.  Needs a CUDA device;
prints one JSON object per line and writes them to ``--out``.

    PYTHONPATH=src python -m benchmarks.torch_port_profile \
        --batch 1024 --out torch_port_profile.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import MVEConfig, compile_program
from repro_torch.core.machine import as_memory
from repro_torch.core.patterns import PATTERNS

OURS = ("mdgather_kernel", "mdscatter_owner_kernel",
        "mdscatter_store_kernel")


def wall_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_profile(fn, iters: int):
    """(device busy ms per call, ms per call in the hand-written kernels,
    device kernel launches per call); busy time is the sum of kernel and
    memcpy/memset durations on the one stream the port uses."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = ours = launches = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if not dev_us or ev.device_type.name == "CPU":
            continue
        busy += dev_us
        launches += ev.count
        if any(name in ev.key for name in OURS):
            ours += dev_us
    return busy / 1e3 / iters, ours / 1e3 / iters, launches / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_profile needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    cfg = MVEConfig()
    dev = torch.device("cuda")
    rows = [{"card": card, "torch": torch.__version__, "batch": args.batch,
             "iters": args.iters}]
    print(json.dumps(rows[0]), flush=True)
    for name in sorted(PATTERNS):
        run = PATTERNS[name]()
        cp = compile_program(run.program, cfg)
        vector = sum(1 for i in run.program if i.is_vector())
        image = as_memory(run.memory, dev)
        row = {"pattern": name, "instructions": len(run.program),
               "vector_instructions": vector,
               "image_elements": int(image.shape[0])}

        def single():
            cp.run(image)
        row["run_ms"] = wall_ms(single, args.iters)
        busy, ours, launches = device_profile(single, args.iters)
        row.update(run_device_busy_ms=busy, run_ported_kernels_ms=ours,
                   run_device_launches=launches,
                   run_device_busy_share=busy / row["run_ms"])

        if PATTERNS[name](seed=0).program == PATTERNS[name](seed=1).program:
            images = torch.stack([
                as_memory(PATTERNS[name](seed=s).memory, dev)
                for s in range(args.batch)])

            def batched():
                cp.run_batch(images)
            iters = max(3, args.iters // 4)
            row["batch_ms"] = wall_ms(batched, iters)
            busy, ours, launches = device_profile(batched, iters)
            row.update(batch_device_busy_ms=busy,
                       batch_ported_kernels_ms=ours,
                       batch_device_launches=launches,
                       batch_device_busy_share=busy / row["batch_ms"],
                       batch_images_per_s=args.batch / row["batch_ms"] * 1e3)
            del images
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
