#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU, ``nvcc``
and PyTorch built for CUDA::

    python3 chip_smoke.py

It needs no arguments, no network and no file beyond the checkout.  Phases,
each printing one JSON line; any failure raises and the exit code is
non-zero:

1. ``device``  — ``torch.cuda`` must be available; the card's name and
   power limit as ``nvidia-smi`` gives them.
2. ``build``   — both CUDA kernels (``mdgather``, ``mdscatter``) are built
   from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a``, one
   compiler process per source, started together.
3. ``kernels`` — each kernel's wrapper against its plain PyTorch version on
   the card, bit for bit, at the shapes the main path gives it (8192 lanes;
   1-4 dims with a stride-0 dim; colliding stores; a dimension mask;
   fp32/int32/bf16/uint8; one image and a batch of 1024), timed with CUDA
   events beside the plain version and one PyTorch library call
   (``index_select`` / ``index_copy_`` on a precomputed address tensor —
   timed only, the port never calls them) and the card's memory bound.
4. ``path``    — the main path at the Table IV geometry (``MVEConfig()``,
   8192 lanes): every one of the 14 Section-IV patterns at its default size
   through ``compile_program(...).run`` on ``cuda``, checked against the
   pattern's NumPy reference, fused == stepwise bit for bit (both on the
   card), trace priced by the cost model; then ``run_pattern_batch`` over
   1024 seeds for every pattern whose program does not depend on the seed,
   equal to per-image runs on a sample.  The kernels' launch counters are
   set to 0 just before and read just after: a kernel never launched fails
   the run.
5. the card line, the ``{"kernels": [...]}`` line, and the final
   ``{"ok": true, "device": {...}}`` line.

Without a CUDA device, or without the rest of the checkout beside it, the
script exits non-zero and prints no result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device-memory rate (data sheet)
LANES = 8192
BATCH = 1024
SAMPLE = (0, BATCH // 2, BATCH - 1)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bits(x: torch.Tensor) -> torch.Tensor:
    """Integer view of a tensor, for bit-for-bit comparison."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.contiguous().view(view[x.element_size()])


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def random_tensor(shape, dtype, gen) -> torch.Tensor:
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    hi = 255 if dtype == torch.uint8 else 1 << 20
    return torch.randint(0, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int64).to(dtype)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

# (dims, strides, base): the access shapes of the patterns at 8192 lanes —
# unit stride (daxpy), row replication (gemm), a transposing CR stride, a
# 3-D and a 4-D walk with a stride-0 dimension each, and a short vector
# (fewer active lanes than the register holds); then two walks that leave
# the image, past its end and before its start (loads clamp, stores drop).
WALKS = [
    ((8192,), (1,), 0),
    ((64, 128), (0, 16), 5),
    ((512, 16), (49, 1), 0),
    ((16, 8, 64), (1, 0, 16), 3),
    ((8, 4, 16, 16), (1, 8, 0, 32), 7),
    ((100, 3), (1, 100), 11),
    ((8192,), (9,), 100),
    ((64, 128), (-3, 1), 50),
]
# store walks add collisions: a stride-0 dimension makes whole rows collide
# (the highest lane must win), and a partial overlap (2x + 3y).
STORE_WALKS = WALKS + [((3, 2), (1, 0), 2), ((64, 128), (2, 3), 0)]
DTYPES = [torch.float32, torch.int32, torch.bfloat16, torch.uint8]
IMAGE = 1 << 16


def check_kernels(ref, mdgather, mdscatter_):
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"mdgather": 0.0, "mdscatter": 0.0}
    cases = 0
    for batch in (1, BATCH):
        for dtype in DTYPES:
            shape = (IMAGE,) if batch == 1 else (batch, IMAGE)
            lshape = shape[:-1] + (LANES,)
            src = random_tensor(shape, dtype, gen)
            vals = random_tensor(lshape, dtype, gen)
            mask = torch.rand(LANES, generator=gen, device="cuda") < 0.7
            for dims, strides, base in WALKS:
                got = mdgather(src, dims, strides, base, lanes=LANES)
                want = ref.mdgather_ref(src, dims, strides, base, LANES)
                torch.cuda.synchronize()
                if not torch.equal(bits(got), bits(want)):
                    raise AssertionError(
                        f"mdgather != plain: {dims} {strides} {dtype} "
                        f"B={batch}")
                worst["mdgather"] = max(worst["mdgather"],
                                        max_abs_err(got, want))
                cases += 1
            for dims, strides, base in STORE_WALKS:
                for m in (None, mask):
                    got = mdscatter_(src.clone(), vals, dims, strides, base,
                                     m)
                    want = ref.mdscatter_ref(src, vals, dims, strides, base,
                                             m)
                    torch.cuda.synchronize()
                    if not torch.equal(bits(got), bits(want)):
                        raise AssertionError(
                            f"mdscatter != plain: {dims} {strides} {dtype} "
                            f"B={batch} mask={m is not None}")
                    worst["mdscatter"] = max(worst["mdscatter"],
                                             max_abs_err(got, want))
                    cases += 1
    # determinism of the colliding store, run to run
    dst = torch.zeros(BATCH, 4096, device="cuda")
    vals = random_tensor((BATCH, LANES), torch.float32, gen)
    first = mdscatter_(dst.clone(), vals, (64, 128), (1, 0), 0)
    for _ in range(5):
        again = mdscatter_(dst.clone(), vals, (64, 128), (1, 0), 0)
        if not torch.equal(first, again):
            raise AssertionError("mdscatter is not deterministic")
    return cases, worst


def time_kernels(ref, mdgather, mdscatter_):
    """Time both kernels at the main path's shape — the transposing 2-D
    walk of 8192 fp32 lanes over the ``transpose`` pattern's image — for a
    batch of 1024 images (the ``ms`` keys) and for one image."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    dims, strides, base, n = (512, 16), (49, 1), 0, 50176
    addr_host = np.asarray(
        ref.mdv_lane_addresses(dims, strides, base, LANES).cpu())
    unique = int(np.unique(addr_host).size)
    out = {}
    for batch, iters in ((BATCH, 30), (1, 300)):
        shape = (n,) if batch == 1 else (batch, n)
        image = random_tensor(shape, torch.float32, gen)
        vals = random_tensor(shape[:-1] + (LANES,), torch.float32, gen)
        mask = torch.ones(LANES, dtype=torch.bool, device="cuda")
        addr = torch.from_numpy(addr_host).cuda()
        dst = image.clone()
        elem = image.element_size()
        # least bytes: each needed input element read once, each output
        # element written once (the scatter also reads its lane mask)
        gather_bytes = batch * (unique + LANES) * elem
        scatter_bytes = batch * (LANES + unique) * elem + LANES
        rows = {
            "mdgather": dict(
                ms=time_ms(lambda: mdgather(image, dims, strides, base,
                                            lanes=LANES), iters),
                plain_ms=time_ms(lambda: ref.mdgather_ref(
                    image, dims, strides, base, LANES), iters),
                library_ms=time_ms(lambda: torch.index_select(
                    image, -1, addr), iters),
                bound_ms=gather_bytes / HBM_BYTES_PER_S * 1e3),
            "mdscatter": dict(
                ms=time_ms(lambda: mdscatter_(dst, vals, dims, strides,
                                              base, mask), iters),
                plain_ms=time_ms(lambda: ref.mdscatter_ref(
                    dst, vals, dims, strides, base, mask), iters),
                library_ms=time_ms(lambda: dst.index_copy_(
                    -1, addr, vals), iters),
                bound_ms=scatter_bytes / HBM_BYTES_PER_S * 1e3),
        }
        for name, row in rows.items():
            for key, value in row.items():
                out.setdefault(name, {})[
                    key if batch == BATCH else f"{key}_single"] = value
    shape_note = (f"fp32, dims {dims}, strides {strides}, {LANES} lanes, "
                  f"image {n}, batch {BATCH} (ms) / 1 (ms_single)")
    return out, shape_note


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def states_equal(a, b) -> bool:
    return (torch.equal(bits(a.memory), bits(b.memory))
            and set(a.regs) == set(b.regs)
            and all(a.regs[r].dtype == b.regs[r].dtype
                    and torch.equal(bits(a.regs[r]), bits(b.regs[r]))
                    for r in a.regs)
            and torch.equal(a.tag, b.tag))


def drive_main_path():
    from repro_torch.core import MVEConfig, compile_program, cost
    from repro_torch.core.interp import MVEInterpreter
    from repro_torch.core.machine import to_numpy
    from repro_torch.core.patterns import PATTERNS, run_pattern_batch

    cfg = MVEConfig()
    assert cfg.lanes == LANES
    oracle = MVEInterpreter(cfg, compiled=False)      # device: cuda
    rows = {}
    t0 = time.perf_counter()
    for name in sorted(PATTERNS):
        run = PATTERNS[name]()
        cp = compile_program(run.program, cfg)        # device: cuda
        mem, state = cp.run(run.memory)
        if mem.device.type != "cuda":
            raise AssertionError(f"{name}: ran on {mem.device}")
        run.check(to_numpy(mem), state)
        if not torch.isfinite(mem).all():
            raise AssertionError(f"{name}: non-finite memory")
        _, step_state = oracle.run_stepwise(run.program, run.memory)
        if not states_equal(state, step_state):
            raise AssertionError(f"{name}: fused != stepwise on the card")
        if len(state.trace) != len(step_state.trace) or not all(
                a.same_as(b) for a, b in zip(state.trace, step_state.trace)):
            raise AssertionError(f"{name}: traces differ")
        tl = cost.simulate(state.trace, cfg)
        energy = cost.mve_energy(tl, cfg, cost.data_bytes(state.trace))
        rows[name] = {"instructions": len(run.program),
                      "cycles": tl.total_cycles,
                      "energy_pj": energy.total_pj}
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    batched = []
    seeds = list(range(BATCH))
    for name in sorted(PATTERNS):
        probe = [PATTERNS[name](seed=s) for s in (0, 1)]
        if probe[0].program != probe[1].program:
            continue                      # data-dependent program (fir, spmm)
        runs, mems = run_pattern_batch(name, seeds, cfg)
        if mems.shape != (BATCH,) + runs[0].memory.shape:
            raise AssertionError(f"{name}: batch came back ragged")
        cp = compile_program(runs[0].program, cfg)
        for s in SAMPLE:
            one, _ = cp.run(runs[s].memory)
            if not np.array_equal(to_numpy(one).view(np.int32),
                                  mems[s].view(np.int32)):
                raise AssertionError(f"{name}: batch != run for seed {s}")
            runs[s].check(mems[s], None)
        batched.append(name)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    if len(batched) < 10:
        raise AssertionError(f"only {batched} ran batched")
    return rows, batched, single_s, batch_s


def main() -> int:
    t_start = time.perf_counter()
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs on a CUDA device only", file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, card=card, torch=torch.__version__,
         cuda=torch.version.cuda)

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.mdgather import mdgather
    from repro_torch.kernels.mdscatter import mdscatter_

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.load(name)
    logs = {name: [ln for ln in (_build.BUILD_DIR / f"{name}.log")
                   .read_text().splitlines() if "registers" in ln]
            for name in libs}
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(str(p.relative_to(ROOT)) for p in libs.values()),
         ptxas=logs)

    # ---- 3. kernels ------------------------------------------------------
    t0 = time.perf_counter()
    cases, worst = check_kernels(ref, mdgather, mdscatter_)
    timings, shape_note = time_kernels(ref, mdgather, mdscatter_)
    emit("kernels", seconds=time.perf_counter() - t0, cases=cases,
         tolerance="bit-equal (max_abs_err must be 0)", max_abs_err=worst,
         timed_at=shape_note, timings_ms=timings)

    # ---- 4. path ---------------------------------------------------------
    mdgather.launches = 0
    mdscatter_.launches = 0
    rows, batched, single_s, batch_s = drive_main_path()
    launches = {"mdgather": mdgather.launches,
                "mdscatter": mdscatter_.launches}
    emit("path", patterns=rows, batched=batched, batch=BATCH,
         single_seconds=single_s, batch_seconds=batch_s, launches=launches)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")

    # ---- 5. result -------------------------------------------------------
    replaces = {"mdgather": "src/repro/kernels/mdgather.py:33",
                "mdscatter": "src/repro/kernels/mdscatter.py:24"}
    kernels = []
    for name in ("mdgather", "mdscatter"):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
            "ms_single": t["ms_single"],
            "plain_ms_single": t["plain_ms_single"],
            "bound_ms_single": t["bound_ms_single"],
            "library_ms_single": t["library_ms_single"],
            "timed_at": shape_note})
    emit("total", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
