"""Wall-clock microbenchmarks of the port's hand-written kernels against
their plain PyTorch versions: the twin of ``benchmarks/kernels_bench.py``.

Each kernel runs through its wrapper on ``device`` (default ``cuda``: the
CUDA kernel; on ``cpu`` the wrapper takes the plain version) and, beside
it, its plain version called explicitly from
:mod:`repro_torch.kernels.ref`, on the same inputs drawn with NumPy from
the reference's seed:

* ``mdgather`` on a 2^15-element fp32 image, dims (128, 8, 8), strides
  (1, 0, 1024) (8192 lanes);
* the int8 and bit-plane GEMMs, 256 x 256 x 256;
* fp32 causal flash attention, 2 x 4 x 256 x 64;
* the ``transpose`` pattern through every registered target, with the
  target's modeled cycles.

Row names are the reference's (``*_pallas`` names the kernel's row); the
derived column says which route the wrapper took.  Each time is the mean
of 5 calls after one warm call, synchronized on ``cuda``::

    PYTHONPATH=src python -m benchmarks.torch_run --only kernels \
        --device cpu
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.machine import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.bitplane_gemm import bitplane_matmul, int8_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mdgather import mdgather


def _time(fn, *args, iters: int = 5) -> float:
    """Mean microseconds per call of ``fn(*args)`` after one warm call."""
    def sync():
        if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            torch.cuda.synchronize()
    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / iters * 1e6


def kernel_microbench(device=None) -> List[Tuple[str, float, str]]:
    dev = resolve_device(device)
    route = "cuda" if dev.type == "cuda" else "plain"
    rng = np.random.default_rng(0)
    rows = []

    # mdgather: 8192-lane 3D strided gather vs the plain gather
    src = torch.from_numpy(
        rng.standard_normal(1 << 15).astype(np.float32)).to(dev)
    dims, strides = (128, 8, 8), (1, 0, 1024)
    t_k = _time(lambda s: mdgather(s, dims, strides, 0), src)
    t_ref = _time(lambda s: ref.mdgather_ref(s, dims, strides, 0), src)
    rows.append(("kernels/mdgather_pallas", t_k, route))
    rows.append(("kernels/mdgather_ref", t_ref, f"ratio={t_k/t_ref:.1f}x"))

    # int8 GEMM 256x256x256
    x = torch.from_numpy(
        rng.integers(-128, 128, (256, 256)).astype(np.int8)).to(dev)
    w = torch.from_numpy(
        rng.integers(-128, 128, (256, 256)).astype(np.int8)).to(dev)
    t_i8 = _time(int8_matmul, x, w)
    t_bp = _time(bitplane_matmul, x, w)
    t_rf = _time(ref.int8_matmul_ref, x, w)
    rows.append(("kernels/int8_matmul_pallas", t_i8, "256^3"))
    rows.append(("kernels/bitplane_matmul_pallas", t_bp,
                 f"planes=8;vs_direct={t_bp/max(t_i8,1e-9):.1f}x"))
    rows.append(("kernels/int8_matmul_ref", t_rf, ""))

    # flash attention 2x4x256x64
    q, k, v = (torch.from_numpy(
        rng.standard_normal((2, 4, 256, 64)).astype(np.float32)).to(dev)
        for _ in range(3))
    t_fa = _time(lambda a, b, c: flash_attention(a, b, c, causal=True),
                 q, k, v)
    t_fr = _time(lambda a, b, c: ref.flash_attention_ref(a, b, c,
                                                         causal=True),
                 q, k, v)
    rows.append(("kernels/flash_attention_pallas", t_fa, "2x4x256x64"))
    rows.append(("kernels/flash_attention_ref", t_fr,
                 f"ratio={t_fa/t_fr:.1f}x"))

    # the transpose pattern through every registered target: the same
    # engine work (a dispatch-overhead check), each target's modeled cycles
    from repro_torch import targets
    from repro_torch.core.patterns import PATTERNS
    run = PATTERNS["transpose"]()
    memory = torch.from_numpy(run.memory).to(dev)
    for tname in targets.list_targets():
        art = targets.compile(run.program, target=tname, device=dev)
        t_eng = _time(lambda m: art.run(m)[0], memory)
        tl = art.timeline()
        rows.append((f"kernels/mve_transpose/{tname}", t_eng,
                     f"512x49;model_cycles={tl.total_cycles:.0f}"))
    return rows
