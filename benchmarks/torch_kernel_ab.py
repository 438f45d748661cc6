"""The port's kernel timings on one card: one tree's table, or trees A/B.

Every hand-written kernel of ``src/repro_torch/kernels/csrc`` is timed at
the shapes its main paths give it, beside its plain PyTorch version, one
PyTorch library call for the same function where one exists (timed only:
the port never calls it) and the card's bound for the same work, the
larger of its operations at the data-sheet peak and its bytes (inputs read
once, outputs written once) at the memory rate:

* ``mdgather`` at three load walks over the ``transpose`` pattern's image
  (``GATHER_WALKS``: its transposing walk, a contiguous run, gemm's
  replicating row walk) and ``mdscatter`` at the store walks of its three
  routes (``SCATTER_WALKS``), fp32, 8192 lanes, 1024 images and one;
* ``float_binary`` (float32 add) and ``float_convert`` (float32 ->
  float16), 1024 images and one;
* ``flash_attention`` at qwen2-0.5b's prefill (bf16, fp32 and bf16 at
  D = 128) and at ``FAMILY_SHAPES``; ``int8_matmul`` / ``bitplane_matmul``
  (8 and 4 planes) at qwen2-0.5b's MLP shape (``MLP_SHAPE``);
* ``flash_attention_bwd`` at ``TRAIN_SHAPES``, bf16 and fp32, with
  ``gqa_split`` forced each way where q heads share a kv head;
* the segmented flash forward and backward and the pre-pass
  (``flash_seg_tiles``) at the packed training cell's ``SEG_SHAPE``;
* the SSD kernels (``ssd_chunk_fwd``, ``ssd_chunk_bwd``) at Zamba2-7B's
  training shape (``SSD_SHAPE``) with the packed rows' runs;
* the host cost of the flash route (:func:`measure_flash_route`).

``ms`` is back-to-back calls on the device's clock (the host's overhead a
call shows where it is longer than the device's work), ``device_ms`` the
device alone (calls queued behind a sleeping kernel).  The kernels' checks
against their plain versions are the ``card`` tests
(``tests/test_torch_*_card.py``).

Each tree runs in a process of its own (both are the package
``repro_torch``) and builds its kernels into its own ``build/``; one JSON
line is printed per row and tree.  Needs a CUDA device.

    python -m benchmarks.torch_kernel_ab --src src            # the table
    python -m benchmarks.torch_kernel_ab --src OLD/src src src OLD/src \\
        --out build/ab.json                                     # an A/B

Run the trees in turns (old, new, new, old) so that a drift of the card
shows as a difference between the two runs of one tree.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device-memory rate (data sheet)
BF16_FLOPS = 989e12            # dense tensor-core peaks (data sheet)
INT8_OPS = 1979e12
FP32_FLOPS = 67e12             # float32 outside the tensor cores (data sheet)
TF32_FLOPS = 495e12            # dense TF32 tensor cores (data sheet)
# float32-accurate work: the lesser time of one product on the CUDA cores
# and three TF32 products on the tensor cores (3xTF32), 165 TFLOP/s
FP32_WORK_FLOPS = max(FP32_FLOPS, TF32_FLOPS / 3)
CAPTURE_TRIES = 3      # profiler captures of one call, see device_ops

BATCH, LANES = 1024, 8192
IMAGE = 50176                  # the transpose pattern's image, fp32
# The load walks timed, with the route of mdgather each takes: the
# transpose pattern's transposing load walk (the kernel table's main
# shape), a contiguous run (daxpy's, memcpy's) and gemm's replicating row
# walk.
GATHER_WALKS = {"transposing": ("tiled", ((512, 16), (49, 1), 0)),
                "contiguous": ("contiguous", ((8192,), (1,), 0)),
                "replicating": ("walk", ((64, 128), (0, 16), 0))}
# The store walks of the three routes of mdscatter_: the transpose
# pattern's real store (contiguous; the kernel table's main shape), its
# transposing load walk stored back (distinct), and whole rows colliding on
# one address each (colliding).
SCATTER_WALKS = {"contiguous": ((512, 16), (1, 512), 0),
                 "distinct": ((512, 16), (49, 1), 0),
                 "colliding": ((64, 128), (1, 0), 0)}
# qwen2-0.5b prefill: 4 requests x 1024 tokens, 14 q heads over 2 kv heads
LM_BATCH, LM_SEQ, Q_HEADS, KV_HEADS, HEAD_DIM = 4, 1024, 14, 2, 64
MLP_SHAPE = (LM_BATCH * LM_SEQ, 896, 4864)       # x (M, K) @ w (K, N)
# the shapes of the vlm and encdec families' serving, (B, H, Hkv, Sq, Sk, D,
# causal): llama-3.2-vision-11b's self attention and its cross layers over
# 1024 image tokens (prefill, and decode at one query row), whisper-base's
# encoder over 1500 frames, its decoder's self attention over a 384-token
# prompt and its cross attention (prefill, and decode)
FAMILY_SHAPES = {
    "vision_self": (LM_BATCH, 32, 8, 1024, 1024, 128, True),
    "vision_cross": (LM_BATCH, 32, 8, 1024, 1024, 128, False),
    "whisper_encoder": (LM_BATCH, 8, 8, 1500, 1500, 64, False),
    "whisper_self": (LM_BATCH, 8, 8, 384, 384, 64, True),
    "whisper_cross": (LM_BATCH, 8, 8, 384, 1500, 64, False),
    "vision_decode_cross": (LM_BATCH, 32, 8, 1, 1024, 128, False),
    "whisper_decode_cross": (LM_BATCH, 8, 8, 1, 1500, 64, False),
}
# the flash backward's training shapes, (B, H, Hkv, Sq, Sk, D, causal):
# whisper-base's encoder self attention over 1500 frames and its cross
# attention from 384 text tokens, llama-3.2-vision's cross attention over
# 1024 image tokens (GQA 4), qwen2-0.5b's causal self attention (GQA 7)
TRAIN_SHAPES = {
    "whisper_encoder": (LM_BATCH, 8, 8, 1500, 1500, 64, False),
    "whisper_cross": (LM_BATCH, 8, 8, 384, 1500, 64, False),
    "vision_cross": (LM_BATCH, 32, 8, 1024, 1024, 128, False),
    "qwen2_causal": (LM_BATCH, Q_HEADS, KV_HEADS, LM_SEQ, LM_SEQ, HEAD_DIM,
                     True),
}
# the packed training cell's self attention (qwen2-7b, portbench's
# train-packed-4k): q (4, 28, 4096, 128) over 4 kv heads, causal, with the
# segment ids of Poisson documents (mean 512, at least 16) packed into rows
SEG_SHAPE = (4, 28, 4, 4096, 128)             # B, H, Hkv, S, D
# The SSD's intra-chunk term (csrc/ssd_chunk.cu) at Zamba2-7B's training
# shape: B, S, chunk, groups, heads a group, head dim, state.
SSD_SHAPE = (4, 4096, 256, 2, 56, 64, 64)
# qwen2-0.5b's flash forward at one query row (a decode step's) and at its
# prefill; whisper-base's steps at 4 x 384 text tokens over 1500 frames
FLASH_ROUTE_SHAPES = {"qwen2_decode": (4, 14, 2, 1, 1024, 64),
                      "qwen2_prefill": (4, 14, 2, 1024, 1024, 64)}
STEP_BATCH, WHISPER_TEXT = 4, 384


# ---------------------------------------------------------------------------
# the clock
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int) -> float:
    """Mean time of ``fn()`` over ``iters`` back-to-back calls, on the
    device's clock: the host's overhead per call shows where it is longer
    than the device's work."""
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


def device_ms(fn, iters: int) -> float:
    """Device time of ``fn()`` alone: ``iters`` calls queued behind a
    sleeping kernel (about 0.1 s, longer than the host takes to queue
    them), so the device runs them back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters: int) -> float:
    """The least wall time of ``iters`` calls of ``fn``, the card
    synchronised after each: what a caller waits for one call, host and
    device, with as little of the other tenants' load on the host as the
    run saw."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def host_us(fn, iters: int) -> float:
    """The host's µs a call of ``fn``: ``iters`` calls queued behind a
    sleeping kernel, so that the device never makes the host wait; the
    least of 5 rounds."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        torch.cuda._sleep(50_000_000)       # ~30 ms, longer than the calls
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / iters * 1e6


def device_ops(fn) -> tuple[dict, int]:
    """``{name: count}`` of the device operations (kernels, memsets,
    copies) one call of ``fn`` issues, under ``torch.profiler``, and the
    number of calls made.  A capture that holds no device operation at all
    is taken again, up to ``CAPTURE_TRIES`` calls: the profiler's CUDA
    activity records can come back empty for a call of a few microseconds
    that did launch (its route counter moved)."""
    from torch.profiler import ProfilerActivity, profile

    for calls in range(1, CAPTURE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = {ev.key[:60]: ev.count for ev in prof.key_averages()
               if getattr(ev, "self_device_time_total", 0.0)
               and ev.device_type.name != "CPU"}
        if ops:
            break
    return ops, calls


def device_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: host wall ms, device
    busy ms (kernel + memcpy/memset time), the flash kernel's ms, device
    launches, host-blocking CUDA calls, and the five kernels that take the
    most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = flash = launches = blocking = 0.0
    kernels, blocking_by_call = [], {}
    for ev in prof.key_averages():
        if ev.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaMemcpy", "cudaHostAlloc", "cudaFreeHost"):
            blocking += ev.count
            blocking_by_call[ev.key] = ev.count
        if ev.key in ("aten::_local_scalar_dense", "aten::nonzero",
                      "aten::is_nonzero", "aten::item"):
            blocking_by_call[ev.key] = ev.count
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if not dev_us or ev.device_type.name == "CPU":
            continue
        busy += dev_us / 1e3
        launches += ev.count
        flash += dev_us / 1e3 if "flash_fwd" in ev.key else 0.0
        kernels.append((dev_us / 1e3, ev.count, ev.key[:60]))
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall, "flash_ms": flash,
            "device_launches": int(launches),
            "host_blocking_calls": int(blocking),
            "host_blocking_by_call": blocking_by_call,
            "top_kernels_ms_count": sorted(kernels, reverse=True)[:5]}


# ---------------------------------------------------------------------------
# inputs and bounds
# ---------------------------------------------------------------------------

def packed_ids(b: int, s: int, seed: int, device="cuda") -> torch.Tensor:
    """``(b, s)`` int32 ids: ``pack_documents`` over Poisson documents of
    mean 512 (at least 16), pads of id 0 at a row's end."""
    from repro_torch.core.packing import pack_documents

    rng = np.random.default_rng(seed)
    docs = [np.zeros(max(16, int(rng.poisson(512))), np.int32)
            for _ in range(4 * b * s // 512)]
    return torch.from_numpy(pack_documents(docs, s)[1][:b]).to(
        device=device, dtype=torch.int32)


def returning_ids(b: int, s: int, seed: int, device="cuda") -> torch.Tensor:
    """``(b, s)`` int32 ids of short documents (5-79 tokens) whose ids
    come back, 0 (a pad) among them."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([
        np.repeat(np.arange(s) % 5, rng.integers(5, 80, size=s))[:s]
        for _ in range(b)])).to(device=device, dtype=torch.int32)


def bwd_inputs(shape, dtype, gen):
    """q, k, v, dO drawn on the card, and the forward kernel's o and lse."""
    from repro_torch.kernels.flash_attention import _forward

    b, h, hk, sq, sk, d, causal = shape
    q, do = (torch.randn(b, h, sq, d, generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    o, lse = _forward(q, k, v, causal, 1.0 / d ** 0.5, with_lse=True)
    return q, k, v, o, lse, do


def ssd_inputs(shape, seed: int, runs: bool):
    """The SSD term's operands on the card as ``ssd_chunked`` forms them
    at ``shape``: C and B at the conv's scale, x dt, the log decay dt A (dt
    from a softplus, A = -exp(a_log) with a_log 1 as the port's init) and
    its cumulative sum within each chunk; with ``runs`` the rows' document
    runs cut into chunks (``packed_ids`` at 4096 tokens or more,
    ``returning_ids`` below)."""
    from repro_torch.models.ssm import document_runs

    b, s, cs, g, hg, p, n = shape
    nc = s // cs
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*size):
        return torch.randn(*size, generator=gen, device="cuda")

    cc, bc = (draw(b, nc, cs, g, n) * 0.5 for _ in range(2))
    dt = torch.nn.functional.softplus(draw(b, nc, cs, g, hg) - 2)
    xf = draw(b, nc, cs, g, hg, p) * dt[..., None]
    da_cum = torch.cumsum(dt * -math.e, 2)
    if not runs:
        return cc, bc, xf, da_cum, None
    ids = (packed_ids if s >= 4096 else returning_ids)(b, s, seed)
    return cc, bc, xf, da_cum, document_runs(ids).view(b, nc, cs)


def _bound(flops, nbytes, peak) -> tuple:
    """(the larger of ``flops`` at ``peak`` and ``nbytes`` at the memory
    rate, in ms; which of the two it is)."""
    by_ops, by_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops > by_bytes else "bytes"


def _visible_pairs(sq, sk, causal) -> int:
    rows = np.arange(sq) + (sk - sq)
    return int(np.clip(rows + 1, 0, sk).sum()) if causal else sq * sk


def flash_bound(b, h, hk, sq, sk, d, elem, causal=True, peak=BF16_FLOPS):
    """Least time for one attention call: the larger of its operations (two
    products over the visible (q, k) pairs, at ``peak``: the bf16
    tensor-core peak, or ``FP32_WORK_FLOPS`` for float32: three TF32
    products on the tensor cores or one on the CUDA cores, the faster) and
    its bytes (q, k, v read once, o written once; k/v have ``hk`` heads)
    over the memory rate."""
    flops = 4.0 * d * b * h * _visible_pairs(sq, sk, causal)
    return _bound(flops, elem * d * (2 * b * h * sq + 2 * b * hk * sk), peak)


def flash_bwd_bound(b, h, hk, sq, sk, d, elem, causal, peak=BF16_FLOPS):
    """Least time for one backward: the five ``2 * D`` products of each
    visible (q, k) pair (S and dP, dV, dK, dQ; the kernels recompute S and
    dP in both passes, which is their cost, not the function's) at
    ``peak``, or the bytes of q, k, v, o, dO and lse read once and dq, dk,
    dv written once at the memory rate."""
    flops = 10.0 * d * b * h * _visible_pairs(sq, sk, causal)
    nbytes = elem * d * (4 * b * h * sq + 4 * b * hk * sk) + 4 * b * h * sq
    return _bound(flops, nbytes, peak)


def gemm_bound(m, k, n):
    """Least time for an int8 product (the bit-plane kernel's function
    too: its planes sum to one such product): 2*M*N*K operations at the
    int8 peak, or M*K + K*N bytes read and 4*M*N written at the memory
    rate."""
    return _bound(2.0 * m * n * k, m * k + k * n + 4 * m * n, INT8_OPS)


def segmented_bound(ids, h, hk, d, elem, per_pair):
    """Least time for one causal call over contiguous segments: the
    ``per_pair * D`` operations of each visible pair (a key at or before
    its query in the query's own segment: ``c (c + 1) / 2`` pairs for a
    run of ``c`` equal ids, pads included) for each q head at the bf16
    peak, or the bytes of q, k, v and o (the forward; the backward's
    ``flash_bwd_bound`` bytes are a few times more, and still far under
    its operations here) over the memory rate."""
    b, s = ids.shape
    pairs = 0
    for row in ids.cpu().numpy():
        runs = np.diff(np.flatnonzero(np.diff(row, prepend=-1,
                                              append=-1) != 0))
        pairs += int((runs * (runs + 1) // 2).sum())
    nbytes = elem * d * (2 * b * h * s + 2 * b * hk * s) + 8 * b * s
    return (*_bound(float(per_pair) * d * h * pairs, nbytes, BF16_FLOPS),
            pairs)


def ssd_counts(shape) -> dict:
    """The SSD term's work at ``shape`` as ``portbench``'s count has it
    (whole chunks) and its bytes (inputs read once, outputs written
    once)."""
    b, s, cs, g, hg, p, n = shape
    unit = 2 * b * (s // cs) * g * cs * cs
    small = b * s * g * (2 * n + hg) * 4            # C, B, the log decay
    big = b * s * g * hg * p * 4                    # xf, y, dy, dx
    return dict(fwd_flops=unit * (n + hg * p),
                bwd_flops=unit * (3 * n + 2 * hg * p),
                fwd_bytes=small + 2 * big + b * s * 4,
                bwd_bytes=2 * small + 3 * big + b * s * 4)


def randint8(shape, gen, lo=-128, hi=128) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int16).to(torch.int8)


# ---------------------------------------------------------------------------
# the rows
# ---------------------------------------------------------------------------

def measure_mve() -> dict:
    """Both MVE kernels for a batch of 1024 images (the ``ms`` keys) and
    for one image (``_single``), fp32, 8192 lanes, over the ``transpose``
    pattern's image: the gather at its transposing load walk (``ms``) and
    at a contiguous and a replicating walk (``ms_contiguous``,
    ``ms_replicating``), the scatter at its store walk (``ms``) and at the
    other two routes' walks (``ms_distinct``, ``ms_colliding``), beside
    ``index_select`` / ``index_copy_`` (``library_ms``, and
    ``library_device_ms`` on the device alone).  Bounds count each needed
    element read once and each stored element written once, plus the lane
    mask."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mdgather import mdgather
    from repro_torch.kernels.mdscatter import mdscatter_

    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [("mdgather", "" if tag == "transposing" else f"_{tag}", walk)
              for tag, (_, walk) in GATHER_WALKS.items()] + [
        ("mdscatter", "" if route == "contiguous" else f"_{route}", walk)
        for route, walk in SCATTER_WALKS.items()]
    out, notes = {"mdgather": {}, "mdscatter": {}}, {}
    for name, tag, (dims, strides, base) in shapes:
        addr_host = np.asarray(
            ref.mdv_lane_addresses(dims, strides, base, LANES).cpu())
        unique = int(np.unique(addr_host).size)
        addr = torch.from_numpy(addr_host).cuda()
        mask = torch.ones(LANES, dtype=torch.bool, device="cuda")
        for batch, iters in ((BATCH, 30), (1, 300)):
            shape = (IMAGE,) if batch == 1 else (batch, IMAGE)
            image = torch.randn(shape, generator=gen, device="cuda")
            vals = torch.randn(shape[:-1] + (LANES,), generator=gen,
                               device="cuda")
            elem = image.element_size()
            if name == "mdgather":
                nbytes = batch * (unique + LANES) * elem
                call = (lambda: mdgather(image, dims, strides, base,
                                         lanes=LANES))
                plain = (lambda: ref.mdgather_ref(image, dims, strides, base,
                                                  LANES))
                library = (lambda: torch.index_select(image, -1, addr))
            else:
                # every lane is active, so each address has one winner:
                # read the mask and each winner's value, write the address
                nbytes = 2 * batch * unique * elem + LANES
                dst = image.clone()
                call = (lambda: mdscatter_(dst, vals, dims, strides, base,
                                           mask))
                plain = (lambda: ref.mdscatter_ref(dst, vals, dims, strides,
                                                   base, mask))
                library = (lambda: dst.index_copy_(-1, addr, vals))
            row = dict(ms=time_ms(call, iters), device_ms=device_ms(call, 100),
                       plain_ms=time_ms(plain, iters),
                       library_ms=time_ms(library, iters),
                       library_device_ms=device_ms(library, 100),
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            suffix = tag + ("" if batch == BATCH else "_single")
            for key, value in row.items():
                out[name][key + suffix] = value
        notes[name + tag] = f"dims {dims}, strides {strides}, image {IMAGE}"
    for name, library in (("mdgather", "torch.index_select"),
                          ("mdscatter", "Tensor.index_copy_")):
        out[name].update(bound_by="bytes", library=library, timed_at=(
            f"fp32, {LANES} lanes, batch {BATCH} (ms) / 1 (ms_single); "
            f"{notes}"))
    return out


def measure_float_ops() -> dict:
    """float32 add and the float32 -> float16 conversion at one image and
    at 1024 images of 8192 lanes: the kernel, its plain version, the
    torch op it replaces, and the bound (bytes: operands read once, the
    result written once)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.float_ops import float_binary, float_convert

    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {"float_binary": {}, "float_convert": {}}
    for batch, iters, suffix in ((BATCH, 30, ""), (1, 300, "_single")):
        a = torch.randn(batch, LANES, generator=gen, device="cuda")
        b = torch.randn(batch, LANES, generator=gen, device="cuda")
        n = a.numel()
        rows = {
            "float_binary": dict(
                ms=time_ms(lambda: float_binary("add", a, b), iters),
                device_ms=device_ms(lambda: float_binary("add", a, b), 100),
                plain_ms=time_ms(lambda: ref.float_binary_ref("add", a, b),
                                 iters),
                library_ms=time_ms(lambda: torch.add(a, b), iters),
                bound_ms=3 * 4 * n / HBM_BYTES_PER_S * 1e3),
            "float_convert": dict(
                ms=time_ms(lambda: float_convert(a, torch.float16), iters),
                device_ms=device_ms(
                    lambda: float_convert(a, torch.float16), 100),
                plain_ms=time_ms(
                    lambda: ref.float_convert_ref(a, torch.float16), iters),
                library_ms=time_ms(lambda: a.to(torch.float16), iters),
                bound_ms=(4 + 2) * n / HBM_BYTES_PER_S * 1e3)}
        for name, row in rows.items():
            for key, value in row.items():
                out[name][key + suffix] = value
    for name, what in (("float_binary", "float32 add (torch.add)"),
                       ("float_convert", "float32 -> float16 "
                                         "(Tensor.to)")):
        out[name].update(bound_by="bytes", timed_at=(
            f"{what}, {LANES} lanes, batch {BATCH} (ms) / 1 (ms_single)"))
    return out


def measure_family_shapes(gen) -> dict:
    """The flash kernel at each of ``FAMILY_SHAPES``: bf16 (``ms``, and
    ``device_ms`` queued behind a sleep, so the device's own time shows
    under a one-row call's host overhead) and float32, each beside
    ``scaled_dot_product_attention`` with ``enable_gqa`` (timed only;
    back to back and, ``library_device_ms``, behind a sleep) and its
    bound; the plain version in bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, (b, h, hk, sq, sk, d, causal) in FAMILY_SHAPES.items():
        q = torch.randn(b, h, sq, d, generator=gen, device="cuda")
        k, v = (torch.randn(b, hk, sk, d, generator=gen, device="cuda")
                for _ in range(2))
        q16, k16, v16 = (x.bfloat16() for x in (q, k, v))
        bound, by = flash_bound(b, h, hk, sq, sk, d, 2, causal=causal)
        bound32, by32 = flash_bound(b, h, hk, sq, sk, d, 4, causal=causal,
                                    peak=FP32_WORK_FLOPS)
        out[name] = dict(
            shape=f"q ({b}, {h}, {sq}, {d}), k/v ({b}, {hk}, {sk}, {d})",
            causal=causal,
            ms=time_ms(lambda: flash_attention(q16, k16, v16, causal=causal),
                       50),
            device_ms=device_ms(lambda: flash_attention(
                q16, k16, v16, causal=causal), 50),
            library_ms=time_ms(lambda: sdpa(q16, k16, v16, is_causal=causal,
                                            enable_gqa=True), 50),
            library_device_ms=device_ms(lambda: sdpa(
                q16, k16, v16, is_causal=causal, enable_gqa=True), 50),
            bound_ms=bound, bound_by=by,
            plain_ms=time_ms(lambda: ref.flash_attention_ref(
                q16, k16, v16, causal=causal), 5),
            ms_fp32=time_ms(lambda: flash_attention(q, k, v, causal=causal),
                            10),
            device_ms_fp32=device_ms(lambda: flash_attention(
                q, k, v, causal=causal), 10),
            library_ms_fp32=time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                                 enable_gqa=True), 10),
            library_device_ms_fp32=device_ms(lambda: sdpa(
                q, k, v, is_causal=causal, enable_gqa=True), 10),
            bound_ms_fp32=bound32, bound_by_fp32=by32)
    return out


def measure_lm_kernels() -> dict:
    """Each LM kernel at its main-path shape: the kernel, its plain
    version, one PyTorch library call for the same function (timed only;
    the port never calls it) and the card's bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitplane_gemm import bitplane_matmul, int8_matmul
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, h, hk, s, d = LM_BATCH, Q_HEADS, KV_HEADS, LM_SEQ, HEAD_DIM
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, hk, s, d, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound, by = flash_bound(b, h, hk, s, s, d, 2)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    q128, k128, v128 = (torch.randn(b, n, s, 128, generator=gen,
                                    device="cuda").bfloat16()
                        for n in (h, hk, hk))
    rows = {"flash_attention": dict(
        ms=time_ms(lambda: flash_attention(q, k, v), 50),
        device_ms=device_ms(lambda: flash_attention(q, k, v), 50),
        ms_fp32=time_ms(lambda: flash_attention(q32, k32, v32), 10),
        device_ms_fp32=device_ms(lambda: flash_attention(q32, k32, v32), 10),
        bound_ms_fp32=flash_bound(b, h, hk, s, s, d, 4,
                                  peak=FP32_WORK_FLOPS)[0],
        library_ms_fp32=time_ms(lambda: sdpa(q32, k32, v32, is_causal=True,
                                             enable_gqa=True), 10),
        ms_d128=time_ms(lambda: flash_attention(q128, k128, v128), 50),
        bound_ms_d128=flash_bound(b, h, hk, s, s, 128, 2)[0],
        library_ms_d128=time_ms(lambda: sdpa(q128, k128, v128,
                                             is_causal=True,
                                             enable_gqa=True), 50),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v), 5),
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                        enable_gqa=True), 50),
        library="torch.nn.functional.scaled_dot_product_attention "
                "(is_causal, enable_gqa)",
        bound_ms=bound, bound_by=by,
        cases=measure_family_shapes(gen),
        timed_at=f"bf16 q ({b}, {h}, {s}, {d}), k/v ({b}, {hk}, {s}, {d}), "
                 "causal (ms, device_ms); the same in float32 (ms_fp32, "
                 "3xTF32; its bound at FP32_WORK_FLOPS) and in bf16 at "
                 "D = 128 (ms_d128); cases: the vlm and encdec "
                 "FAMILY_SHAPES")}
    m, kk, n = MLP_SHAPE
    x, w = randint8((m, kk), gen), randint8((kk, n), gen)
    try:                      # the library call only where it takes the shape
        torch._int_mm(x, w)
        int_mm_ms = time_ms(lambda: torch._int_mm(x, w), 50)
    except RuntimeError:
        int_mm_ms = None
    shape = f"int8 x ({m}, {kk}) @ w ({kk}, {n}) -> int32"
    bound, by = gemm_bound(m, kk, n)
    rows["int8_matmul"] = dict(
        ms=time_ms(lambda: int8_matmul(x, w), 20),
        plain_ms=time_ms(lambda: ref.int8_matmul_ref(x, w), 5),
        library_ms=int_mm_ms, library="torch._int_mm", bound_ms=bound,
        bound_by=by, timed_at=shape)
    rows["bitplane_matmul"] = dict(
        ms=time_ms(lambda: bitplane_matmul(x, w), 20),
        plain_ms=time_ms(lambda: ref.bitplane_matmul_ref(x, w), 3),
        library_ms=int_mm_ms, library="torch._int_mm (the 8-plane product)",
        bound_ms=bound, bound_by=by,
        ms_nbits4=time_ms(lambda: bitplane_matmul(x, w, 4), 20),
        timed_at=shape + ", 8 planes (ms) / 4 planes (ms_nbits4); the "
                 "bound is the one product either computes")
    return rows


def measure_flash_bwd() -> dict:
    """The backward kernels at each of ``TRAIN_SHAPES``: bf16 (``ms``,
    ``device_ms``) and fp32, each beside its bound, the plain version (bf16)
    and the backward of ``scaled_dot_product_attention`` with
    ``enable_gqa`` on the same inputs (timed only; the port never calls
    it).  The row's own numbers are whisper-base's encoder, the largest
    call of the training path that runs the kernels.  Where q heads share
    a kv head, both types are also timed with ``gqa_split`` forced each
    way (``device_ms_in_block``, ``device_ms_split``, ``device_ms_fp32_*``):
    the evidence for the wrapper's rule."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    flash_attention_bwd = fa.flash_attention_bwd
    gen = torch.Generator(device="cuda").manual_seed(9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = {}
    for name, shape in TRAIN_SHAPES.items():
        b, h, hk, sq, sk, d, causal = shape
        q, k, v, o, lse, do = bwd_inputs(shape, torch.bfloat16, gen)
        q32, k32, v32, o32, lse32, do32 = bwd_inputs(shape, torch.float32,
                                                     gen)
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        so = sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True)
        q32s, k32s, v32s = (x.detach().requires_grad_()
                            for x in (q32, k32, v32))
        so32 = sdpa(q32s, k32s, v32s, is_causal=causal, enable_gqa=True)
        bound, by = flash_bwd_bound(*shape[:6], 2, causal)
        bound32, by32 = flash_bwd_bound(*shape[:6], 4, causal,
                                        peak=FP32_WORK_FLOPS)
        cases[name] = dict(
            shape=f"q ({b}, {h}, {sq}, {d}), k/v ({b}, {hk}, {sk}, {d})",
            causal=causal, gqa_split=fa.gqa_split(
                b, hk, sk, h // hk,
                torch.cuda.get_device_properties(0).multi_processor_count),
            ms=time_ms(lambda: flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal), 10),
            device_ms=device_ms(lambda: flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal), 10),
            bound_ms=bound, bound_by=by,
            plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=causal), 3),
            # the device's time: back to back, the host's autograd call
            # (about 0.5 ms) is longer than the device's work
            library_ms=device_ms(lambda: torch.autograd.grad(
                so, (qs, ks, vs), do, retain_graph=True), 10),
            library_ms_back_to_back=time_ms(lambda: torch.autograd.grad(
                so, (qs, ks, vs), do, retain_graph=True), 10),
            ms_fp32=time_ms(lambda: flash_attention_bwd(
                q32, k32, v32, o32, lse32, do32, causal=causal), 3),
            device_ms_fp32=device_ms(lambda: flash_attention_bwd(
                q32, k32, v32, o32, lse32, do32, causal=causal), 5),
            library_ms_fp32=device_ms(lambda: torch.autograd.grad(
                so32, (q32s, k32s, v32s), do32, retain_graph=True), 5),
            bound_ms_fp32=bound32, bound_by_fp32=by32)
        ways = () if h == hk else (("in_block", False), ("split", True))
        for way, split in ways:
            with mock.patch.object(fa, "gqa_split",
                                   lambda *a, split=split: split):
                cases[name][f"device_ms_{way}"] = device_ms(
                    lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                causal=causal), 10)
                cases[name][f"device_ms_fp32_{way}"] = device_ms(
                    lambda: flash_attention_bwd(q32, k32, v32, o32, lse32,
                                                do32, causal=causal), 5)
        del qs, ks, vs, so, q32s, k32s, v32s, so32
    row = {key: cases["whisper_encoder"][key] for key in (
        "ms", "device_ms", "bound_ms", "bound_by", "plain_ms", "library_ms")}
    row.update(library="the backward of torch.nn.functional.scaled_dot_"
                       "product_attention (enable_gqa)", cases=cases,
               timed_at="bf16 whisper_encoder (ms); cases: TRAIN_SHAPES in "
                        "bf16 and fp32 (ms_fp32, device_ms_fp32: 3xTF32; "
                        "its bound at FP32_WORK_FLOPS; library_ms_fp32: "
                        "SDPA's fp32 backward)")
    return {"flash_attention_bwd": row}


def measure_flash_segments() -> dict:
    """The segmented kernels at ``SEG_SHAPE`` in bf16, each beside its
    bound over the visible pairs (``segmented_bound``), the plain chunked
    route that packed calls took before (``plain_chunked_attention``:
    the forward, and for the backward the forward and backward less the
    forward; it recomputes each chunk in the backward, as in training) and
    ``scaled_dot_product_attention`` with the boolean document mask on K/V
    repeated to the q heads beforehand (the same function; timed only, the
    port never calls it).  The pre-pass alone as its own row."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models.attention import plain_chunked_attention

    b, h, hk, s, d = SEG_SHAPE
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(17)
    ids = packed_ids(b, s, seed=11)
    q, do = (torch.randn(b, h, s, d, generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn(b, hk, s, d, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    tiles = fa._segment_tiles(ids, ids, True)
    o, lse = fa._forward(q, k, v, True, scale, True, ids, ids, tiles)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    mask = (ids[:, None, :, None] == ids[:, None, None, :]) & causal
    qs, ks, vs = (x.detach().requires_grad_() for x in (
        q, k.repeat_interleave(h // hk, 1), v.repeat_interleave(h // hk, 1)))
    so = sdpa(qs, ks, vs, attn_mask=mask)
    qm, km, vm = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dom = do.transpose(1, 2)

    def plain_fwd():
        with torch.no_grad():
            plain_chunked_attention(qm, km, vm, True, ids)

    def plain_fwd_bwd():
        torch.autograd.grad(plain_chunked_attention(qm, km, vm, True, ids),
                            (qm, km, vm), dom)

    plain_ms, plain_both_ms = time_ms(plain_fwd, 3), time_ms(plain_fwd_bwd, 3)
    shape = (f"bf16 q ({b}, {h}, {s}, {d}), k/v ({b}, {hk}, {s}, {d}), "
             f"causal, ids of {int((ids.diff(dim=1) != 0).sum()) + b} runs "
             "(packed Poisson-512 documents and pads)")
    library = ("torch.nn.functional.scaled_dot_product_attention (attn_mask:"
               " the boolean document mask, K/V repeated to the q heads "
               "before the timing)")
    bound, by, pairs = segmented_bound(ids, h, hk, d, 2, 4)
    rows = {"flash_attention_segmented": dict(
        ms=time_ms(lambda: fa.flash_attention(q, k, v, segment_ids=ids), 20),
        device_ms=device_ms(
            lambda: fa.flash_attention(q, k, v, segment_ids=ids), 20),
        device_ms_no_pre_pass=device_ms(lambda: fa._forward(
            q, k, v, True, scale, False, ids, ids, tiles), 20),
        bound_ms=bound, bound_by=by, visible_pairs=pairs,
        causal_pairs=b * s * (s + 1) // 2,
        plain_ms=plain_ms, plain="models.attention.plain_chunked_attention "
                                 "(no grad)",
        library_ms=device_ms(lambda: sdpa(q, ks, vs, attn_mask=mask), 10),
        library=library, timed_at=shape + "; ms, device_ms: the pre-pass "
                                          "and the forward")}
    bound, by, _ = segmented_bound(ids, h, hk, d, 2, 10)
    rows["flash_attention_bwd_segmented"] = dict(
        ms=time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, segment_ids=ids, tiles=tiles), 10),
        device_ms=device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, segment_ids=ids, tiles=tiles), 10),
        bound_ms=bound, bound_by=by,
        plain_ms=plain_both_ms - plain_ms, plain_ms_fwd_bwd=plain_both_ms,
        plain="models.attention.plain_chunked_attention: its forward and "
              "backward less its forward",
        library_ms=device_ms(lambda: torch.autograd.grad(
            so, (qs, ks, vs), do, retain_graph=True), 10),
        library="the backward of " + library,
        timed_at=shape + "; the forward's tiles given, as in training")
    nq = -(-s // fa.SEG_TILE)
    rows["flash_seg_tiles"] = dict(
        ms=time_ms(lambda: fa._segment_tiles(ids, ids, True), 50),
        device_ms=device_ms(lambda: fa._segment_tiles(ids, ids, True), 50),
        bound_ms=(2 * 4 * b * s + 4 * 8 * b * 2 * nq) / HBM_BYTES_PER_S
        * 1e3, bound_by="bytes",
        plain_ms=time_ms(lambda: ref.flash_segment_tiles_ref(ids, ids, True),
                         5),
        plain="kernels.ref.flash_segment_tiles_ref on the card",
        library_ms=None, library="none computes these records",
        timed_at=f"ids ({b}, {s}) of the packed rows, both sides, causal")
    del qs, ks, vs, so, qm, km, vm
    return rows


def measure_ssd_chunk() -> dict:
    """The SSD kernels at ``SSD_SHAPE`` with the packed rows' runs, each
    beside its bound (``ssd_counts`` at ``FP32_WORK_FLOPS`` or at
    ``HBM_BYTES_PER_S``, whichever is longer) and the einsum route's same
    term (``models.ssm._diag_einsum``: its forward without grad; for the
    backward its forward and backward less its forward).  Rows
    ``ssd_chunk_fwd`` and ``ssd_chunk_bwd``."""
    from repro_torch.kernels import ssd_chunk as sk
    from repro_torch.models import ssm

    cc, bc, xf, da_cum, rc = ssd_inputs(SSD_SHAPE, 23, True)
    dy = torch.randn_like(xf)
    da = torch.cat([da_cum[:, :, :1], da_cum.diff(dim=2)], dim=2)
    leaves = [t.detach().requires_grad_() for t in (da, cc, bc, xf)]

    def plain_fwd():
        with torch.no_grad():
            ssm._diag_einsum(*leaves, rc)

    def plain_fwd_bwd():
        torch.autograd.grad(ssm._diag_einsum(*leaves, rc), leaves, dy)

    plain_ms, plain_both_ms = time_ms(plain_fwd, 3), time_ms(plain_fwd_bwd, 3)
    counts = ssd_counts(SSD_SHAPE)
    b, s, cs, g, hg, p, n = SSD_SHAPE
    shape = (f"fp32, B {b}, S {s}, chunk {cs}, {g} groups of {hg} heads of "
             f"{p}, state {n}, runs of the packed rows "
             f"({int((rc.flatten(1).diff(dim=1) != 0).sum()) + b} runs)")
    rows = {}
    for name, fn, flops, nbytes, plain, note in (
            ("ssd_chunk_fwd",
             lambda: sk.ssd_chunk_fwd(cc, bc, xf, da_cum, rc),
             counts["fwd_flops"], counts["fwd_bytes"], plain_ms,
             "models.ssm._diag_einsum (no grad)"),
            ("ssd_chunk_bwd",
             lambda: sk.ssd_chunk_bwd(cc, bc, xf, da_cum, dy, rc),
             counts["bwd_flops"], counts["bwd_bytes"],
             plain_both_ms - plain_ms,
             "models.ssm._diag_einsum: its forward and backward less its "
             "forward")):
        bound, by = _bound(flops, nbytes, FP32_WORK_FLOPS)
        rows[name] = dict(
            ms=time_ms(fn, 10), device_ms=device_ms(fn, 10),
            bound_ms=bound, bound_by=by,
            flops=flops, bytes=nbytes, plain_ms=plain, plain=note,
            library_ms=None, library="none computes this term",
            timed_at=shape + ("; backward: both kernels, dC = dS B, "
                              "dB = dS^T C and dA's sum"
                              if name == "ssd_chunk_bwd" else ""))
    rows["ssd_chunk_bwd"]["plain_ms_fwd_bwd"] = plain_both_ms
    return rows


def measure_flash_route() -> dict:
    """What the flash route costs a caller, host time included: the bf16
    forward at ``FLASH_ROUTE_SHAPES`` called back to back (``time_ms``;
    at one query row the host's work a call sets the pace) beside its
    device time, and the host's µs a call of ``flash_attention`` beside
    those of the bare launch ``_forward`` (the difference: what the route
    adds to the launch on the host); whisper-base as published, bf16
    weights from a seed: one
    decode step (4 rows, cache of 384 text tokens and 1500 frames) and one
    training step (4 x 384 text tokens over 4 x 1500 frames, AdamW), each
    ``wall_ms``."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_train_batches
    from repro_torch.kernels.flash_attention import _forward, flash_attention
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, adamw_init

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for name, (b, h, hk, sq, sk, d) in FLASH_ROUTE_SHAPES.items():
        q = torch.randn(b, h, sq, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, hk, sk, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        call = (lambda: flash_attention(q, k, v, causal=True))
        out[f"flash_attention {name} bf16"] = time_ms(call, 200)
        out[f"flash_attention {name} bf16 device"] = device_ms(call, 200)
        out[f"flash_attention {name} bf16 host_us"] = host_us(call, 100)
        out[f"_forward {name} bf16 host_us"] = host_us(
            lambda: _forward(q, k, v, True, d ** -0.5, False), 100)
    cfg = get_config("whisper-base")
    model = LM(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    frames = torch.randn(STEP_BATCH, cfg.num_frames, cfg.d_model,
                         generator=gen, device="cuda").bfloat16()
    batch = next(make_train_batches(DataConfig(cfg.vocab_size, WHISPER_TEXT,
                                               STEP_BATCH, seed=0)))
    batch = {**{k: torch.from_numpy(x).cuda() for k, x in batch.items()
                if k != "next_doc"}, "frames": frames}
    with torch.no_grad():
        logits, cache = make_prefill_step(model)(params, {
            "tokens": batch["tokens"], "positions": batch["positions"],
            "frames": frames})
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        decode = make_decode_step(model)
        out["whisper-base decode step"] = wall_ms(
            lambda: decode(params, cache, tok, WHISPER_TEXT - 1), 50)
    train = make_train_step(model, AdamWConfig())
    state = adamw_init(params)
    out["whisper-base train step"] = wall_ms(
        lambda: train(params, state, batch), 20)
    return {"flash_route": out}


def measure() -> dict:
    """Every row, ``{row: {field: value}}``, from the ``repro_torch`` first
    on ``sys.path``."""
    return {**measure_mve(), **measure_float_ops(), **measure_lm_kernels(),
            **measure_flash_bwd(), **measure_flash_segments(),
            **measure_ssd_chunk(), **measure_flash_route()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", nargs="+", default=["src"],
                    help="the trees' src directories, in the order to run")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.one:
        sys.path.insert(0, str(Path(args.src[0]).resolve()))
        print(json.dumps(measure()), flush=True)
        return
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    rows = [{"card": card, "torch": torch.__version__}]
    print(json.dumps(rows[0]), flush=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for src in args.src:
        proc = subprocess.run(
            [sys.executable, "-m", "benchmarks.torch_kernel_ab", "--one",
             "--src", src], check=True, capture_output=True, text=True,
            env=env, cwd=Path(__file__).resolve().parents[1], timeout=1800)
        for name, row in json.loads(proc.stdout.splitlines()[-1]).items():
            rows.append({"src": src, "row": name, **row})
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
