"""Plain PyTorch versions of the hand-written kernels in this package.

These are the semantics.  The CUDA kernels must match them bit for bit
where the reference promises bits (the gather and scatter move elements;
the integer products are exact) and to the reference's tolerance where it
promises one (attention).  The kernel wrappers
(:mod:`~repro_torch.kernels.mdgather`, :mod:`~repro_torch.kernels.mdscatter`,
:mod:`~repro_torch.kernels.bitplane_gemm`,
:mod:`~repro_torch.kernels.flash_attention`,
:mod:`~repro_torch.kernels.float_ops`,
:mod:`~repro_torch.kernels.ssd_chunk`) take these versions for CPU
tensors, and the on-card smoke run holds each kernel against them on the
same inputs.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


# ---------------------------------------------------------------------------
# Multi-dimensional strided gather/scatter (the MVE vsld/vsst data path).
# ---------------------------------------------------------------------------

def mdv_lane_addresses(dims: Sequence[int], strides: Sequence[int],
                       base: int, lanes: int,
                       device=None) -> torch.Tensor:
    """Per-lane flat element addresses per Algorithm 1 (x fastest), int64."""
    lane = torch.arange(lanes, dtype=torch.int64, device=device)
    addr = torch.full((lanes,), int(base), dtype=torch.int64, device=device)
    rem = lane
    for length, stride in zip(dims, strides):
        idx = rem % int(length)
        rem = rem // int(length)
        addr = addr + idx * int(stride)
    return addr


def wrap_store_addresses(addr, n: int):
    """Store addresses as the reference's scatters take them: ``a`` in
    ``[-n, 0)`` becomes ``a + n``; every other address is left as it is
    (those outside ``[0, n)`` are then dropped by the store).  Works on a
    tensor or a NumPy array."""
    return addr + (addr < 0) * n


def mdgather_ref(src: torch.Tensor, dims: Sequence[int],
                 strides: Sequence[int], base: int = 0,
                 lanes: Optional[int] = None) -> torch.Tensor:
    """Gather ``lanes`` (default ``prod(dims)``) lanes from flat ``src``.

    ``src`` is ``(N,)`` or a batch of images ``(B, N)``; the result is
    ``(lanes,)`` / ``(B, lanes)``.  Addresses are clamped into the image
    and lanes at or past ``prod(dims)`` read nothing and yield 0.
    """
    total = math.prod(int(d) for d in dims)
    lanes = total if lanes is None else int(lanes)
    addr = mdv_lane_addresses(dims, strides, base, lanes, src.device)
    out = src[..., addr.clamp(0, src.shape[-1] - 1)]
    if lanes > total:
        out[..., total:] = 0
    return out


def mdscatter_ref(dst: torch.Tensor, values: torch.Tensor,
                  dims: Sequence[int], strides: Sequence[int],
                  base: int = 0,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter lane values into a copy of flat ``dst`` (``(N,)`` or
    ``(B, N)``); returns the updated copy.

    Lane ``l`` is active when ``l < prod(dims)`` and ``mask[l]`` (when a
    per-lane mask is given).  An address ``a`` in ``[-N, 0)`` lands on
    ``a + N`` (the reference's scatters index Python-style); anything
    else outside ``[0, N)`` writes nowhere, as do inactive lanes.  On
    equal addresses (after that wrap) the highest active lane wins.  The
    same two steps as the kernel: resolve one owner lane per address,
    then let only owners store — so the result never depends on the order
    a parallel scatter applies duplicates in.
    """
    n = dst.shape[-1]
    lanes = values.shape[-1]
    total = math.prod(int(d) for d in dims)
    addr = wrap_store_addresses(
        mdv_lane_addresses(dims, strides, base, lanes, dst.device), n)
    lane = torch.arange(lanes, dtype=torch.int32, device=dst.device)
    active = (lane < total) & (addr >= 0) & (addr < n)
    if mask is not None:
        active = active & mask.to(torch.bool)
    owner = torch.full((n,), -1, dtype=torch.int32, device=dst.device)
    owner.scatter_reduce_(0, torch.where(active, addr, 0),
                          torch.where(active, lane, -1), "amax")
    picked = values[..., owner.clamp(min=0).long()]
    return torch.where(owner >= 0, picked, dst)


# ---------------------------------------------------------------------------
# Bit-plane (bit-serial adapted) quantized matmul.
# ---------------------------------------------------------------------------

def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 ``(M, K)`` x int8 ``(K, N)`` -> int32, exact.

    Computed in float64, which has no integer matmul problem on either
    device (CUDA has no int32 matmul): every partial sum is at most
    ``128 * 128 * K``, far below 2**53, so each is exact in any order.  The
    sum is wrapped to int32 through int64, as the reference's int32
    arithmetic wraps."""
    prod = x.to(torch.float64) @ w.to(torch.float64)
    return prod.to(torch.int64).to(torch.int32)


def bitplane_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                        nbits: int = 8) -> torch.Tensor:
    """The same product plane by plane (two's complement): ``wu = w & 0xFF``,
    ``acc += sign_b * ((x @ ((wu >> b) & 1)) << b)`` for ``b < nbits``, the
    top plane negative.  Exact: each plane product in float64 as in
    :func:`int8_matmul_ref`, the shifted sum in int64, wrapped to int32 as
    the reference's int32 arithmetic wraps."""
    xf = x.to(torch.float64)
    wu = w.to(torch.int32) & 0xFF
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.int64,
                      device=x.device)
    for b in range(nbits):
        plane = ((wu >> b) & 1).to(torch.float64)
        partial = (xf @ plane).to(torch.int64)
        acc += (partial << b) * (-1 if b == nbits - 1 else 1)
    return acc.to(torch.int32)


def quantize_rowwise_ref(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: ``(q int8, scale float32)``,
    ``scale = max|x| / 127`` per row (1 where a row is all zeros)."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


# ---------------------------------------------------------------------------
# Flash attention: forward, its log-sum-exp, backward.
# ---------------------------------------------------------------------------

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None,
                        segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Naive attention: ``(B, H, Sq, D)`` over ``(B, Hkv, Sk, D)`` keys and
    values (``H`` a multiple of ``Hkv``; kv head ``h // (H / Hkv)`` serves
    q head ``h``, as ``jnp.repeat`` of the kv heads would) -> ``(B, H, Sq,
    D)`` in q's type.  fp32 softmax; the causal diagonal sits at
    ``Sk - Sq``.  With ``segment_ids`` (int, ``(B, Sq)``) a query sees only
    the keys whose id (``kv_segment_ids``, ``(B, Sk)``, default
    ``segment_ids``) equals its own, and causal where asked: the model's
    plain route's rule, so pads (id 0) see only pads.  A row that sees no
    key (causal, ``Sq > Sk``; or no key of its id) comes out NaN, as in
    the reference's oracle; the kernel gives 0 there."""
    return flash_attention_lse_ref(q, k, v, causal=causal, scale=scale,
                                   segment_ids=segment_ids,
                                   kv_segment_ids=kv_segment_ids)[0]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or float64 if it is already (the gradient checks
    run in float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _attention_logits(q, k, causal, scale, segment_ids=None,
                      kv_segment_ids=None):
    """Scaled logits ``(B, H, Sq, Sk)`` of q over the kv heads repeated to
    H, with ``-inf`` where causality or the segment ids hide a key; and
    the visibility mask (``(Sq, Sk)``, or ``(B, 1, Sq, Sk)`` with ids)."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    group = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(group, dim=1) if group > 1 else k
    logits = torch.einsum("...qd,...kd->...qk", _wide(q), _wide(kr)) * scale
    visible = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        visible = visible.tril(sk - sq)
    if segment_ids is not None:
        kv = segment_ids if kv_segment_ids is None else kv_segment_ids
        visible = visible & (segment_ids[:, None, :, None]
                             == kv[:, None, None, :])
    return torch.where(visible, logits, float("-inf")), visible


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            scale: Optional[float] = None,
                            segment_ids: Optional[torch.Tensor] = None,
                            kv_segment_ids: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref` and the log-sum-exp of each row's scaled
    logits, ``lse`` ``(B, H, Sq)`` (fp32; float64 for float64 inputs):
    what the forward kernel hands its backward.  ``lse`` is ``-inf`` on a
    row that sees no key."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits, _ = _attention_logits(q, k, causal, scale, segment_ids,
                                  kv_segment_ids)
    group = q.shape[1] // k.shape[1]
    vr = v.repeat_interleave(group, dim=1) if group > 1 else v
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("...qk,...kd->...qd", probs, _wide(vr))
    return out.to(q.dtype), torch.logsumexp(logits, dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True,
                            scale: Optional[float] = None,
                            segment_ids: Optional[torch.Tensor] = None,
                            kv_segment_ids: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_ref` for
    the output gradient ``do``, from the forward's output ``o`` and its
    ``lse``, step by step as the backward kernels compute them
    (flash-attention-2's recompute backward)::

        P  = exp(S * scale - lse)          S = Q K^T, masked entries 0
        dV = P^T dO
        dP = dO V^T
        D  = rowsum(dO * O)
        dS = P * (dP - D)
        dQ = dS K * scale,   dK = dS^T Q * scale

    in fp32 (float64 for float64 inputs), each result in its input's type;
    the mask is the forward's (causal, segment ids).  Under GQA (``H = G *
    Hkv``) each kv head's dK and dV sum over its G q heads.  A row that
    sees no key (``lse = -inf``) has no gradient: it adds nothing to dK and
    dV, and its dQ is 0."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits, visible = _attention_logits(q, k, causal, scale, segment_ids,
                                        kv_segment_ids)
    visible = visible & torch.isfinite(lse)[..., None]
    p = torch.where(visible, torch.exp(logits - lse[..., None]), 0.0)
    dof = _wide(do)
    kr = k.repeat_interleave(group, dim=1) if group > 1 else k
    vr = v.repeat_interleave(group, dim=1) if group > 1 else v
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, _wide(vr))
    delta = (dof * _wide(o)).sum(dim=-1)
    ds = torch.where(visible, p * (dp - delta[..., None]), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _wide(kr)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _wide(q)) * scale
    dk = dk.reshape(b, hk, group, sk, d).sum(dim=2)
    dv = dv.reshape(b, hk, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: Rows of a tile of the segment pre-pass: the q tiles of the forward and
#: dQ kernels and the K tiles of the dK/dV kernels.
SEG_TILE = 64
#: Distinct ids the pre-pass keeps of a tile; a tile with more is taken as
#: the interval of its ids.
SEG_SLOTS = 3


def _tile_ids(ids: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Of each ``SEG_TILE``-row tile of ``ids`` ``(B, S)``: the least and
    the largest id, up to ``SEG_SLOTS`` distinct ids (sorted, the least
    repeated in unused slots) and their count (``SEG_SLOTS + 1``, the
    slots all the least, where there are more), each ``(B, n)`` (the
    slots ``(B, n, SEG_SLOTS)``)."""
    b, s = ids.shape
    ids = ids.to(torch.int64)
    pad = -s % SEG_TILE          # the last tile repeats its last id
    ids = torch.cat((ids, ids[:, -1:].expand(b, pad)), 1)
    srt = ids.view(b, -1, SEG_TILE).sort(-1).values
    new = torch.ones_like(srt, dtype=torch.bool)
    new[..., 1:] = srt[..., 1:] != srt[..., :-1]
    count = new.sum(-1)
    rank = new.cumsum(-1) - 1
    slots = torch.stack([
        torch.where(count > r, srt.gather(-1, (new & (rank == r)).int()
                                          .argmax(-1, keepdim=True))[..., 0],
                    srt[..., 0]) for r in range(SEG_SLOTS)], -1)
    slots = torch.where((count > SEG_SLOTS)[..., None], srt[..., :1], slots)
    return (srt[..., 0], srt[..., -1], slots,
            count.clamp(max=SEG_SLOTS + 1))


def _first_last(meet: torch.Tensor, rows: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` of the other side from the first to the last tile
    that ``meet`` (``(..., n)`` bool) marks, ``[0, 0)`` where none."""
    n = meet.shape[-1]
    any_ = meet.any(-1)
    first = meet.int().argmax(-1)
    last = n - 1 - meet.flip(-1).int().argmax(-1)
    lo = torch.where(any_, first * SEG_TILE, 0)
    hi = torch.where(any_, ((last + 1) * SEG_TILE).clamp(max=rows), 0)
    return torch.stack((lo, hi), dim=-1)


def flash_segment_tiles_ref(segment_ids: torch.Tensor,
                            kv_segment_ids: torch.Tensor,
                            causal: bool) -> torch.Tensor:
    """What the flash kernels' segment pre-pass computes from the ids:
    ``(B, nq + nk, 8)`` int32, one row for each ``SEG_TILE``-row q tile
    (``nq = ceil(Sq / 64)``), then one for each K tile (``nk``), of

        [least id, largest id, lo, hi, id, id, id, count]

    where rows ``lo .. hi - 1`` of the other side (keys for a q tile, q
    rows for a K tile) hold every pair of the two tiles that may be
    visible, and the last four are the tile's distinct ids (up to
    ``SEG_SLOTS``, sorted, the least in unused slots; ``count`` is
    ``SEG_SLOTS + 1``, and the slots all the least, where there are more:
    ``csrc/flash_segments.cuh``).
    A q tile and a K tile may share a segment where both hold at most
    ``SEG_SLOTS`` ids and two of them are equal, or else where their id
    intervals meet; under causal, only where the K tile starts at or
    before the q tile's last row's diagonal.  ``lo`` starts the first such
    tile of the other side, ``hi`` ends the last (``0, 0`` where none).
    Any ids are covered, in any order: the range over-approximates the
    pairs.  On contiguous runs (packed documents, pads of id 0 at the end)
    it is the span of the tile's own documents."""
    sq, sk = segment_ids.shape[1], kv_segment_ids.shape[1]
    qlo, qhi, qset, qn = _tile_ids(segment_ids)
    klo, khi, kset, kn = _tile_ids(kv_segment_ids)
    interval = ((qlo[:, :, None] <= khi[:, None, :])
                & (klo[:, None, :] <= qhi[:, :, None]))
    shared = (qset[:, :, None, :, None]
              == kset[:, None, :, None, :]).any(-1).any(-1)
    exact = ((qn[:, :, None] <= SEG_SLOTS) & (kn[:, None, :] <= SEG_SLOTS))
    meet = torch.where(exact, shared, interval)
    if causal:
        last = (torch.arange(qlo.shape[1], device=meet.device) * SEG_TILE
                + SEG_TILE - 1).clamp(max=sq - 1) + (sk - sq)
        start = torch.arange(klo.shape[1], device=meet.device) * SEG_TILE
        meet = meet & (start[None, :] <= last[:, None])[None]
    rows = []
    for lo, hi, ids, n, m, other in ((qlo, qhi, qset, qn, meet, sk),
                                     (klo, khi, kset, kn,
                                      meet.transpose(1, 2), sq)):
        rows.append(torch.cat((torch.stack((lo, hi), -1),
                               _first_last(m, other), ids,
                               n[..., None]), -1))
    return torch.cat(rows, 1).to(torch.int32)


# ---------------------------------------------------------------------------
# Float arithmetic and conversions with x86's NaN bits (the MVE float path).
# ---------------------------------------------------------------------------

#: The float types of MVE registers, with their bit views and NaN constants:
#: (bit view, quiet bit, exponent mask, mantissa mask, default NaN).
_FLOAT_BITS = {
    torch.float32: (torch.int32, 0x00400000, 0x7F800000, 0x007FFFFF,
                    -0x00400000),                     # 0xFFC00000
    torch.float16: (torch.int16, 0x0200, 0x7C00, 0x03FF, -0x0200),  # 0xFE00
}
FLOAT_BINARY_OPS = ("add", "sub", "mul")
FLT_MIN = 1.1754943508222875e-38        # the least normal float32, 2**-126


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with every denormal replaced by a zero of its sign,
    as XLA's CPU runtime treats float32 operands and results (the x86
    DAZ and FTZ modes).  Other types pass through."""
    if x.dtype != torch.float32:
        return x
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def _is_nan_bits(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    view, _, expo, mant, _ = _FLOAT_BITS[dtype]
    b = x.view(view)
    return ((b & expo) == expo) & ((b & mant) != 0)


def float_binary_ref(op: str, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """``a + b``, ``a - b`` or ``a * b`` (``op`` = ``"add"``, ``"sub"``,
    ``"mul"``) of two float32 or two float16 tensors, as the reference
    computes it on an x86 host.

    One rounding point: float16 operands are widened to float32 (exact),
    combined there and rounded once to float16.  A NaN result carries
    x86's bits, written out here on bit views rather than left to the
    host's arithmetic: ``a`` quieted when ``a`` is a NaN, else ``b``
    quieted when ``b`` is, else the default NaN ``0xFFC00000`` (float16:
    ``0xFE00``).  A NaN operand keeps its sign (``1 - NaN`` is that NaN,
    not its negation)."""
    if op not in FLOAT_BINARY_OPS:
        raise ValueError(f"op {op!r}: expected one of {FLOAT_BINARY_OPS}")
    if a.dtype != b.dtype or a.dtype not in _FLOAT_BITS:
        raise TypeError(f"operands {a.dtype}, {b.dtype}: need two float32 "
                        "or two float16 tensors")
    dtype = a.dtype
    view, quiet, _, _, default = _FLOAT_BITS[dtype]
    a32 = flush_denormals(a.to(torch.float32))
    b32 = flush_denormals(b.to(torch.float32))
    r = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}[op](a32, b32)
    if op == "mul":
        # x86 calls a result tiny after rounding it to 24 bits with an
        # unbounded exponent: the float64 product is exact, and scaled by
        # 2**64 it rounds to float32 far from the denormal range.
        scaled = (a32.double() * b32.double() * 2.0**64).to(torch.float32)
        tiny = scaled.abs() < FLT_MIN * 2.0**64
    else:
        tiny = r.abs() < FLT_MIN        # a tiny sum or difference is exact
    r = torch.where(tiny, r * 0.0, r)
    out = r.to(dtype).view(view)
    nan_a, nan_b = _is_nan_bits(a, dtype), _is_nan_bits(b, dtype)
    nan_bits = torch.where(nan_a, a.view(view) | quiet,
                           torch.where(nan_b, b.view(view) | quiet,
                                       torch.full_like(out, default)))
    return torch.where(torch.isnan(r), nan_bits, out).view(dtype)


def float_convert_ref(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 -> float16 or float16 -> float32 as x86's F16C converts:
    finite values and infinities round to nearest even; a NaN keeps its
    sign and the top of its payload and comes out quiet —
    ``sign | 0x7E00 | mant >> 13`` narrowing, ``sign | 0x7FC00000 | mant
    << 13`` widening — where CUDA would give its canonical NaN."""
    pair = (x.dtype, dtype)
    if pair not in ((torch.float32, torch.float16),
                    (torch.float16, torch.float32)):
        raise TypeError(f"{x.dtype} -> {dtype}: float_convert takes "
                        "float32 <-> float16")
    nan = _is_nan_bits(x, x.dtype)
    wide = x.view(_FLOAT_BITS[x.dtype][0]).to(torch.int64) \
        & ((1 << 8 * x.element_size()) - 1)            # unsigned bits
    if dtype == torch.float16:
        nan_bits = ((wide >> 16) & 0x8000) | 0x7E00 | ((wide & 0x7FFFFF) >> 13)
    else:
        nan_bits = ((wide & 0x8000) << 16) | 0x7FC00000 | ((wide & 0x3FF) << 13)
    view = _FLOAT_BITS[dtype][0]
    width = 16 if dtype == torch.float16 else 32
    # unsigned pattern -> the signed view's value (two's complement)
    nan_bits = (nan_bits - ((nan_bits >> (width - 1)) << width)).to(view)
    return torch.where(nan, nan_bits, x.to(dtype).view(view)).view(dtype)


# ---------------------------------------------------------------------------
# The SSD's intra-chunk term (csrc/ssd_chunk.cu).
# ---------------------------------------------------------------------------

def _ssd_decay(da_cum: torch.Tensor, runs: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """``(B, C, L, G, H)`` cumulative log decay -> ``(B, C, G, H, L, L)``
    decay blocks ``L_h[l, s] = exp(A[l] - A[s])`` for ``s <= l`` in one
    run of ``runs`` ``(B, C, L)`` (every pair without runs), else 0."""
    cs = da_cum.shape[2]
    a = da_cum.permute(0, 1, 3, 4, 2)
    diff = a[..., :, None] - a[..., None, :]
    mask = torch.ones(cs, cs, dtype=torch.bool, device=a.device).tril()
    if runs is not None:
        mask = mask & (runs[..., :, None] == runs[..., None, :])[:, :, None,
                                                                  None]
    return torch.exp(torch.where(mask, diff, float("-inf")))


def ssd_chunk_ref(cc: torch.Tensor, bc: torch.Tensor, xf: torch.Tensor,
                  da_cum: torch.Tensor,
                  runs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The intra-chunk (diagonal-block) term of the SSD scan as the kernel
    computes it: ``S = C B^T`` once for each group, ``M_h = S o L_h``
    (:func:`_ssd_decay`), ``y_h = M_h X_h``.

    ``cc``, ``bc`` ``(B, C, L, G, N)``; ``xf`` ``(B, C, L, G, H, P)`` (x
    times dt); ``da_cum`` ``(B, C, L, G, H)``, the cumulative log decay
    within each chunk; ``runs`` ``(B, C, L)`` the run index of each
    position (``models.ssm.document_runs``) or None.  Returns ``(B, C, L,
    G, H, P)`` in the inputs' type (float32 or float64)."""
    scores = torch.einsum("bclgn,bcsgn->bcgls", cc, bc)
    m = scores[:, :, :, None] * _ssd_decay(da_cum, runs)
    return torch.einsum("bcghls,bcsghp->bclghp", m, xf)


def ssd_chunk_bwd_ref(cc: torch.Tensor, bc: torch.Tensor, xf: torch.Tensor,
                      da_cum: torch.Tensor, dy: torch.Tensor,
                      runs: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradients ``(dcc, dbc, dxf, dda_cum)`` of :func:`ssd_chunk_ref`
    for the output gradient ``dy``, derived by hand as the kernels compute
    them: ``dX_h = M_h^T dy_h``; ``dM_h = dy_h X_h^T``; ``dS = sum_h dM_h o
    L_h``, ``dC = dS B``, ``dB = dS^T C``; ``dA_h[l]`` the row sum less the
    column sum of ``dM_h o M_h`` at ``l``."""
    scores = torch.einsum("bclgn,bcsgn->bcgls", cc, bc)
    lmat = _ssd_decay(da_cum, runs)
    m = scores[:, :, :, None] * lmat
    dm = torch.einsum("bclghp,bcsghp->bcghls", dy, xf)
    dxf = torch.einsum("bcghls,bclghp->bcsghp", m, dy)
    ds = (dm * lmat).sum(3)
    dcc = torch.einsum("bcgls,bcsgn->bclgn", ds, bc)
    dbc = torch.einsum("bcgls,bclgn->bcsgn", ds, cc)
    p = dm * m
    dda = (p.sum(-1) - p.sum(-2)).permute(0, 1, 4, 2, 3)
    return dcc, dbc, dxf, dda


def ssd_gather_ref(u: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """``R_h = sum_l w[l, h] U_h[l]^T V[l]`` within each chunk: ``u`` ``(B,
    C, L, G, H, P)``, ``v`` ``(B, C, L, G, N)``, ``w`` ``(B, C, L, G, H)`` ->
    ``(B, C, G, H, P, N)`` (the state a chunk leaves, and the gradient of
    the state entering it)."""
    return torch.einsum("bclghp,bclgn->bcghpn", u * w[..., None], v)


def ssd_apply_ref(v: torch.Tensor, wm: torch.Tensor, w: torch.Tensor,
                  base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``base + w[l, h] V[l] W_h^T``: ``v`` ``(B, C, L, G, N)``, ``wm`` ``(B,
    C, G, H, P, N)``, ``w`` ``(B, C, L, G, H)`` -> ``(B, C, L, G, H, P)``
    (the entering state's term, and the states' gradient of x dt)."""
    out = w[..., None] * torch.einsum("bclgn,bcghpn->bclghp", v, wm)
    return out if base is None else base + out


def ssd_cross_ref(u: torch.Tensor, wm: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """With ``Z_h = U_h W_h``: ``(sum_h w[l, h] Z_h[l], V[l] . Z_h[l])``,
    ``(B, C, L, G, N)`` and ``(B, C, L, G, H)`` (the gradients of an
    :func:`ssd_apply_ref` term's V and w, or of a :func:`ssd_gather_ref`
    state's V and w)."""
    z = torch.einsum("bclghp,bcghpn->bclghn", u, wm)
    return (torch.einsum("bclgh,bclghn->bclgn", w, z),
            torch.einsum("bclgn,bclghn->bclgh", v, z))


# ---------------------------------------------------------------------------
# Model-block oracles for the repro_torch.nn kernel zoo.
# ---------------------------------------------------------------------------

def tree_sum_ref(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pairwise (log-tree) summation along one power-of-two axis.

    The MVE reduction idiom halves the dimension per step, so
    cross-dimension sums on the lane grid happen in *this* order — the low
    half plus the high half, until one element is left — not left to
    right.  Oracles that promise bit-exactness against a lane reduction
    must mirror it: fp32 addition is not associative."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    assert n & (n - 1) == 0, f"tree_sum_ref needs a power of two, got {n}"
    while n > 1:
        half = n // 2
        x = x[..., :half] + x[..., half:n]
        n = half
    return x[..., 0]


def ssm_scan_ref(h: torch.Tensor, a: torch.Tensor, bvec: torch.Tensor,
                 x: torch.Tensor, c: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One diagonal-SSM decode step.

    ``h, a: (P, N)``; ``bvec, c: (N,)``; ``x: (P,)``.  Returns ``(h_new,
    y)`` with ``h_new = a * h + bvec * x`` and ``y[p] = sum_n c[n] *
    h_new[p, n]``: the sum in pairwise-tree order, and every multiply and
    add in the sequence the MVE block kernel emits, so float32 results
    match bit for bit."""
    h = h.float()
    t = bvec.float()[None, :] * x.float()[:, None]
    h_new = a.float() * h
    h_new = h_new + t
    y = tree_sum_ref(c.float()[None, :] * h_new, axis=-1)
    return h_new, y


def moe_gather_ref(w: torch.Tensor, experts: torch.Tensor,
                   gates: torch.Tensor) -> torch.Tensor:
    """Top-k expert gather: ``y[t] = sum_j gates[t, j] * w[experts[t, j]]``.

    ``w: (E, D)`` expert rows, ``experts: (T, topk)`` indices, ``gates:
    (T, topk)``.  Accumulated over ``j = 0 .. topk - 1`` in order, as the
    MVE random-base gather kernel does, so float32 is bit-exact."""
    t, topk = experts.shape
    y = torch.zeros(t, w.shape[1], dtype=torch.float32, device=w.device)
    for j in range(topk):
        rows = w.float()[experts[:, j].long()]
        y = y + gates.float()[:, j][:, None] * rows
    return y
