"""GQA attention: chunked-causal (train/prefill), cached decode.

Attention takes the hand-written flash kernel
(:func:`repro_torch.kernels.ops.flash_attention`) wherever the head dim is
64 or 128 and the kv ids (``kv_segment_ids``, else ``segment_ids``), where
given, have one entry a key: every self attention of ``models/lm.py``,
packed batches with their ``segment_ids`` included.  The reference takes
its Pallas kernel only without ids, and plain attention with them (ROADMAP,
"Deliberate divergences"); the port's kernels take the ids themselves,
skipping the tiles that share no segment
(:mod:`repro_torch.kernels.flash_attention`).  Every other call (head dim
80, kv ids of another length) takes the plain chunked route, counted in
``chunked_attention.plain_chunks`` (one a query chunk, recompute
included; :func:`plain_chunked_attention`).  In training the flash route
is differentiated by its own backward kernels
(:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`), the plain
route by autograd, one query chunk at a time under non-reentrant
``torch.utils.checkpoint`` as the reference's ``jax.checkpoint`` of each
chunk.

The reference's sharding constraints stand at its sites
(:func:`~repro_torch.parallel.axes.constrain`): no-ops outside a mesh, on a
``model`` axis ``DTensor`` redistributions.  The flash route takes each
rank's own q heads and the kv heads they use as local tensors
(:func:`_flash_on_local_heads`), so no ``DTensor`` reaches the kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..kernels import ops as kops
from ..kernels.flash_attention import HEAD_DIMS
from ..parallel.axes import (constrain, einsum, gather, on_model_mesh,
                             unflatten)

NEG_INF = -1e30


def _grouped(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,K,G,D)."""
    return unflatten(q, 2, (kv_heads, q.shape[2] // kv_heads))


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      segment_ids: Optional[torch.Tensor] = None,
                      kv_segment_ids: Optional[torch.Tensor] = None,
                      chunk: int = 512) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k/v: (B,Sk,K,D) -> (B,Sq,Hq,D); ``segment_ids``
    (B,Sq) and ``kv_segment_ids`` (B,Sk, default ``segment_ids``) keep
    each query to the keys of its own id.  The flash route where the head
    dim allows it and the kv ids (if any) have one entry a key, else
    :func:`plain_chunked_attention`."""
    d, sk = q.shape[3], k.shape[1]
    # K/V of another type than q (a bfloat16 cache under float32 weights)
    # meet q in the promoted type, as in the reference
    dt = torch.promote_types(q.dtype, k.dtype)
    kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
    if d not in HEAD_DIMS or (segment_ids is not None
                              and kv_seg.shape[-1] != sk):
        return plain_chunked_attention(q, k, v, causal, segment_ids,
                                       kv_segment_ids, chunk)
    ids = ({} if segment_ids is None else
           {"segment_ids": gather(segment_ids),
            "kv_segment_ids": gather(kv_seg)})
    if any(isinstance(x, DTensor) for x in (q, k, v)):
        return _flash_on_local_heads(q, k, v, causal, dt, **ids)
    # the flash route: (B,H,S,D) views, no copies; the kernel serves q head
    # h from kv head h // (Hq/K), which is the reference's jnp.repeat of
    # the kv heads
    out = kops.flash_attention(*(x.transpose(1, 2).to(dt) for x in (q, k, v)),
                               causal=causal, **ids)
    return out.transpose(1, 2).to(q.dtype)


def plain_chunked_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            segment_ids: Optional[torch.Tensor] = None,
                            kv_segment_ids: Optional[torch.Tensor] = None,
                            chunk: int = 512,
                            scale: Optional[float] = None) -> torch.Tensor:
    """The plain route of :func:`chunked_attention`, the reference's own:
    the repeated K/V, one query chunk of fp32 logits at a time, each
    chunk's ids against all the kv ids.  The logits' scale is ``scale``,
    by default ``1/sqrt(D)`` (Zamba2's shared attention takes
    ``(D/2)^-1/2``)."""
    b, sq, hq, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dt = torch.promote_types(q.dtype, k.dtype)
    kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids

    # GQA: the kv heads repeated so that the merged head axis splits over
    # the model axis as the q heads do
    g = hq // kh
    kr = k.repeat_interleave(g, dim=2) if g > 1 else k     # (B,Sk,Hq,D)
    vr = v.repeat_interleave(g, dim=2) if g > 1 else v
    kr = constrain(kr, "batch", None, "act_heads", None)
    vr = constrain(vr, "batch", None, "act_heads", None)

    chunk = min(chunk, sq)
    # the backward recomputes each chunk's (chunk, Sk) probabilities
    # instead of keeping them, as the reference's checkpointed scan body
    record = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    outs = []
    for start in range(0, sq, chunk):
        seg_c = (segment_ids[:, start:start + chunk]
                 if segment_ids is not None and kv_seg is not None else None)
        args = (q[:, start:start + chunk], kr, vr, start, seg_c, kv_seg,
                causal, sk - sq, scale, dt)
        outs.append(checkpoint(_attend_chunk, *args, use_reentrant=False)
                    if record else _attend_chunk(*args))
    return torch.cat(outs, dim=1)


def _flash_on_local_heads(q, k, v, causal: bool, dt, **ids) -> DTensor:
    """The flash route on the ``model`` sub-mesh: each rank runs the
    kernel on its own q heads (all of them where the head count does not
    split over the axis) and the kv heads those use, as local tensors,
    with the segment ids (``ids``) whole: they are per row, not per head.
    The kernel serves local q head ``h`` from local kv head ``h // group``,
    so the kv heads handed over are the whole groups of the rank's q heads,
    the one kv head they share, or else each q head's own (gathered, group
    1).  Where q is split, each rank's K/V gradient is its q heads' part:
    the local K/V carry ``Partial`` gradients."""
    sub = next(x for x in (q, k, v) if isinstance(x, DTensor)).device_mesh
    hq, kh = q.shape[2], k.shape[2]
    g, n = hq // kh, sub.size()
    heads = (Shard(2),) if n > 1 and hq % n == 0 else (Replicate(),)
    q = on_model_mesh(q, sub).redistribute(sub, heads)
    grads = (Partial(),) if heads[0] != Replicate() else None
    kl, vl = (on_model_mesh(x, sub).redistribute(sub, (Replicate(),))
              .to_local(grad_placements=grads) for x in (k, v))
    if grads is not None:
        lo = sub.get_local_rank() * (hq // n)
        hi = lo + hq // n
        if (hi - lo) % g == 0:                    # whole groups
            kl, vl = (x[:, :, lo // g:hi // g] for x in (kl, vl))
        elif lo // g == (hi - 1) // g:            # one group's heads
            kl, vl = (x[:, :, lo // g:lo // g + 1] for x in (kl, vl))
        else:                                     # each q head's own
            idx = torch.arange(lo, hi, device=kl.device) // g
            kl, vl = (x.index_select(2, idx) for x in (kl, vl))
    out = kops.flash_attention(*(x.transpose(1, 2).to(dt)
                                 for x in (q.to_local(), kl, vl)),
                               causal=causal, **ids)
    return DTensor.from_local(out.transpose(1, 2).to(q.dtype), sub, heads,
                              run_check=False)


def _attend_chunk(qc, kr, vr, start: int, seg_c, kv_seg, causal: bool,
                  offset: int, scale: float, dt) -> torch.Tensor:
    """One query chunk ``qc`` (B, c, Hq, D) of the plain route over the
    repeated K/V (B, Sk, Hq, D)."""
    chunked_attention.plain_chunks += 1
    b, c = qc.shape[:2]
    sk = kr.shape[1]
    # operands in the model type, products accumulated in f32 and then
    # rounded to it, as the reference's einsum does
    qc = constrain(qc, "batch", None, "act_heads", None)
    logits = einsum("bchd,bshd->bhcs", qc.to(dt), kr.to(dt))
    logits = logits.float() * scale
    logits = constrain(logits, "batch", "act_heads", "seq", None)
    valid = torch.ones(b, 1, c, sk, dtype=torch.bool, device=qc.device)
    if causal:
        kpos = torch.arange(sk, device=qc.device)
        qpos = start + torch.arange(c, device=qc.device) + offset
        valid = valid & (qpos[:, None] >= kpos[None, :])[None, None]
    if seg_c is not None:
        valid = valid & (seg_c[:, None, :, None] == kv_seg[:, None, None, :])
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = constrain(probs, "batch", "act_heads", "seq", None)
    out = einsum("bhcs,bshd->bchd", probs.to(vr.dtype), vr)
    out = constrain(out, "batch", None, "act_heads", None)
    return out.to(qc.dtype)


#: Number of query chunks the plain route attended (a remat recompute
#: counts again): 0 in a step whose every attention took the flash route.
chunked_attention.plain_chunks = 0


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_index) -> torch.Tensor:
    """One-token attention over a (B,S,K,D) cache filled up to and
    including ``cache_index`` (an int, or a ``(B,)`` tensor of one index
    per row)."""
    b, one, hq, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(d)
    if k_cache.dtype == torch.float8_e4m3fn:     # quantized KV cache
        k_cache = k_cache.to(q.dtype)
        v_cache = v_cache.to(q.dtype)
    qg = _grouped(q, kh)                                   # (B,1,K,G,D)
    # the einsum in the operands' (promoted) type, then f32, then the scale
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    logits = einsum("bokgd,bskd->bkgos", qg.to(dt), k_cache.to(dt))
    logits = logits.float() * scale
    # kv-sequence split attention (flash-decode): each rank scores its
    # cache slice; the softmax over the split axis gathers it
    logits = constrain(logits, "batch", None, None, None, "kv_seq")
    ci = torch.as_tensor(cache_index, device=q.device).reshape(-1)
    valid = (torch.arange(s, device=q.device)[None, :] <= ci[:, None]
             )[:, None, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = constrain(probs, "batch", None, None, None, "kv_seq")
    out = einsum("bkgos,bskd->bokgd", probs.to(v_cache.dtype),
                       v_cache)
    return out.reshape(b, one, hq, d).to(q.dtype)


#: float8_e4m3fn has no infinity, and the reference's conversion (ml_dtypes'
#: rule, round to nearest even) gives NaN for what rounds past 448: every
#: |x| > 464, and +-inf.  torch saturates those to +-448 instead on the CPU.
E4M3_NAN_ABOVE = 464.0


def _to_cache_type(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` converted to the cache's type as the reference's ``astype``
    converts it.  For ``float8_e4m3fn`` the rule is written out: widened
    to float32, NaN, +-inf and |x| > ``E4M3_NAN_ABOVE`` become NaN with x's
    sign (bytes 0x7f / 0xff, the same on every device), everything else
    goes through ``.to``.  Other types convert with ``.to`` as they are."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    x = x.float()
    nan = ~(x.abs() <= E4M3_NAN_ABOVE)
    out = torch.where(nan, 0.0, x).to(dtype).view(torch.uint8)
    nan_bits = torch.signbit(x).to(torch.uint8) << 7 | 0x7F
    return torch.where(nan, nan_bits, out).view(dtype)


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 cache_index) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the new token's K/V at ``cache_index``, **in place** (the
    reference returns updated copies; the port saves copying the whole
    cache per token), and return the caches.

    An int writes one sequence slice of every row, clamped into the cache
    as ``dynamic_update_slice`` clamps; a ``(B,)`` tensor writes each row
    at its own position (continuous-batching decode): an index in
    ``[-S, 0)`` counts from the end, and a row whose index lies outside
    the cache keeps its contents, as the reference's scatter drops it.

    A ``DTensor`` cache (on the ``model`` axis: its sequence split by
    ``kv_seq``, or whole) is written on this rank's own part, which keeps
    its placements; an in-place write into the ``DTensor`` itself does
    not."""
    if isinstance(k_cache, DTensor):
        _update_local(k_cache, v_cache, k_new, v_new, cache_index)
        return k_cache, v_cache
    s = k_cache.shape[1]
    if isinstance(cache_index, int):
        i = min(max(cache_index, 0), s - 1)
        k_cache[:, i] = _to_cache_type(k_new[:, 0], k_cache.dtype)
        v_cache[:, i] = _to_cache_type(v_new[:, 0], v_cache.dtype)
        return k_cache, v_cache
    ci = cache_index.to(k_cache.device).long()
    _write_rows((k_cache, v_cache), (k_new, v_new),
                torch.where(ci < 0, ci + s, ci), 0)
    return k_cache, v_cache


def _write_rows(caches, news, ci: torch.Tensor, lo: int) -> None:
    """Each row's new K/V (``news``, each ``(B, 1, K, D)``) at its
    position ``ci`` of the whole sequence, written into ``caches`` (each
    ``(B, part, K, D)``, positions ``lo`` onward) where the position falls
    in it; a row whose position lies outside keeps its contents."""
    part = caches[0].shape[1]
    keep = ((ci >= lo) & (ci < lo + part))[:, None, None]
    ci = (ci - lo).clamp(0, part - 1)
    rows = torch.arange(caches[0].shape[0], device=caches[0].device)
    for cache, new in zip(caches, news):
        new = _to_cache_type(new[:, 0], cache.dtype)
        if cache.dtype == torch.float8_e4m3fn:     # select and scatter bytes
            cache, new = cache.view(torch.uint8), new.view(torch.uint8)
        cache[rows, ci] = torch.where(keep, new, cache[rows, ci])


def _update_local(k_cache: DTensor, v_cache: DTensor, k_new, v_new,
                  cache_index) -> None:
    """:func:`update_cache` on this rank's part of a ``DTensor`` cache
    whose sequence (dim 1) is split over its mesh or whole: the index is
    resolved on the whole sequence, then written where it falls in the
    part; a row whose position lies on another rank keeps its part."""
    (p,), sub = k_cache.placements, k_cache.device_mesh
    if isinstance(p, Shard) and p.dim != 1:
        raise ValueError(f"a cache split on dim {p.dim}: only its "
                         "sequence (dim 1) may be split")
    s = k_cache.shape[1]
    kl, vl = k_cache.to_local(), v_cache.to_local()
    lo = sub.get_local_rank() * kl.shape[1] if isinstance(p, Shard) else 0
    if isinstance(cache_index, int):
        ci = torch.full((kl.shape[0],), min(max(cache_index, 0), s - 1),
                        dtype=torch.long, device=kl.device)
    else:
        ci = cache_index.to(kl.device).long()
        ci = torch.where(ci < 0, ci + s, ci)
    _write_rows((kl, vl), (gather(k_new), gather(v_new)), ci, lo)
