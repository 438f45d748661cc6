"""GQA attention: chunked-causal (train/prefill), cached decode.

Attention takes the hand-written flash kernel
(:func:`repro_torch.kernels.ops.flash_attention`) wherever the reference's
``use_pallas=True`` route does — no ``segment_ids`` and a head dim of 64 or
128 — and the plain chunked route otherwise.  In training the flash route
is differentiated by its own backward kernels
(:class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`), the plain
route by autograd, one query chunk at a time under non-reentrant
``torch.utils.checkpoint`` as the reference's ``jax.checkpoint`` of each
chunk.  The reference's sharding constraints are no-ops outside a mesh and
are left out.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops as kops
from ..kernels.flash_attention import HEAD_DIMS

NEG_INF = -1e30


def _grouped(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,K,G,D)."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, kv_heads, hq // kv_heads, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      segment_ids: Optional[torch.Tensor] = None,
                      kv_segment_ids: Optional[torch.Tensor] = None,
                      chunk: int = 512) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k/v: (B,Sk,K,D) -> (B,Sq,Hq,D)."""
    b, sq, hq, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)

    # K/V of another type than q (a bfloat16 cache under float32 weights)
    # meet q in the promoted type, as in the reference
    dt = torch.promote_types(q.dtype, k.dtype)
    if segment_ids is None and d in HEAD_DIMS:
        # the flash route: (B,H,S,D) views, no copies; the kernel serves
        # q head h from kv head h // (Hq/K), which is the reference's
        # jnp.repeat of the kv heads
        out = kops.flash_attention(*(x.transpose(1, 2).to(dt)
                                     for x in (q, k, v)), causal=causal)
        return out.transpose(1, 2).to(q.dtype)

    g = hq // kh
    kr = k.repeat_interleave(g, dim=2) if g > 1 else k     # (B,Sk,Hq,D)
    vr = v.repeat_interleave(g, dim=2) if g > 1 else v

    chunk = min(chunk, sq)
    kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
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


def _attend_chunk(qc, kr, vr, start: int, seg_c, kv_seg, causal: bool,
                  offset: int, scale: float, dt) -> torch.Tensor:
    """One query chunk ``qc`` (B, c, Hq, D) of the plain route over the
    repeated K/V (B, Sk, Hq, D)."""
    b, c = qc.shape[:2]
    sk = kr.shape[1]
    # operands in the model type, products accumulated in f32 and then
    # rounded to it, as the reference's einsum does
    logits = torch.einsum("bchd,bshd->bhcs", qc.to(dt), kr.to(dt))
    logits = logits.float() * scale
    valid = torch.ones(b, 1, c, sk, dtype=torch.bool, device=qc.device)
    if causal:
        kpos = torch.arange(sk, device=qc.device)
        qpos = start + torch.arange(c, device=qc.device) + offset
        valid = valid & (qpos[:, None] >= kpos[None, :])[None, None]
    if seg_c is not None:
        valid = valid & (seg_c[:, None, :, None] == kv_seg[:, None, None, :])
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhcs,bshd->bchd", probs.to(vr.dtype), vr)
    return out.to(qc.dtype)


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
    logits = torch.einsum("bokgd,bskd->bkgos", qg.to(dt), k_cache.to(dt))
    logits = logits.float() * scale
    ci = torch.as_tensor(cache_index, device=q.device).reshape(-1)
    valid = (torch.arange(s, device=q.device)[None, :] <= ci[:, None]
             )[:, None, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgos,bskd->bokgd", probs.to(v_cache.dtype),
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
    the cache keeps its contents, as the reference's scatter drops it."""
    s = k_cache.shape[1]
    if isinstance(cache_index, int):
        i = min(max(cache_index, 0), s - 1)
        k_cache[:, i] = _to_cache_type(k_new[:, 0], k_cache.dtype)
        v_cache[:, i] = _to_cache_type(v_new[:, 0], v_cache.dtype)
        return k_cache, v_cache
    ci = cache_index.to(k_cache.device).long()
    ci = torch.where(ci < 0, ci + s, ci)
    keep = ((ci >= 0) & (ci < s))[:, None, None]
    ci = ci.clamp(0, s - 1)
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        new = _to_cache_type(new[:, 0], cache.dtype)
        if cache.dtype == torch.float8_e4m3fn:     # select and scatter bytes
            cache, new = cache.view(torch.uint8), new.view(torch.uint8)
        cache[rows, ci] = torch.where(keep, new, cache[rows, ci])
    return k_cache, v_cache
