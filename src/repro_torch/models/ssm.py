"""Mamba2 / SSD (state-space duality) sequence mixing.

Chunked algorithm per arXiv:2405.21060 (minimal-SSD form): the sequence
is split into chunks; intra-chunk terms use the quadratic
"attention-like" dual with a decay matrix, inter-chunk terms pass a
(heads, headdim, state) recurrence from chunk to chunk.  Decode is the
O(1)-per-token linear recurrence.

Oracle for tests: :func:`ssd_naive` (step-by-step recurrence).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..parallel.axes import cumsum, grad_as_forward, matmul, unflatten
from .common import rmsnorm


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L); [i, j] = sum_{k=j+1..i} x_k, -inf for i<j."""
    cs = x.shape[-1]
    # a non-negative dim: DTensor's cumsum takes dim=-1 on a tensor split
    # along its last dim as pointwise and sums each rank's part alone
    xc = cumsum(x, x.dim() - 1)
    diff = xc[..., :, None] - xc[..., None, :]
    mask = torch.ones(cs, cs, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, float("-inf"))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it (no
    threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H); a_log: (H,); b/c: (B,S,G,N).

    Returns (y (B,S,H,P), final_state (B,G,H/G,P,N) float32).  S is padded
    to a multiple of ``chunk`` with zeros: a zero ``dt`` decays by 1 and
    injects nothing, so the final state is unchanged.
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    if isinstance(x, DTensor) and all(
            not isinstance(q, Shard) or q.dim < 2 for q in x.placements):
        # one placement for the four (ROADMAP C14): on a model axis the
        # causal conv leaves x, b, c split along the batch and dt along the
        # sequence, and DTensor's einsum over the mixed placements views a
        # redistributed local tensor with strides that do not fit
        dt, b, c = (t.redistribute(x.device_mesh, x.placements)
                    if isinstance(t, DTensor) and t.placements != x.placements
                    else t for t in (dt, b, c))
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk

    a = -torch.exp(a_log.float())                           # (H,)

    def chunked(t, heads: bool):        # (B,S,...) -> (B,C,L,...)
        t = unflatten(t, 1, (nc, chunk))
        return unflatten(t, 3, (g, hg)) if heads else t

    da = chunked(dt.float() * a, True)                      # log decay
    xf = chunked(x * dt[..., None], True).float()
    bc_ = chunked(b, False).float()
    cc_ = chunked(c, False).float()

    da_cum = cumsum(da, 2)                                  # (B,C,L,G,H)

    # intra-chunk (diagonal blocks): decay matrix L then dual attention
    lmat = torch.exp(_segsum(da.permute(0, 1, 3, 4, 2)))    # (B,C,G,H,L,S)
    scores = torch.einsum("bclgn,bcsgn->bcgls", cc_, bc_)
    y_diag = torch.einsum("bcgls,bcghls,bcsghp->bclghp", scores, lmat, xf)
    del lmat

    # per-chunk input -> end-of-chunk state
    da_last = da_cum[:, :, -1:]                             # (B,C,1,G,H)
    decay_states = torch.exp(da_last - da_cum)              # (B,C,L,G,H)
    states = torch.einsum("bclgn,bclgh,bclghp->bcghpn",
                          bc_, decay_states, xf)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(da_last[:, :, 0])               # (B,C,G,H)
    prev = (initial_state.float() if initial_state is not None
            else torch.zeros(bsz, g, hg, p, n, dtype=torch.float32,
                             device=x.device))
    entering = []
    for ci in range(nc):
        entering.append(prev)
        prev = prev * chunk_decay[:, ci, ..., None, None] + states[:, ci]
    prev_states = torch.stack(entering, dim=1)              # (B,C,G,H,P,N)

    # contribution of the incoming state to each position
    state_decay = torch.exp(da_cum)                         # (B,C,L,G,H)
    y_off = torch.einsum("bclgn,bcghpn,bclgh->bclghp",
                         cc_, prev_states, state_decay)

    y = grad_as_forward((y_diag + y_off).reshape(bsz, sp, h, p))[:, :s]
    return y.to(x.dtype), prev


def ssd_naive(x, dt, a_log, b, c,
              initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step recurrence oracle (fp32)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    a = -torch.exp(a_log.float())
    state = (initial_state.float() if initial_state is not None
             else torch.zeros(bsz, g, hg, p, n, dtype=torch.float32,
                              device=x.device))
    ys = []
    for t in range(s):
        xt = (x[:, t] * dt[:, t, :, None]).float().reshape(bsz, g, hg, p)
        da = torch.exp(dt[:, t].float() * a).reshape(bsz, g, hg)
        state = state * da[..., None, None] + torch.einsum(
            "bgn,bghp->bghpn", b[:, t].float(), xt)
        yt = torch.einsum("bgn,bghpn->bghp", c[:, t].float(), state)
        ys.append(yt.reshape(bsz, h, p))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_decode_step(x, dt, a_log, b, c, state
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence.  x: (B,H,P); dt: (B,H); b/c: (B,G,N);
    state: (B,G,H/G,P,N).  Returns ``(y, new state)``; ``state`` itself
    is not written."""
    bsz, h, p = x.shape
    g, n = b.shape[1], b.shape[2]
    hg = h // g
    a = -torch.exp(a_log.float())
    da = torch.exp(dt.float() * a).reshape(bsz, g, hg)
    xdt = (x * dt[..., None]).float().reshape(bsz, g, hg, p)
    state = state * da[..., None, None] + torch.einsum(
        "bgn,bghp->bghpn", b.float(), xdt)
    y = torch.einsum("bgn,bghpn->bghp", c.float(), state)
    return y.reshape(bsz, h, p).to(x.dtype), state


# ---------------------------------------------------------------------------
# Full Mamba2 block (projections + causal conv + SSD + gated norm).
# ---------------------------------------------------------------------------

def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel size K: (B,S,C) x (K,C) -> (B,S,C)."""
    ksize = w.shape[0]
    if isinstance(u, DTensor) and any(isinstance(p, Shard) and p.dim == 1
                                      for p in u.placements):
        # whole along the sequence, the shifts' gradients too: torch
        # releases before 2.13 pad a split dim's gradient wrongly
        u = u.redistribute(u.device_mesh, tuple(
            Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in u.placements))
    out = u * w[-1]
    for i in range(1, ksize):
        # i zeros in front, i positions off the end (a pad, not a slice:
        # torch 2.11's DTensor gives the slice's gradient a wrong shape)
        j = min(i, u.shape[1])
        shifted = grad_as_forward(F.pad(u, (0, 0, j, -j)))
        out = out + shifted * w[ksize - 1 - i]
    return out + bias


def _conv_step(u_new: torch.Tensor, conv_state: torch.Tensor,
               w: torch.Tensor, bias: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode: u_new (B,C); conv_state (B,K-1,C).  Returns ``(out, new
    state)`` — a new tensor; ``conv_state`` itself is not written."""
    dt = torch.promote_types(conv_state.dtype, u_new.dtype)
    window = torch.cat([conv_state.to(dt), u_new[:, None, :].to(dt)], dim=1)
    out = torch.einsum("bkc,kc->bc", window, w.to(dt)) + bias
    return out, window[:, 1:]


def mamba_block(params: Dict, x: torch.Tensor, cfg,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """Pre-norm Mamba2 block with residual.  x: (B,S,D) (prefill) or
    (B,1,D) with ``state`` (decode).  Returns ``(out, new state)``; the
    caller's ``state`` tensors are not written."""
    d_in = cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    h = cfg.ssm_heads
    p = cfg.ssm_headdim
    g = cfg.ssm_ngroups
    n = cfg.ssm_state
    bsz, s, _ = x.shape

    hidden = rmsnorm(x, params["in_norm"], cfg.norm_eps)
    z, xin = torch.chunk(matmul(hidden, params["w_zx"]), 2,
                         dim=-1)                              # (B,S,din)
    bc = matmul(hidden, params["w_bc"])                       # (B,S,2gn)
    dt_raw = matmul(hidden, params["w_dt"])                   # (B,S,H)
    dt = _softplus(dt_raw.float() + params["dt_bias"].float())

    conv_in = torch.cat([xin, bc], dim=-1)                    # (B,S,conv)
    new_state: Dict = {}
    if state is None:
        conv_out = _causal_conv(conv_in, params["conv_w"], params["conv_b"])
    else:
        conv_out, new_state["conv"] = _conv_step(
            conv_in[:, 0], state["conv"], params["conv_w"],
            params["conv_b"])
        conv_out = conv_out[:, None, :]
    conv_out = F.silu(conv_out)
    xc, bmat, cmat = torch.split(conv_out, [d_in, gn, gn], dim=-1)

    if state is None:
        y, new_state["ssm"] = ssd_chunked(
            xc.reshape(bsz, s, h, p), dt, params["a_log"],
            bmat.reshape(bsz, s, g, n), cmat.reshape(bsz, s, g, n),
            cfg.ssm_chunk)
        # conv state = last (K-1) raw conv inputs, left-padded if short
        k1 = cfg.ssm_conv - 1
        new_state["conv"] = (conv_in[:, -k1:, :] if s >= k1 else
                             F.pad(conv_in, (0, 0, k1 - s, 0)))
    else:
        yd, new_state["ssm"] = ssd_decode_step(
            xc[:, 0].reshape(bsz, h, p), dt[:, 0], params["a_log"],
            bmat[:, 0].reshape(bsz, g, n), cmat[:, 0].reshape(bsz, g, n),
            state["ssm"])
        y = yd[:, None]

    y = y + params["d_skip"].to(y.dtype)[:, None] * xc.reshape(bsz, s, h, p)
    y = y.reshape(bsz, s, d_in) * F.silu(z)
    y = rmsnorm(y, params["gate_norm"], cfg.norm_eps)
    return x + matmul(y, params["w_out"]), new_state
