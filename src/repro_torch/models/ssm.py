"""Mamba2 / SSD (state-space duality) sequence mixing.

Chunked algorithm per arXiv:2405.21060 (minimal-SSD form): the sequence
is split into chunks; intra-chunk terms use the quadratic
"attention-like" dual with a decay matrix, inter-chunk terms pass a
(heads, headdim, state) recurrence from chunk to chunk.  Decode is the
O(1)-per-token linear recurrence.

Packed rows: with ``segment_ids`` (B, S) the scan and the causal conv
restart wherever the id changes from one position to the next, as
``seq_idx`` does in ``mamba_ssm``'s chunk scan and in ``causal_conv1d``:
no state and no conv tap crosses a document's first token (padding, id 0,
is a stretch of its own).  Without ids they run the code they ran before.

On the card the scan goes to hand-written kernels
(:mod:`repro_torch.kernels.ssd_chunk`: the intra-chunk term, the chunk
states and the entering states' term; the 16-step recurrence stays here)
where they take the call's sizes (:func:`_takes_kernel`); every other
call, every CPU and ``DTensor`` call among them, runs the einsums below.

Oracle for tests: :func:`ssd_naive` (step-by-step recurrence).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import obs
from ..kernels import ssd_chunk as _ssd_kernel
from ..parallel.axes import cumsum, grad_as_forward, matmul, unflatten
from .common import rmsnorm


def _segsum(x: torch.Tensor, same: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """(..., L) -> (..., L, L); [i, j] = sum_{k=j+1..i} x_k, -inf for i<j
    and, with ``same`` (broadcast to (..., L, L)), where it is false."""
    cs = x.shape[-1]
    # a non-negative dim: DTensor's cumsum takes dim=-1 on a tensor split
    # along its last dim as pointwise and sums each rank's part alone
    xc = cumsum(x, x.dim() - 1)
    diff = xc[..., :, None] - xc[..., None, :]
    mask = torch.ones(cs, cs, dtype=torch.bool, device=x.device).tril()
    if same is not None:
        mask = mask & same
    return torch.where(mask, diff, float("-inf"))


def document_runs(segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) ids -> (B, S) int32 run index: it rises by one wherever the
    id differs from the previous position's, so equal indices are one
    unbroken stretch of one document."""
    change = (segment_ids[:, 1:] != segment_ids[:, :-1]).to(torch.int32)
    return F.pad(change, (1, 0)).cumsum(1, dtype=torch.int32)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _takes_kernel(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  chunk: int) -> bool:
    """Whether :func:`ssd_chunked` takes the kernels: plain tensors on the
    card, at a chunk, head dim and state size they take.  A ``DTensor``
    (the ``model`` axis) keeps the einsums."""
    if any(isinstance(t, DTensor) for t in (x, b, c)):
        return False
    return _on_card(x) and _ssd_kernel.supports(chunk, x.shape[-1],
                                                b.shape[-1])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it (no
    threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,H,P); dt: (B,S,H); a_log: (H,); b/c: (B,S,G,N).

    Returns (y (B,S,H,P), final_state (B,G,H/G,P,N) float32).  S is padded
    to a multiple of ``chunk`` with zeros: a zero ``dt`` decays by 1 and
    injects nothing, so the final state is unchanged.

    With ``segment_ids`` (B,S) the state restarts at zero at every
    document's first token (:func:`document_runs`): the decay matrix is
    cut between runs, a chunk's state keeps the run that reaches its end,
    and the state entering a chunk reaches only the positions of the run
    it came from (``initial_state`` is the first run's).  Such calls are
    counted in ``ssd_chunked.segmented``.

    The intra-chunk term, the chunk states and the entering states' term
    take the kernels where :func:`_takes_kernel` says so (counted in
    ``ssd_chunked.kernel``); elsewhere the einsums.
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
    runs = None
    if segment_ids is not None:
        ssd_chunked.segmented += 1
        runs = document_runs(segment_ids)
        if pad:                         # the padding joins each row's last run
            runs = torch.cat([runs, runs[:, -1:].expand(bsz, pad)], dim=1)
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk
    rc = None
    if runs is not None:
        rc = runs.view(bsz, nc, chunk)                      # (B,C,L)
        run_end = rc[:, :, -1]                              # (B,C)
        # the run whose state enters each chunk (the first chunk's: its own)
        run_in = torch.cat([rc[:, :1, 0], run_end[:, :-1]], dim=1)

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
    kernel = _takes_kernel(x, b, c, chunk)
    if kernel:
        ssd_chunked.kernel += 1
        y_diag = _ssd_kernel.ssd_chunk(cc_, bc_, xf, da_cum, rc)
    else:
        y_diag = _diag_einsum(da, cc_, bc_, xf, rc)

    # per-chunk input -> end-of-chunk state
    da_last = da_cum[:, :, -1:]                             # (B,C,1,G,H)
    decay_states = torch.exp(da_last - da_cum)              # (B,C,L,G,H)
    if runs is not None:
        decay_states = decay_states * (rc == run_end[..., None])[..., None,
                                                                  None]
    if kernel:
        states = _ssd_kernel.ssd_states(xf, bc_, decay_states)
    else:
        states = torch.einsum("bclgn,bclgh,bclghp->bcghpn",
                              bc_, decay_states, xf)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(da_last[:, :, 0])               # (B,C,G,H)
    if runs is not None:
        # the entering run reaches the chunk's end, or its state is dropped
        chunk_decay = chunk_decay * (run_in == run_end)[..., None, None]
    prev = (initial_state.float() if initial_state is not None
            else torch.zeros(bsz, g, hg, p, n, dtype=torch.float32,
                             device=x.device))
    if kernel:          # one gradient copy each, not a zero tensor a chunk
        states_at, decay_at = states.unbind(1), chunk_decay.unbind(1)
    else:
        states_at = [states[:, ci] for ci in range(nc)]
        decay_at = [chunk_decay[:, ci] for ci in range(nc)]
    entering = []
    for ci in range(nc):
        entering.append(prev)
        prev = prev * decay_at[ci][..., None, None] + states_at[ci]
    prev_states = torch.stack(entering, dim=1)              # (B,C,G,H,P,N)

    # contribution of the incoming state to each position
    state_decay = torch.exp(da_cum)                         # (B,C,L,G,H)
    if runs is not None:
        state_decay = state_decay * (rc == run_in[..., None])[..., None, None]
    if kernel:
        y = _ssd_kernel.ssd_add_entering(y_diag, cc_, prev_states,
                                         state_decay)
    else:
        y = y_diag + torch.einsum("bclgn,bcghpn,bclgh->bclghp",
                                  cc_, prev_states, state_decay)

    y = grad_as_forward(y.reshape(bsz, sp, h, p))
    if pad:
        y = y[:, :s]
    return y.to(x.dtype), prev


def _diag_einsum(da: torch.Tensor, cc_: torch.Tensor, bc_: torch.Tensor,
                 xf: torch.Tensor, rc: Optional[torch.Tensor]) -> torch.Tensor:
    """The intra-chunk term off the kernel: the decay matrix from the log
    decay ``da`` (B,C,L,G,H), cut between runs ``rc`` (B,C,L), then the
    dual attention.  Returns ``y_diag`` (B,C,L,G,H,P)."""
    same = (None if rc is None else
            (rc[..., :, None] == rc[..., None, :])[:, :, None, None])
    lmat = torch.exp(_segsum(da.permute(0, 1, 3, 4, 2), same))
    scores = torch.einsum("bclgn,bcsgn->bcgls", cc_, bc_)
    return torch.einsum("bcgls,bcghls,bcsghp->bclghp", scores, lmat, xf)


#: Calls of :func:`ssd_chunked` that took segment ids, and calls that took
#: the kernels (remat's recompute counts again).
ssd_chunked.segmented = 0
ssd_chunked.kernel = 0


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

def _causal_conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, kernel size K: (B,S,C) x (K,C) -> (B,S,C).
    With ``segment_ids`` (B,S) a tap reads nothing before its document's
    first token (:func:`document_runs`)."""
    ksize = w.shape[0]
    runs = None if segment_ids is None else document_runs(segment_ids)
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
        if runs is not None:
            same = F.pad(runs, (j, -j), value=-1) == runs
            shifted = torch.where(same[..., None], shifted, 0)
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


def _gate_norm(y: torch.Tensor, scale: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    """The gated output's RMSNorm, over each of ``groups`` equal slices of
    the last dim (Mamba2's ``RMSNormGated`` with ``ngroups``); one group
    is the plain norm over the whole width."""
    if groups == 1:
        return rmsnorm(y, scale, eps)
    width = y.shape[-1] // groups
    return rmsnorm(y.unflatten(-1, (groups, width)),
                   scale.unflatten(-1, (groups, width)), eps).flatten(-2)


def mamba_block(params: Dict, x: torch.Tensor, cfg,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """Pre-norm Mamba2 block with residual.  x: (B,S,D) (prefill) or
    (B,1,D) with ``state`` (decode).  Returns ``(out, new state)``; the
    caller's ``state`` tensors are not written."""
    hidden = rmsnorm(x, params["in_norm"], cfg.norm_eps)
    out, new_state = mamba_mixer(params, hidden, cfg, state)
    return x + out, new_state


def mamba_mixer(params: Dict, hidden: torch.Tensor, cfg,
                state: Optional[Dict] = None,
                segment_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """The Mamba2 mixer of the normed input ``hidden``: projections, causal
    conv, SSD (in the ``model.ssd`` span), the D skip, the gate and its
    grouped norm, and the output projection.  ``segment_ids`` (prefill and
    training) restart the conv and the scan at each document."""
    d_in = cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    h = cfg.ssm_heads
    p = cfg.ssm_headdim
    g = cfg.ssm_ngroups
    n = cfg.ssm_state
    bsz, s, _ = hidden.shape

    z, xin = torch.chunk(matmul(hidden, params["w_zx"]), 2,
                         dim=-1)                              # (B,S,din)
    bc = matmul(hidden, params["w_bc"])                       # (B,S,2gn)
    dt_raw = matmul(hidden, params["w_dt"])                   # (B,S,H)
    dt = _softplus(dt_raw.float() + params["dt_bias"].float())

    conv_in = torch.cat([xin, bc], dim=-1)                    # (B,S,conv)
    new_state: Dict = {}
    if state is None:
        conv_out = _causal_conv(conv_in, params["conv_w"], params["conv_b"],
                                segment_ids)
    else:
        conv_out, new_state["conv"] = _conv_step(
            conv_in[:, 0], state["conv"], params["conv_w"],
            params["conv_b"])
        conv_out = conv_out[:, None, :]
    conv_out = F.silu(conv_out)
    xc, bmat, cmat = torch.split(conv_out, [d_in, gn, gn], dim=-1)

    if state is None:
        with obs.span("model.ssd", device=True, grad=True) as sp:
            xs, dts, bs, cs = sp.inputs(
                xc.reshape(bsz, s, h, p), dt, bmat.reshape(bsz, s, g, n),
                cmat.reshape(bsz, s, g, n))
            y, new_state["ssm"] = ssd_chunked(
                xs, dts, params["a_log"], bs, cs, cfg.ssm_chunk,
                segment_ids=segment_ids)
            y = sp.output(y)
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
    y = _gate_norm(y, params["gate_norm"], g, cfg.norm_eps)
    return matmul(y, params["w_out"]), new_state
