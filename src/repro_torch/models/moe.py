"""Mixture-of-Experts block: GShard-style grouped top-k dispatch with
capacity.

Tokens are split into groups of ``cfg.moe_group_size``; per group a
(g, E, c) dispatch/combine pair routes tokens to experts via einsum so the
expert matmuls stay dense.  Expert weights carry the ``expert`` logical
axis, split over the ``model`` mesh axis (expert parallelism); the
dispatched tokens and the experts' outputs are placed by ``act_expert`` at
the reference's sites.

On a mesh the groups are the reference's: formed over the whole batch's
token list (each microbatch's), which the batch's ranks hold in contiguous
runs (:func:`group_span`).  A rank whose tokens fill whole groups routes
them alone; otherwise it gathers the batch's tokens
(:func:`~repro_torch.parallel.axes.gather_batch_rows`), routes the groups
that hold its tokens as the reference's one program does, and keeps its own
rows of the output.  The load-balance statistics are taken over every
group of the batch once.

Supports: top-1 (llama4-scout) and top-2 (arctic), a llama4-style shared
expert, an arctic-style parallel dense residual, and a load-balance aux
loss (Switch/GShard form), returned beside the output.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..parallel.axes import (batch_mean, batch_rank, batch_sum, constrain,
                             gather_batch_rows, matmul, whole_reshape)
from .common import activation_fn


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, the
    lower index first among equal values (``jax.lax.top_k``'s order; a
    plain ``torch.topk`` leaves ties unordered)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class GroupSpan(NamedTuple):
    """Where one rank's tokens lie among the MoE groups of the batch's
    global token list: ``size`` tokens a group, the rank's global tokens
    ``[tokens[0], tokens[1])``, the groups that hold them ``[groups[0],
    groups[1])``, and the batch's ``total`` groups over its ``batch``
    tokens (the last group padded where they do not fill it)."""
    size: int
    tokens: Tuple[int, int]
    groups: Tuple[int, int]
    total: int
    batch: int

    @property
    def whole(self) -> bool:
        """The rank's tokens are whole groups of their own (or the batch
        has one rank)."""
        t = self.tokens[1] - self.tokens[0]
        return t == self.batch or t % self.size == 0


def group_span(local: int, ranks: int, rank: int, group_size: int
               ) -> GroupSpan:
    """The reference's groups over the ``local * ranks`` tokens that
    ``ranks`` ranks hold ``local`` each (rank ``r`` the global tokens
    ``[r * local, (r + 1) * local)``): ``min(group_size, tokens)`` a group,
    padded at the end of the list."""
    batch = local * ranks
    g = min(group_size, batch)
    start = rank * local
    return GroupSpan(g, (start, start + local),
                     (start // g, -(-(start + local) // g)), -(-batch // g),
                     batch)


def _route(params: Dict, xg: torch.Tensor, cfg, capacity: int):
    """The experts' output for each token of the groups ``xg`` (G, g, d),
    the router's probabilities and the tokens' expert choices."""
    e = cfg.num_experts
    k = cfg.experts_per_token
    act = activation_fn(cfg.activation)
    ng, g, _ = xg.shape
    logits = matmul(xg, params["router"]).float()                # (G,g,E)
    probs = torch.softmax(logits, dim=-1)

    gate_vals, gate_idx = top_k_stable(probs, k)            # (G,g,k)
    # renormalize the k gates (standard for top-2 routing)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    counts = torch.zeros(ng, e, dtype=torch.int32, device=xg.device)
    dispatch = torch.zeros(ng, g, e, capacity, dtype=xg.dtype,
                           device=xg.device)
    combine = torch.zeros(ng, g, e, capacity, dtype=torch.float32,
                          device=xg.device)
    for j in range(k):
        mask_j = F.one_hot(gate_idx[..., j], e).to(torch.int32)  # (G,g,E)
        # a token's slot in its expert's buffer: the tokens before it in
        # the group (and in earlier choices) routed there
        pos_j = counts[:, None, :] + torch.cumsum(mask_j, dim=1,
                                                  dtype=torch.int32) - mask_j
        keep = (pos_j < capacity) & (mask_j > 0)
        counts = counts + mask_j.sum(dim=1, dtype=torch.int32)
        # a dropped token's one-hot row is all zeros
        slot = torch.where(keep, pos_j, capacity).long()
        oh = F.one_hot(slot, capacity + 1)[..., :capacity].to(xg.dtype)
        oh = oh * keep[..., None].to(xg.dtype)
        dispatch = dispatch + oh
        combine = combine + oh.float() * \
            gate_vals[..., j, None, None] * mask_j[..., None]

    xd = torch.einsum("GgEc,Ggd->GEcd", dispatch, xg)
    xd = constrain(xd, None, "act_expert", None, None)
    h = act(torch.einsum("GEcd,Edf->GEcf", xd, params["wi"]))
    h = h * torch.einsum("GEcd,Edf->GEcf", xd, params["wg"])
    y = torch.einsum("GEcf,Efd->GEcd", h, params["wo"])
    y = constrain(y, None, "act_expert", None, None)
    out = torch.einsum("GgEc,GEcd->Ggd", combine.to(y.dtype), y)
    return out, probs, gate_idx


def moe_ffn(params: Dict, x: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B,S,D), aux_loss scalar)."""
    b, s, d = x.shape
    e = cfg.num_experts
    act = activation_fn(cfg.activation)
    t = b * s
    rank, ranks = batch_rank()
    span = group_span(t, ranks, rank, cfg.moe_group_size)
    g = span.size
    capacity = max(int(math.ceil(cfg.experts_per_token * g / e
                                 * cfg.capacity_factor)), 4)
    xt = whole_reshape(x, t, d)     # the groups run along the sequence
    if span.whole:
        pad = -t % g
        if pad:
            xt = F.pad(xt, (0, 0, 0, pad))
        xg = constrain(xt.reshape(xt.shape[0] // g, g, d), "batch", None,
                       None)
        out, probs, gate_idx = _route(params, xg, cfg, capacity)
        # aux load-balance loss: E * sum_e mean(frac_tokens_e) *
        # mean(prob_e), the means over every group of the batch, on a mesh
        # too (each rank holds as many whole groups)
        frac = batch_mean(F.one_hot(gate_idx[..., 0], e).float().mean(
            dim=(0, 1)))
        mean_prob = batch_mean(probs.mean(dim=(0, 1)))
        out = whole_reshape(whole_reshape(out, -1, d)[:t], b, s, d)
    else:
        # the groups that hold this rank's tokens, from every rank's
        first, stop = span.groups
        lo, hi = first * g, min(stop * g, span.batch)
        xs = gather_batch_rows(xt)[lo:hi]
        if stop * g > hi:                       # the batch's padded group
            xs = F.pad(xs, (0, 0, 0, stop * g - hi))
        xg = constrain(xs.reshape(stop - first, g, d), "batch", None, None)
        out, probs, gate_idx = _route(params, xg, cfg, capacity)
        # the statistics of this rank's own tokens (and of the padding, on
        # the rank that holds the batch's last token), summed over the
        # batch's ranks: each of the batch's groups counted once
        own = span.tokens[0] - lo
        counted = slice(own, (stop - first) * g if span.tokens[1] ==
                        span.batch else own + t)
        n = span.total * g
        frac = batch_sum(F.one_hot(gate_idx[..., 0], e).float().reshape(
            -1, e)[counted].sum(dim=0)) / n
        mean_prob = batch_sum(probs.reshape(-1, e)[counted].sum(dim=0)) / n
        out = whole_reshape(whole_reshape(out, -1, d)[own:own + t], b, s, d)
    aux = e * torch.sum(frac * mean_prob)

    if cfg.moe_shared_expert or cfg.moe_dense_residual:
        p = params["shared" if cfg.moe_shared_expert else "dense"]
        hh = act(matmul(x, p["wi"])) * matmul(x, p["wg"])
        out = out + matmul(hh, p["wo"])
    return out, aux
