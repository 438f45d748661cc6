"""Mixture-of-Experts block: GShard-style grouped top-k dispatch with
capacity.

Tokens are split into groups of ``cfg.moe_group_size``; per group a
(g, E, c) dispatch/combine pair routes tokens to experts via einsum so the
expert matmuls stay dense.  Expert weights carry the ``expert`` logical
axis, split over the ``model`` mesh axis (expert parallelism); the
dispatched tokens and the experts' outputs are placed by ``act_expert`` at
the reference's sites, and on a data mesh the load-balance statistics are
averaged over the batch's ranks.

Supports: top-1 (llama4-scout) and top-2 (arctic), a llama4-style shared
expert, an arctic-style parallel dense residual, and a load-balance aux
loss (Switch/GShard form), returned beside the output.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..parallel.axes import batch_mean, constrain, matmul, whole_reshape
from .common import activation_fn


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, the
    lower index first among equal values (``jax.lax.top_k``'s order; a
    plain ``torch.topk`` leaves ties unordered)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(params: Dict, x: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B,S,D), aux_loss scalar)."""
    b, s, d = x.shape
    e = cfg.num_experts
    k = cfg.experts_per_token
    act = activation_fn(cfg.activation)
    t = b * s
    g = min(cfg.moe_group_size, t)
    pad = -t % g
    xt = whole_reshape(x, t, d)     # the groups run along the sequence
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    ng = xt.shape[0] // g
    xg = constrain(xt.reshape(ng, g, d), "batch", None, None)

    logits = matmul(xg, params["router"]).float()                # (G,g,E)
    probs = torch.softmax(logits, dim=-1)

    capacity = max(int(math.ceil(k * g / e * cfg.capacity_factor)), 4)

    gate_vals, gate_idx = top_k_stable(probs, k)            # (G,g,k)
    # renormalize the k gates (standard for top-2 routing)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    counts = torch.zeros(ng, e, dtype=torch.int32, device=x.device)
    dispatch = torch.zeros(ng, g, e, capacity, dtype=xg.dtype,
                           device=x.device)
    combine = torch.zeros(ng, g, e, capacity, dtype=torch.float32,
                          device=x.device)
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

    # aux load-balance loss: E * sum_e mean(frac_tokens_e) * mean(prob_e)
    # means over every group of the batch, on a mesh too (each rank holds
    # as many whole groups)
    frac = batch_mean(F.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1)))
    mean_prob = batch_mean(probs.mean(dim=(0, 1)))
    aux = e * torch.sum(frac * mean_prob)

    xd = torch.einsum("GgEc,Ggd->GEcd", dispatch, xg)
    xd = constrain(xd, None, "act_expert", None, None)
    h = act(torch.einsum("GEcd,Edf->GEcf", xd, params["wi"]))
    h = h * torch.einsum("GEcd,Edf->GEcf", xd, params["wg"])
    y = torch.einsum("GEcf,Efd->GEcd", h, params["wo"])
    y = constrain(y, None, "act_expert", None, None)
    out = torch.einsum("GgEc,GEcd->Ggd", combine.to(y.dtype), y)

    out = whole_reshape(whole_reshape(out, -1, d)[:t], b, s, d)

    if cfg.moe_shared_expert or cfg.moe_dense_residual:
        p = params["shared" if cfg.moe_shared_expert else "dense"]
        hh = act(matmul(x, p["wi"])) * matmul(x, p["wg"])
        out = out + matmul(hh, p["wo"])
    return out, aux
