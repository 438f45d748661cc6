"""Model assembly: the :class:`LM` object of the reference, for the dense
(GQA transformer) family.

One :class:`LM` per config exposes

  * ``abstract_params()`` / ``init_params(generator, device)`` (+ logical
    sharding axes, kept so the trees match the reference's),
  * ``prefill(params, batch)``  -> (last-token logits, cache),
  * ``decode_step(params, cache, tokens, cache_index)``,
  * ``cache_defs(batch, seq)``.

Only the ``dense`` family is ported, whose prefill runs the hand-written
flash kernel.  A model of another family (``moe``, ``ssm``, ``hybrid``,
``vlm``, ``encdec``) and the training ``loss`` raise
``NotImplementedError``: they are later slices of the port (ROADMAP.md,
queue A), each bringing its parameter declarations with it.  The
reference's scanned layer stack is a Python loop over the stacked
``(L, ...)`` parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.machine import resolve_device
from .attention import chunked_attention, decode_attention, update_cache
from .common import (DTYPES, ParamDef, abstract_tree, activation_fn,
                     axes_tree, materialize_tree, rmsnorm, rope)

PORTED_FAMILIES = ("dense",)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue A); "
        f"ported families: {PORTED_FAMILIES}")


# ---------------------------------------------------------------------------
# Parameter declarations (the dense family, as in the reference)
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig, L: int) -> Dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq = cfg.num_heads * hd
    nkv = cfg.num_kv_heads * hd
    p = {
        "norm": ParamDef((L, d), ("layers", None), init="ones"),
        "wq": ParamDef((L, d, nq), ("layers", "embed", "heads")),
        "wk": ParamDef((L, d, nkv), ("layers", "embed", "kv")),
        "wv": ParamDef((L, d, nkv), ("layers", "embed", "kv")),
        "wo": ParamDef((L, nq, d), ("layers", "heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamDef((L, nq), ("layers", "heads"), init="zeros")
        p["bk"] = ParamDef((L, nkv), ("layers", "kv"), init="zeros")
        p["bv"] = ParamDef((L, nkv), ("layers", "kv"), init="zeros")
    return p


def _mlp_defs(cfg: ModelConfig, L: int) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    p = {
        "norm": ParamDef((L, d), ("layers", None), init="ones"),
        "wi": ParamDef((L, d, ff), ("layers", "embed", "mlp")),
        "wo": ParamDef((L, ff, d), ("layers", "mlp", "embed")),
    }
    if cfg.activation != "squared_relu":
        p["wg"] = ParamDef((L, d, ff), ("layers", "embed", "mlp"))
    return p


def build_param_defs(cfg: ModelConfig) -> Dict:
    if cfg.family not in PORTED_FAMILIES:
        raise _not_ported(f"the {cfg.family!r} family")
    d, v = cfg.d_model, cfg.padded_vocab
    L = cfg.num_layers
    return {
        "embed": ParamDef((v, d), ("vocab", "embed")),
        "final_norm": ParamDef((d,), (None,), init="ones"),
        "lm_head": ParamDef((d, v), ("embed", "vocab")),
        "blocks": {"attn": _attn_defs(cfg, L), "mlp": _mlp_defs(cfg, L)},
    }


# ---------------------------------------------------------------------------
# Layer applications (dense family)
# ---------------------------------------------------------------------------

def _proj_qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(b, s, cfg.num_heads, hd),
            k.reshape(b, s, cfg.num_kv_heads, hd),
            v.reshape(b, s, cfg.num_kv_heads, hd))


def _self_attention(cfg: ModelConfig, p: Dict, h: torch.Tensor,
                    positions, segment_ids, mode: str,
                    cache_kv=None, cache_index=None, causal: bool = True):
    """Returns (h_out, (k_cache, v_cache) | prefill kv)."""
    x = rmsnorm(h, p["norm"], cfg.norm_eps)
    q, k, v = _proj_qkv(cfg, p, x)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        ck, cv = update_cache(*cache_kv, k, v, cache_index)
        out = decode_attention(q, ck, cv, cache_index)
        side = (ck, cv)
    else:
        out = chunked_attention(q, k, v, causal=causal,
                                segment_ids=segment_ids,
                                chunk=cfg.attn_chunk)
        side = (k, v)
    b, s = h.shape[:2]
    h = h + out.reshape(b, s, -1) @ p["wo"]
    return h, side


def _mlp(cfg: ModelConfig, p: Dict, h: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(h, p["norm"], cfg.norm_eps)
    u = activation_fn(cfg.activation)(x @ p["wi"])
    if "wg" in p:
        u = u * (x @ p["wg"])
    return h + u @ p["wo"]


def _layer(tree, i: int):
    """The ``i``-th layer's slice of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# The model object
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LM:
    cfg: ModelConfig

    def __post_init__(self):
        self.defs = build_param_defs(self.cfg)

    # ---- parameters ----
    def abstract_params(self):
        return abstract_tree(self.defs)

    def param_axes(self):
        return axes_tree(self.defs)

    def init_params(self, generator: torch.Generator, device=None):
        """Random parameters drawn from ``generator`` (on its own device)
        and placed on ``device`` (default ``cuda``); see
        :func:`~repro_torch.models.common.materialize_tree`."""
        return materialize_tree(self.defs, generator, resolve_device(device))

    # ---- embedding ----
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens]

    # ---- backbone ----
    def _transformer_stack(self, params, h, positions, segment_ids, mode,
                           cache=None, cache_index=None):
        cfg = self.cfg
        ks, vs = [], []
        for i in range(cfg.num_layers):
            p = _layer(params["blocks"], i)
            cache_kv = ((cache["k"][i], cache["v"][i]) if mode == "decode"
                        else None)
            h, (k, v) = _self_attention(cfg, p["attn"], h, positions,
                                        segment_ids, mode, cache_kv=cache_kv,
                                        cache_index=cache_index)
            h = _mlp(cfg, p["mlp"], h)
            ks.append(k)
            vs.append(v)
        if mode == "decode":
            return h, cache                       # updated in place
        return h, {"k": torch.stack(ks), "v": torch.stack(vs)}

    def _backbone(self, params, tokens, positions, segment_ids, mode,
                  cache=None, cache_index=None):
        h = self._embed(params, tokens)
        h, new_cache = self._transformer_stack(
            params, h, positions, segment_ids, mode, cache=cache,
            cache_index=cache_index)
        return rmsnorm(h, params["final_norm"], self.cfg.norm_eps), new_cache

    def loss(self, params, batch):
        raise _not_ported("LM.loss (training)")

    def prefill(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """``batch``: ``tokens`` and ``positions`` (B, S), optional
        ``segment_ids``.  Returns the last position's logits (B, V) and the
        cache ``{"k", "v"}`` of shape (L, B, S, K, D)."""
        h, cache = self._backbone(params, batch["tokens"],
                                  batch["positions"],
                                  batch.get("segment_ids"), "prefill")
        return h[:, -1] @ params["lm_head"], cache

    def decode_step(self, params, cache, tokens, cache_index
                    ) -> Tuple[torch.Tensor, Dict]:
        """One token per row.  ``cache_index``: an int, or (B,) for
        continuous batching where every request slot sits at its own
        sequence position.  The cache is updated **in place** and
        returned."""
        b = tokens.shape[0]
        dev = tokens.device
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 0:
            cache_index = int(cache_index)
        if isinstance(cache_index, int):
            positions = torch.full((b, 1), cache_index, dtype=torch.int32,
                                   device=dev)
        else:
            cache_index = torch.as_tensor(cache_index, device=dev)
            positions = cache_index.reshape(b, 1).to(torch.int32)
        h, cache = self._backbone(params, tokens, positions, None, "decode",
                                  cache=cache, cache_index=cache_index)
        return h[:, -1] @ params["lm_head"], cache

    # ---- cache declaration ----
    def cache_defs(self, batch: int, seq: int) -> Dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, seq, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        axes = ("layers", "batch", "kv_seq", None, None)
        return {"k": ParamDef(shape, axes, dtype=cfg.kv_cache_dtype),
                "v": ParamDef(shape, axes, dtype=cfg.kv_cache_dtype)}

    def init_cache(self, batch: int, seq: int, device=None) -> Dict:
        """A zero cache of :meth:`cache_defs` on ``device`` (default
        ``cuda``)."""
        dev = resolve_device(device)
        return {k: torch.zeros(d.shape, dtype=DTYPES[d.dtype], device=dev)
                for k, d in self.cache_defs(batch, seq).items()}
