"""Model assembly: the :class:`LM` object of the reference, for all six
families: dense (GQA transformer), MoE, SSM (Mamba2), hybrid (zamba2
shared blocks), vlm (gated cross attention to image embeddings every
``cross_attn_every`` layers) and encdec (whisper: an encoder over audio
frames, a decoder with cross attention to it); and the port's own
``zamba2`` family, Zamba2 as published (:class:`PublishedConfig`; training
only), and a head tied to the embedding for any family.

One :class:`LM` per config exposes

  * ``abstract_params()`` / ``init_params(generator, device)`` (+ logical
    sharding axes, which place them on a mesh),
  * ``loss(params, batch)``     -> (loss, metrics), the training objective,
  * ``prefill(params, batch)``  -> (last-token logits, cache),
  * ``decode_step(params, cache, tokens, cache_index)``,
  * ``cache_defs(batch, seq)``.

Attention in prefill and training — the whisper encoder's, every cross
attention (in decode too, at one query row), and self attention with or
without ``segment_ids`` — runs the hand-written flash kernel where the
head dim allows it (64 or 128: qwen2, llama4-scout, the MoE families, the
vision model, whisper; zamba2's 80 takes the plain chunked route, as in
the reference), and in training its backward kernels.  Packed training
batches carry ``segment_ids``: their self attention runs the segmented
kernels, which visit only the tiles whose documents meet (the reference's
attention turns plain there; ROADMAP, "Deliberate divergences").  The
reference's scanned layer stacks are Python loops over the stacked ``(L,
...)`` parameters; with ``cfg.remat != "none"`` each training layer runs
under non-reentrant ``torch.utils.checkpoint`` where the reference
checkpoints its scan body.
``decode_step`` updates the cache in place: the KV rows and the recurrent
(``ssm``, ``conv``) state alike; the cross caches are only read.

On a mesh with a ``model`` axis the reference's sharding constraints
stand at its sites (``constrain``, and ``constrain_like`` for each layer's
parameter slice), as ``DTensor`` redistributions
(:mod:`repro_torch.parallel.axes`); outside one they are no-ops.

Prefill projects the image embeddings or the encoder output to the cross
K/V once, into the stacked caches it returns, and the cross layers read
them there; the reference projects them twice, in the layer and again for
the cache (ROADMAP.md, "Deliberate divergences").
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import obs
from ..configs.base import ModelConfig, PublishedConfig
from ..core.machine import resolve_device
from ..parallel.axes import (constrain, einsum, matmul, merge_heads,
                             on_model_mesh, settled, unflatten)
from .attention import (chunked_attention, decode_attention,
                        plain_chunked_attention, update_cache)
from .common import (DTYPES, ParamDef, abstract_tree, activation_fn,
                     axes_tree, chunked_cross_entropy, materialize_tree,
                     rmsnorm, rope, sinusoidal_positions)
from .moe import moe_ffn
from .ssm import mamba_block, mamba_mixer

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec", "zamba2")
POSITION_TABLE = 8192          # encdec token positions are clipped into it


def constrain_like(params, axes, skip_leading: int = 1):
    """Each leaf of one layer's parameter slice placed by its logical axes
    (the stacked leaf's, ``skip_leading`` of them dropped), as the
    reference re-asserts them inside its layer scan."""
    if isinstance(params, dict):
        return {k: constrain_like(v, axes[k], skip_leading)
                for k, v in params.items()}
    return constrain(params, *axes[skip_leading:])


# ---------------------------------------------------------------------------
# Parameter declarations (as in the reference)
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig, L: int, gated: bool = False,
               kv_in: Optional[int] = None) -> Dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq = cfg.num_heads * hd
    nkv = cfg.num_kv_heads * hd
    kv_in = kv_in or d
    p = {
        "norm": ParamDef((L, d), ("layers", None), init="ones"),
        "wq": ParamDef((L, d, nq), ("layers", "embed", "heads")),
        "wk": ParamDef((L, kv_in, nkv), ("layers", "embed", "kv")),
        "wv": ParamDef((L, kv_in, nkv), ("layers", "embed", "kv")),
        "wo": ParamDef((L, nq, d), ("layers", "heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamDef((L, nq), ("layers", "heads"), init="zeros")
        p["bk"] = ParamDef((L, nkv), ("layers", "kv"), init="zeros")
        p["bv"] = ParamDef((L, nkv), ("layers", "kv"), init="zeros")
    if gated:
        # tanh(0) = 0: a gated layer adds nothing until its gate is trained
        p["gate"] = ParamDef((L,), ("layers",), init="zeros")
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


def _dense_mlp_defs(cfg: ModelConfig, L: int) -> Dict:
    """Un-stacked-expert dense MLP used as shared expert / dense residual."""
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamDef((L, d, ff), ("layers", "embed", "mlp")),
        "wg": ParamDef((L, d, ff), ("layers", "embed", "mlp")),
        "wo": ParamDef((L, ff, d), ("layers", "mlp", "embed")),
    }


def _moe_defs(cfg: ModelConfig, L: int) -> Dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "norm": ParamDef((L, d), ("layers", None), init="ones"),
        "router": ParamDef((L, d, e), ("layers", "embed", None)),
        "wi": ParamDef((L, e, d, ff), ("layers", "expert", "embed", None)),
        "wg": ParamDef((L, e, d, ff), ("layers", "expert", "embed", None)),
        "wo": ParamDef((L, e, ff, d), ("layers", "expert", None, "embed")),
    }
    if cfg.moe_shared_expert:
        p["shared"] = _dense_mlp_defs(cfg, L)
    if cfg.moe_dense_residual:
        p["dense"] = _dense_mlp_defs(cfg, L)
    return p


def _ssm_defs(cfg: ModelConfig, L: int) -> Dict:
    d = cfg.d_model
    din = cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    h = cfg.ssm_heads
    return {
        "in_norm": ParamDef((L, d), ("layers", None), init="ones"),
        "w_zx": ParamDef((L, d, 2 * din), ("layers", "embed", "ssm_inner")),
        "w_bc": ParamDef((L, d, 2 * gn), ("layers", "embed", None)),
        "w_dt": ParamDef((L, d, h), ("layers", "embed", None)),
        "dt_bias": ParamDef((L, h), ("layers", None), init="zeros"),
        "conv_w": ParamDef((L, cfg.ssm_conv, cfg.conv_dim),
                           ("layers", None, "conv_dim")),
        "conv_b": ParamDef((L, cfg.conv_dim), ("layers", "conv_dim"),
                           init="zeros"),
        "a_log": ParamDef((L, h), ("layers", None), init="ones"),
        "d_skip": ParamDef((L, h), ("layers", None), init="ones"),
        "gate_norm": ParamDef((L, din), ("layers", "ssm_inner"),
                              init="ones"),
        "w_out": ParamDef((L, din, d), ("layers", "ssm_inner", "embed")),
    }


def _zamba2_defs(cfg: PublishedConfig) -> Dict:
    """The shared blocks (``shared``: attention over ``2 d``, its norm, and
    the MLP with gate and up in one ``w_gu``) and each application's own
    linear and MLP adapter (``hybrid``)."""
    d, ff, nb = cfg.d_model, cfg.d_ff, cfg.num_shared_blocks
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    n, r = len(cfg.hybrid_layer_ids), cfg.adapter_rank
    attn = {"norm": ParamDef((nb, 2 * d), ("layers", None), init="ones"),
            "wq": ParamDef((nb, 2 * d, nq), ("layers", "embed", "heads")),
            "wk": ParamDef((nb, 2 * d, nkv), ("layers", "embed", "kv")),
            "wv": ParamDef((nb, 2 * d, nkv), ("layers", "embed", "kv")),
            "wo": ParamDef((nb, nq, d), ("layers", "heads", "embed"))}
    mlp = {"norm": ParamDef((nb, d), ("layers", None), init="ones"),
           "w_gu": ParamDef((nb, d, 2 * ff), ("layers", "embed", "mlp")),
           "wo": ParamDef((nb, ff, d), ("layers", "mlp", "embed"))}
    hybrid = {"linear": ParamDef((n, d, d), ("layers", "embed", None)),
              "adapter_a": ParamDef((n, d, r), ("layers", "embed", None)),
              "adapter_b": ParamDef((n, r, 2 * ff), ("layers", None, "mlp"))}
    return {"blocks": _ssm_defs(cfg, cfg.num_layers),
            "shared": {"attn": attn, "mlp": mlp}, "hybrid": hybrid}


def _tied(cfg: ModelConfig) -> bool:
    """Whether the output head is the embedding's transpose (a
    :class:`PublishedConfig` that says so; the reference's ten are
    untied)."""
    return getattr(cfg, "tie_embeddings", False)


def build_param_defs(cfg: ModelConfig) -> Dict:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    d, v = cfg.d_model, cfg.padded_vocab
    L = cfg.num_layers
    defs = {
        "embed": ParamDef((v, d), ("vocab", "embed")),
        "final_norm": ParamDef((d,), (None,), init="ones"),
    }
    if not _tied(cfg):
        defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"))
    fam = cfg.family
    if fam in ("dense", "vlm"):
        defs["blocks"] = {"attn": _attn_defs(cfg, L),
                          "mlp": _mlp_defs(cfg, L)}
        if fam == "vlm":
            defs["cross"] = _attn_defs(cfg, L // cfg.cross_attn_every,
                                       gated=True)
    elif fam == "moe":
        defs["blocks"] = {"attn": _attn_defs(cfg, L),
                          "moe": _moe_defs(cfg, L)}
    elif fam == "ssm":
        defs["blocks"] = _ssm_defs(cfg, L)
    elif fam == "hybrid":
        defs["blocks"] = _ssm_defs(cfg, L)
        nb = cfg.num_shared_blocks
        defs["shared"] = {"attn": _attn_defs(cfg, nb),
                          "mlp": _mlp_defs(cfg, nb)}
    elif fam == "zamba2":
        defs.update(_zamba2_defs(cfg))
    else:                                               # encdec
        le = cfg.encoder_layers
        defs["enc_blocks"] = {"attn": _attn_defs(cfg, le),
                              "mlp": _mlp_defs(cfg, le)}
        defs["enc_norm"] = ParamDef((d,), (None,), init="ones")
        defs["blocks"] = {"attn": _attn_defs(cfg, L),
                          "cross": _attn_defs(cfg, L),
                          "mlp": _mlp_defs(cfg, L)}
    return defs


# ---------------------------------------------------------------------------
# Layer applications
# ---------------------------------------------------------------------------

def _proj_q(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    q = matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    return unflatten(q, -1, (cfg.num_heads, cfg.resolved_head_dim))


def _proj_qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor):
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    kv = (cfg.num_kv_heads, cfg.resolved_head_dim)
    q = constrain(_proj_q(cfg, p, x), "batch", None, "act_heads", None)
    k = constrain(unflatten(k, -1, kv), "batch", None, None, None)
    return q, k, unflatten(v, -1, kv)


def _self_attention(cfg: ModelConfig, p: Dict, h: torch.Tensor,
                    positions, segment_ids, mode: str,
                    cache_kv=None, cache_index=None, causal: bool = True):
    """Returns (h_out, (k_cache, v_cache) | prefill kv)."""
    x = rmsnorm(h, p["norm"], cfg.norm_eps)
    q, k, v = _proj_qkv(cfg, p, x)
    if cfg.family != "encdec" and positions is not None:
        # whisper's positions are the sinusoidal table added at the embedding
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        ck, cv = update_cache(*cache_kv, k, v, cache_index)
        ck = constrain(ck, "batch", "kv_seq", None, None)
        cv = constrain(cv, "batch", "kv_seq", None, None)
        out = decode_attention(q, ck, cv, cache_index)
        side = (ck, cv)
    else:
        with obs.span("model.attention", device=True, grad=True) as s:
            q, k, v = s.inputs(q, k, v)
            out = s.output(chunked_attention(q, k, v, causal=causal,
                                             segment_ids=segment_ids,
                                             chunk=cfg.attn_chunk))
        side = (k, v)
    h = h + matmul(merge_heads(out), p["wo"])
    return constrain(h, "batch", "seq", None), side


def _cross_attention(cfg: ModelConfig, p: Dict, h: torch.Tensor,
                     cached_kv: Tuple[torch.Tensor, torch.Tensor],
                     gated: bool = False, decode: bool = False
                     ) -> torch.Tensor:
    """Non-causal attention of ``h`` over another sequence (image
    embeddings, the encoder output) whose K/V ``cached_kv`` (each ``(B, T,
    K, D)``) ``_cross_kv_from`` projected.  A gated layer scales its output
    by ``tanh(gate)``.  Outside ``decode`` q and K are placed as the
    reference's projection places them (it reads K/V from the cache
    unplaced in decode)."""
    x = rmsnorm(h, p["norm"], cfg.norm_eps)
    q, (k, v) = _proj_q(cfg, p, x), cached_kv
    if not decode:
        q = constrain(q, "batch", None, "act_heads", None)
        k = constrain(k, "batch", None, None, None)
    with obs.span("model.attention", device=True, grad=True) as s:
        q, k, v = s.inputs(q, k, v)
        out = s.output(chunked_attention(q, k, v, causal=False,
                                         chunk=cfg.attn_chunk))
    delta = matmul(merge_heads(out), p["wo"])
    if gated:
        delta = delta * torch.tanh(p["gate"]).to(delta.dtype)
    return h + delta


def _cross_kv_from(cfg: ModelConfig, p_stack: Dict, src: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked cross K/V caches of every layer of ``p_stack`` over
    ``src`` (B, T, d): each (L, B, T, K, D)."""
    hd = cfg.resolved_head_dim
    k = einsum("btd,ldh->lbth", src, p_stack["wk"])
    v = einsum("btd,ldh->lbth", src, p_stack["wv"])
    if "bk" in p_stack:
        k = k + p_stack["bk"][:, None, None, :]
        v = v + p_stack["bv"][:, None, None, :]
    return (unflatten(k, -1, (cfg.num_kv_heads, hd)),
            unflatten(v, -1, (cfg.num_kv_heads, hd)))


@functools.lru_cache(maxsize=8)
def _position_table(length: int, d: int, device: torch.device
                    ) -> torch.Tensor:
    return sinusoidal_positions(length, d, device=device)


def _in_layer_span(fn, *args):
    """``fn(*args)`` in the ``model.layer`` span: the function that
    :meth:`LM._remat` checkpoints, so that the recompute enters it again
    (as ``model.layer.recompute``, the one that takes device time)."""
    with obs.span("model.layer", device=obs.in_backward()):
        return fn(*args)


def _mlp(cfg: ModelConfig, p: Dict, h: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(h, p["norm"], cfg.norm_eps)
    u = activation_fn(cfg.activation)(matmul(x, p["wi"]))
    if "wg" in p:
        u = u * matmul(x, p["wg"])
    u = constrain(u, "batch", None, "mlp")
    return constrain(h + matmul(u, p["wo"]), "batch", "seq", None)


def _layer(tree, i: int):
    """The ``i``-th layer's slice of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a ``DTensor`` table whose vocab is split over the
    ``model`` axis through ``F.embedding``, each rank's rows of its own
    vocab summed (a whole table keeps the index, whose backward adds the
    gradients of repeated tokens in another order than the embedding's
    on the card)."""
    if isinstance(table, DTensor) and any(p.is_shard()
                                          for p in table.placements):
        return settled(F.embedding(tokens, table))
    return table[tokens]


def _write_state(dst: torch.Tensor, new: torch.Tensor) -> None:
    """``dst.copy_(new)`` in place, for a ``DTensor`` on this rank's part
    of ``dst`` (``new`` placed like it first)."""
    if isinstance(dst, DTensor):
        new = on_model_mesh(new, dst.device_mesh).redistribute(
            dst.device_mesh, dst.placements)
        dst.to_local().copy_(new.to_local())
    else:
        dst.copy_(new)


# remat="dots": the matrix products' outputs are kept, the rest recomputed
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _keep_products():
    return create_selective_checkpoint_contexts(_dots_policy)


# ---------------------------------------------------------------------------
# The model object
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LM:
    cfg: ModelConfig

    def __post_init__(self):
        self.defs = build_param_defs(self.cfg)
        self._axes = axes_tree(self.defs)

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

    # ---- embedding and head ----
    def _head(self, params) -> torch.Tensor:
        """The output head (d, V): ``lm_head``, or tied, the embedding's
        transpose (a view: its gradient joins the lookup's)."""
        return params["embed"].t() if _tied(self.cfg) else params["lm_head"]

    def _embed(self, params, tokens: torch.Tensor,
               positions=None) -> torch.Tensor:
        h = _lookup(params["embed"], tokens)
        if self.cfg.family == "encdec" and positions is not None:
            table = _position_table(POSITION_TABLE, self.cfg.d_model,
                                    tokens.device)
            h = h + table[positions.clamp(0, POSITION_TABLE - 1).long()
                          ].to(h.dtype)
        return constrain(h, "batch", "seq", None)

    # ---- backbones ----
    def _remat(self, fn, *args):
        """``fn(*args)``; in training (autograd recording) with
        ``cfg.remat != "none"`` under non-reentrant
        ``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of
        the layer: ``"full"`` keeps the layer's inputs alone and recomputes
        the rest in the backward, ``"dots"`` keeps the matrix products'
        outputs too (selective checkpointing).  Values never change."""
        remat = self.cfg.remat
        if remat == "none" or not torch.is_grad_enabled():
            return _in_layer_span(fn, *args)
        if remat == "dots":
            return checkpoint(_in_layer_span, fn, *args, use_reentrant=False,
                              context_fn=_keep_products)
        if remat != "full":
            raise ValueError(f"unknown remat {remat!r}")
        return checkpoint(_in_layer_span, fn, *args, use_reentrant=False)

    def _dense_layer(self, p, cross, h, positions, segment_ids, mode,
                     cache_kv, cache_index):
        """One layer of the dense / moe / vlm stack: the gated cross layer
        where ``cross`` = (its parameters, its K/V) is given, self
        attention, then the MLP or the MoE.  Returns (h, the layer's aux
        loss, (k, v))."""
        cfg = self.cfg
        p = constrain_like(p, self._axes["blocks"])
        if cross is not None:
            h = _cross_attention(
                cfg, constrain_like(cross[0], self._axes["cross"]), h,
                cached_kv=cross[1], gated=True, decode=mode == "decode")
        h, kv = _self_attention(cfg, p["attn"], h, positions, segment_ids,
                                mode, cache_kv=cache_kv,
                                cache_index=cache_index)
        if "moe" in p:
            x = rmsnorm(h, p["moe"]["norm"], cfg.norm_eps)
            out, aux = moe_ffn(p["moe"], x, cfg)
            return constrain(h + out, "batch", "seq", None), aux, kv
        return _mlp(cfg, p["mlp"], h), None, kv

    def _transformer_stack(self, params, h, positions, segment_ids, mode,
                           cache=None, cache_index=None, cross_kv=None):
        """dense, moe and vlm.  A vlm applies its gated cross layer
        ``i // every`` before self attention in every layer ``i`` with
        ``i % every == 0``, over ``cross_kv`` (the stacked K/V of the image
        embeddings) or, in decode, the cache's ``cross_k`` / ``cross_v``.
        The MoE aux loss is summed over the layers in fp32, as the
        reference's scan carry."""
        cfg = self.cfg
        every = cfg.cross_attn_every
        if mode == "decode" and every:
            cross_kv = (cache["cross_k"], cache["cross_v"])
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        ks, vs = [], []
        for i in range(cfg.num_layers):
            p = _layer(params["blocks"], i)
            cross = None
            if every and i % every == 0:
                ci = i // every
                cross = (_layer(params["cross"], ci),
                         (cross_kv[0][ci], cross_kv[1][ci]))
            if mode == "train":
                h, a, _ = self._remat(self._dense_layer, p, cross, h,
                                      positions, segment_ids, mode, None,
                                      None)
            else:
                cache_kv = ((cache["k"][i], cache["v"][i])
                            if mode == "decode" else None)
                h, a, (k, v) = self._dense_layer(
                    p, cross, h, positions, segment_ids, mode, cache_kv,
                    cache_index)
                ks.append(k)
                vs.append(v)
            if a is not None:
                aux = aux + a
        if mode == "train":
            return h, aux, None
        if mode == "decode":
            return h, aux, cache                  # updated in place
        return h, aux, {"k": torch.stack(ks), "v": torch.stack(vs)}

    def _mamba_layer(self, params, i: int, h, mode, cache, states):
        """Layer ``i`` of the Mamba2 stack.  Decode reads the layer's
        recurrent state from ``cache`` and writes the new one back in
        place; prefill appends its final state to ``states``; training
        keeps no state (checkpointed by :meth:`_remat`)."""
        p = _layer(params["blocks"], i)
        if mode == "train":
            return self._remat(self._mamba_train, p, h)
        p = constrain_like(p, self._axes["blocks"])
        if mode == "decode":
            h, ns = mamba_block(p, h, self.cfg, state={
                "ssm": cache["ssm"][i], "conv": cache["conv"][i]})
            _write_state(cache["ssm"][i], ns["ssm"])
            _write_state(cache["conv"][i], ns["conv"])
        else:
            h, ns = mamba_block(p, h, self.cfg)
            states.append(ns)
        return constrain(h, "batch", "seq", None)

    def _mamba_train(self, p, h):
        """A Mamba2 layer in training: its output, no recurrent state."""
        p = constrain_like(p, self._axes["blocks"])
        return constrain(mamba_block(p, h, self.cfg)[0], "batch", "seq",
                         None)

    @staticmethod
    def _stacked_states(states) -> Dict:
        return {"ssm": torch.stack([ns["ssm"] for ns in states]),
                "conv": torch.stack([ns["conv"] for ns in states])}

    def _ssm_stack(self, params, h, mode, cache=None):
        states = []
        for i in range(self.cfg.num_layers):
            h = self._mamba_layer(params, i, h, mode, cache, states)
        if mode == "train":
            return h, None
        return h, (cache if mode == "decode" else
                   self._stacked_states(states))

    def _hybrid_stack(self, params, h, positions, segment_ids, mode,
                      cache=None, cache_index=None):
        """``num_layers // attn_every`` groups; each applies a shared
        attention + MLP block (weight set ``group % num_shared_blocks``)
        with its own KV cache, then ``attn_every`` Mamba2 layers (in
        training only those are checkpointed, as in the reference)."""
        cfg = self.cfg
        every = cfg.attn_every
        states, ks, vs = [], [], []
        for gi in range(cfg.num_layers // every):
            sp = constrain_like(
                _layer(params["shared"], gi % cfg.num_shared_blocks),
                self._axes["shared"])
            cache_kv = ((cache["shared_k"][gi], cache["shared_v"][gi])
                        if mode == "decode" else None)
            h, (k, v) = _self_attention(cfg, sp["attn"], h, positions,
                                        segment_ids, mode, cache_kv=cache_kv,
                                        cache_index=cache_index)
            h = _mlp(cfg, sp["mlp"], h)
            ks.append(k)
            vs.append(v)
            for i in range(gi * every, (gi + 1) * every):
                h = self._mamba_layer(params, i, h, mode, cache, states)
        if mode == "train":
            return h, None
        if mode == "decode":
            return h, cache                       # updated in place
        return h, {**self._stacked_states(states),
                   "shared_k": torch.stack(ks), "shared_v": torch.stack(vs)}

    def _zamba2_stack(self, params, h, positions, segment_ids):
        """Zamba2 in training: every layer is a Mamba2 layer; before each
        of ``hybrid_layer_ids`` one application of a shared block gives the
        term ``t`` that that layer's Mamba2 input adds (``h + mamba(norm(h
        + t))``: ``t`` never enters the residual stream).  Each
        application and each Mamba2 layer is checkpointed by
        :meth:`_remat`."""
        cfg = self.cfg
        original = h
        apps = {layer: a for a, layer in enumerate(cfg.hybrid_layer_ids)}
        for i in range(cfg.num_layers):
            t = None
            if i in apps:
                t = self._shared_application(params, apps[i], h, original,
                                             positions, segment_ids)
            h = self._remat(self._zamba2_mamba, _layer(params["blocks"], i),
                            h, t, segment_ids)
        return h

    def _shared_application(self, params, a: int, h, original, positions,
                            segment_ids):
        """Application ``a`` of shared block ``a % num_shared_blocks`` with
        its own adapter and linear, in the ``model.shared`` span: outside
        the checkpoint, so that its ``.backward`` holds the recompute and
        the backward once each."""
        sp = _layer(params["shared"], a % self.cfg.num_shared_blocks)
        ap = _layer(params["hybrid"], a)
        with obs.span("model.shared", device=True, grad=True) as s:
            h, original = s.inputs(h, original)
            return s.output(self._remat(self._zamba2_shared, sp, ap, h,
                                        original, positions, segment_ids))

    def _zamba2_shared(self, sp, ap, h, original, positions, segment_ids):
        """``linear(MLP(norm(attention(norm(concat(h, original))))))`` with
        no residual inside: causal attention over head dim ``2 d / heads``
        at the scale ``(D/2)^-1/2`` (the plain route: no flash instance
        takes that head dim), RoPE over every dim, then the gated MLP whose
        gate and up projections add the application's rank-``r`` adapter,
        with the exact (erf) GELU."""
        cfg = self.cfg
        x = rmsnorm(torch.cat([h, original], dim=-1), sp["attn"]["norm"],
                    cfg.norm_eps)
        q, k, v = _proj_qkv(cfg, sp["attn"], x)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        with obs.span("model.attention", device=True, grad=True) as s:
            q, k, v = s.inputs(q, k, v)
            out = s.output(plain_chunked_attention(
                q, k, v, True, segment_ids, chunk=cfg.attn_chunk,
                scale=(cfg.resolved_head_dim / 2) ** -0.5))
        a = rmsnorm(matmul(merge_heads(out), sp["attn"]["wo"]),
                    sp["mlp"]["norm"], cfg.norm_eps)
        gu = (matmul(a, sp["mlp"]["w_gu"])
              + matmul(matmul(a, ap["adapter_a"]), ap["adapter_b"]))
        gate, up = torch.chunk(gu, 2, dim=-1)
        return matmul(matmul(F.gelu(gate) * up, sp["mlp"]["wo"]),
                      ap["linear"])

    def _zamba2_mamba(self, p, h, t, segment_ids):
        """One Zamba2 Mamba2 layer: ``h + mixer(norm(h + t))``."""
        x = h if t is None else h + t
        out, _ = mamba_mixer(p, rmsnorm(x, p["in_norm"], self.cfg.norm_eps),
                             self.cfg, segment_ids=segment_ids)
        return h + out

    def _encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder: the frames plus the sinusoidal table, then
        ``encoder_layers`` blocks of non-causal self attention (no RoPE)
        and MLP, then ``enc_norm``.  Not checkpointed in training, as the
        reference's encoder scan is not."""
        cfg = self.cfg
        table = _position_table(cfg.num_frames, cfg.d_model, frames.device)
        h = frames + table[None, :frames.shape[1]].to(frames.dtype)
        h = constrain(h, "batch", "seq", None)
        for i in range(cfg.encoder_layers):
            p = constrain_like(_layer(params["enc_blocks"], i),
                               self._axes["enc_blocks"])
            h, _ = _self_attention(cfg, p["attn"], h, None, None, "encode",
                                   causal=False)
            h = _mlp(cfg, p["mlp"], h)
        return rmsnorm(h, params["enc_norm"], cfg.norm_eps)

    def _decoder_layer(self, p, cross_kv, h, positions, mode, cache_kv,
                       cache_index):
        """One whisper decoder layer: causal self attention, cross
        attention over the encoder output's K/V ``cross_kv``, MLP.
        Returns (h, (k, v))."""
        cfg = self.cfg
        p = constrain_like(p, self._axes["blocks"])
        h, kv = _self_attention(cfg, p["attn"], h, positions, None, mode,
                                cache_kv=cache_kv, cache_index=cache_index)
        h = _cross_attention(cfg, p["cross"], h, cached_kv=cross_kv,
                             decode=mode == "decode")
        return _mlp(cfg, p["mlp"], h), kv

    def _encdec_stack(self, params, h, positions, mode, cross_kv=None,
                      cache=None, cache_index=None):
        """Whisper's decoder over the encoder output's K/V (``cross_kv``
        from the encoder, or the cache's ``cross_k`` / ``cross_v`` in
        decode)."""
        cfg = self.cfg
        if mode == "decode":
            cross_kv = (cache["cross_k"], cache["cross_v"])
        ks, vs = [], []
        for i in range(cfg.num_layers):
            p = _layer(params["blocks"], i)
            xkv = (cross_kv[0][i], cross_kv[1][i])
            if mode == "train":
                h, _ = self._remat(self._decoder_layer, p, xkv, h,
                                   positions, mode, None, None)
                continue
            cache_kv = ((cache["k"][i], cache["v"][i]) if mode == "decode"
                        else None)
            h, (k, v) = self._decoder_layer(p, xkv, h, positions, mode,
                                            cache_kv, cache_index)
            ks.append(k)
            vs.append(v)
        if mode == "train":
            return h, None
        if mode == "decode":
            return h, cache                       # updated in place
        return h, {"k": torch.stack(ks), "v": torch.stack(vs)}

    def _backbone(self, params, tokens, positions, segment_ids, mode,
                  cache=None, cache_index=None, image_embeds=None,
                  frames=None):
        """The final-normed hidden states, the MoE aux loss (0 for the
        other families) and the cache (``None`` in training)."""
        cfg = self.cfg
        h = self._embed(params, tokens, positions)
        fam = cfg.family
        cross_kv = None
        if mode != "decode" and fam == "vlm":
            cross_kv = _cross_kv_from(cfg, params["cross"], image_embeds)
        elif mode != "decode" and fam == "encdec":
            cross_kv = _cross_kv_from(cfg, params["blocks"]["cross"],
                                      self._encode(params, frames))
        aux = None
        if fam in ("dense", "moe", "vlm"):
            h, aux, new_cache = self._transformer_stack(
                params, h, positions, segment_ids, mode, cache=cache,
                cache_index=cache_index, cross_kv=cross_kv)
        elif fam == "ssm":
            h, new_cache = self._ssm_stack(params, h, mode, cache)
        elif fam == "hybrid":
            h, new_cache = self._hybrid_stack(
                params, h, positions, segment_ids, mode, cache, cache_index)
        elif fam == "zamba2":
            if mode != "train":
                raise NotImplementedError("the zamba2 family trains only")
            h, new_cache = self._zamba2_stack(params, h, positions,
                                              segment_ids), None
        else:
            h, new_cache = self._encdec_stack(
                params, h, positions, mode, cross_kv=cross_kv, cache=cache,
                cache_index=cache_index)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if cross_kv is not None and mode == "prefill":
            new_cache["cross_k"], new_cache["cross_v"] = cross_kv
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return constrain(h, "batch", "seq", None), aux, new_cache

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """The training objective: the mean masked cross-entropy of the
        next token plus ``0.01`` times the MoE load-balance aux loss, and
        the metrics ``{"ce", "aux", "tokens"}`` (fp32 scalars, not
        detached).  ``batch``: ``tokens``, ``targets``, ``positions``,
        ``loss_mask`` (B, S), optional ``segment_ids``; a vlm's
        ``image_embeds``, an encdec's ``frames``
        (:func:`~repro_torch.models.specs.train_batch_specs`)."""
        cfg = self.cfg
        h, aux, _ = self._backbone(
            params, batch["tokens"], batch["positions"],
            batch.get("segment_ids"), "train",
            image_embeds=batch.get("image_embeds"),
            frames=batch.get("frames"))
        ce, count = chunked_cross_entropy(
            h, self._head(params), batch["targets"], batch["loss_mask"],
            cfg.vocab_size, cfg.ce_chunk)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux, "tokens": count}

    def prefill(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """``batch``: ``tokens`` and ``positions`` (B, S), optional
        ``segment_ids``; a vlm's ``image_embeds`` (B, T, d), an encdec's
        ``frames`` (B, num_frames, d), in the parameters' type
        (:mod:`~repro_torch.models.specs`).  Returns the last position's
        logits (B, V) and the cache: ``{"k", "v"}`` of shape (L, B, S, K,
        D) (dense, moe), with the stacked cross K/V ``{"cross_k",
        "cross_v"}`` (vlm, encdec), the final recurrent state ``{"ssm",
        "conv"}`` per layer (ssm), or both with the shared blocks'
        ``{"shared_k", "shared_v"}`` (hybrid)."""
        h, _, cache = self._backbone(params, batch["tokens"],
                                     batch["positions"],
                                     batch.get("segment_ids"), "prefill",
                                     image_embeds=batch.get("image_embeds"),
                                     frames=batch.get("frames"))
        return h[:, -1] @ self._head(params), cache

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
        h, _, cache = self._backbone(params, tokens, positions, None,
                                     "decode", cache=cache,
                                     cache_index=cache_index)
        logits = constrain(h[:, -1] @ self._head(params), "batch",
                           "act_vocab")
        return logits, cache

    # ---- cache declaration ----
    def cache_defs(self, batch: int, seq: int) -> Dict:
        cfg = self.cfg
        if cfg.family == "zamba2":
            raise NotImplementedError("the zamba2 family trains only")
        hd = cfg.resolved_head_dim if cfg.num_heads else 0

        def kv(n_layers, t=seq):
            shape = (n_layers, batch, t, cfg.num_kv_heads, hd)
            axes = ("layers", "batch", "kv_seq", None, None)
            return {"k": ParamDef(shape, axes, dtype=cfg.kv_cache_dtype),
                    "v": ParamDef(shape, axes, dtype=cfg.kv_cache_dtype)}

        def ssm_states(n_layers):
            return {
                "ssm": ParamDef(
                    (n_layers, batch, cfg.ssm_ngroups,
                     cfg.ssm_heads // cfg.ssm_ngroups,
                     cfg.ssm_headdim, cfg.ssm_state),
                    ("layers", "batch", None, "act_heads", None, None),
                    dtype="float32"),
                "conv": ParamDef(
                    (n_layers, batch, cfg.ssm_conv - 1, cfg.conv_dim),
                    ("layers", "batch", None, "conv_dim")),
            }

        fam = cfg.family
        if fam in ("dense", "moe"):
            return kv(cfg.num_layers)
        if fam in ("vlm", "encdec"):
            c = kv(cfg.num_layers)
            cross = (kv(cfg.num_layers // cfg.cross_attn_every,
                        cfg.num_image_tokens) if fam == "vlm"
                     else kv(cfg.num_layers, cfg.num_frames))
            c["cross_k"], c["cross_v"] = cross["k"], cross["v"]
            return c
        c = ssm_states(cfg.num_layers)
        if fam == "hybrid":
            shared = kv(cfg.num_layers // cfg.attn_every)
            c["shared_k"], c["shared_v"] = shared["k"], shared["v"]
        return c

    @staticmethod
    def clear_slot(cache: Dict, slot: int) -> None:
        """Zero batch row ``slot`` of the cache's recurrent state
        (``ssm``, ``conv``), in place, so a request admitted to the slot
        starts from the zero state a prefill starts from.  KV rows need
        nothing: decode attention masks every position past the row's
        cache index.  The cross rows (``cross_k``, ``cross_v``) are left as
        they are: the engine never fills them, as the reference's does
        not (ROADMAP.md, C10)."""
        for name in ("ssm", "conv"):
            if name in cache:
                cache[name][:, slot].zero_()

    def init_cache(self, batch: int, seq: int, device=None) -> Dict:
        """A zero cache of :meth:`cache_defs` on ``device`` (default
        ``cuda``)."""
        dev = resolve_device(device)
        return {k: torch.zeros(d.shape, dtype=DTYPES[d.dtype], device=dev)
                for k, d in self.cache_defs(batch, seq).items()}
