"""Shared model components: parameter declaration trees, norms, RoPE,
sinusoidal positions, activations, and the chunked cross-entropy of the
training loss.

Parameters are declared as :class:`ParamDef` leaves of plain nested dicts
carrying *logical* sharding axes (resolved on a mesh by
:mod:`repro_torch.parallel.axes`); ``abstract_tree`` / ``materialize_tree``
turn a declaration into shapes and types or into initialised tensors.

Every bf16 rounding point of the reference is kept where it is: the norm
rounds to the input's type before the scale, RoPE rotates in the model
type.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..parallel.axes import batch_sum, constrain, matmul, settled
from ..trees import tree_leaves, tree_map, tree_unflatten

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "float8": torch.float8_e4m3fn}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | small
    dtype: str = "bfloat16"
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


class ShapeDtype(NamedTuple):
    """The port's ``jax.ShapeDtypeStruct``: what a leaf will be."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def abstract_tree(tree):
    return tree_map(lambda d: ShapeDtype(d.shape, DTYPES[d.dtype]), tree)


def axes_tree(tree):
    return tree_map(lambda d: d.axes, tree)


def materialize_tree(tree, generator: torch.Generator, device=None):
    """Initialised tensors for a declaration tree, drawn leaf by leaf (in
    :func:`tree_leaves` order) from ``generator`` on its own device, then
    placed on ``device`` (default: the generator's).  The numbers are not
    the reference's (``jax.random`` and ``torch.Generator`` differ); tests
    carry the reference's parameters across instead."""
    gen_dev = generator.device
    dev = gen_dev if device is None else torch.device(device)

    def make(d: ParamDef) -> torch.Tensor:
        dt = DTYPES[d.dtype]
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        x = torch.randn(d.shape, generator=generator, device=gen_dev,
                        dtype=torch.float32)
        x.mul_(d.scale * 0.1 if d.init == "small" else d.scale)
        return x.to(device=dev, dtype=dt)

    return tree_unflatten(tree, {path: make(d)
                                 for path, d in tree_leaves(tree)})


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Statistics in float32 (biased variance), the affine step in the
    input's type, as the reference's.  No model of either package calls
    it; it is carried over with the module."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":                      # jax.nn.gelu: tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "squared_relu":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name}")


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, split-halves convention.  x: (B,S,H,D).

    Angles in f32 (position precision); the rotation itself in the model
    type, as the reference does."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs            # (B,S,half)
    sin = torch.sin(angles).to(x.dtype)[:, :, None, :]
    cos = torch.cos(angles).to(x.dtype)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    pos = np.arange(length)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * dim / d)
    table = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.as_tensor(table, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never holds (B, S, V) logits).
# ---------------------------------------------------------------------------

def _ce_chunk(h: torch.Tensor, lm_head: torch.Tensor, t: torch.Tensor,
              m: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The masked CE sum of one sequence chunk: logits in the model type,
    then read as fp32 with the padded vocab entries at ``-1e30``."""
    with obs.span("model.ce", device=True, grad=True) as s:
        h, lm_head = s.inputs(h, lm_head)
        h = constrain(h, "batch", "seq", None)
        logits = constrain(matmul(h, lm_head), "batch", None,
                           "act_vocab").float()
        v = logits.shape[-1]
        vocab_mask = torch.arange(v, device=logits.device) < vocab_size
        logits = torch.where(vocab_mask, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = settled(torch.gather(logits, -1,
                                    t[..., None].long())).squeeze(-1)
        return s.output(((lse - gold) * m).sum())


def chunked_cross_entropy(hidden: torch.Tensor, lm_head: torch.Tensor,
                          targets: torch.Tensor, loss_mask: torch.Tensor,
                          vocab_size: int, chunk: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over the masked tokens and their count, as the reference's:
    the LM-head product runs over sequence chunks of ``chunk`` (the
    sequence zero-padded to a multiple, the pad masked out), so the logits
    held at once are ``(B, chunk, V)``.  Where autograd records, each chunk
    runs under non-reentrant ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): the backward recomputes its logits instead of
    keeping every chunk's fp32 block (at a 151,936-entry vocab, 8 x 1024
    tokens hold 5 GB of them per chunk)."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    pad = -s % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        loss_mask = F.pad(loss_mask, (0, pad))
    mask = loss_mask.float()
    record = torch.is_grad_enabled() and (hidden.requires_grad or
                                          lm_head.requires_grad)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, s + pad, chunk):
        args = (hidden[:, start:start + chunk], lm_head,
                targets[:, start:start + chunk], mask[:, start:start + chunk],
                vocab_size)
        loss_sum = loss_sum + (checkpoint(_ce_chunk, *args,
                                          use_reentrant=False)
                               if record else _ce_chunk(*args))
    # on a mesh, the sum and the count over the whole batch (the
    # reference's one program sees every row)
    count = batch_sum(mask.sum())
    return batch_sum(loss_sum) / torch.clamp(count, min=1.0), count
