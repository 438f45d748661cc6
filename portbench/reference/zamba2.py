"""Plain reference for the Zamba2-7B training cell: three training steps
(loss, gradients, AdamW) in float32 with TF32 off, each document run as a
sequence of its own.

Written from Zyphra's Zamba2 as ``transformers``' ``modeling_zamba2.py``
has it, at the configuration's sizes:

* ``original = embed(tokens)``, kept for every hybrid layer.
* Every layer is a Mamba2 layer, ``h + mixer(RMSNorm(h + t))``.  Before
  each of ``hybrid_layer_ids`` (application ``a``) shared block ``a %
  num_mem_blocks`` gives ``t``; elsewhere ``t`` is 0.  ``t`` enters the
  mixer's input only, not the residual stream.
* Shared block, no residual inside: ``x = RMSNorm(concat(h, original))``;
  causal attention over ``attention_head_dim`` with RoPE over every dim and
  logits scaled by ``(head_dim / 2)^-1/2``; ``a = RMSNorm(o_proj(attn))``;
  ``[g, u] = W_gu a + B_a A_a a`` (the application's rank-``adapter_rank``
  adapter); ``t = linear_a(down(gelu(g) * u))`` with the exact (erf) GELU.
* Mixer: one projection to ``z``, ``x``, ``B``, ``C``, ``dt``; a depthwise
  causal conv (``F.conv1d``, kernel ``mamba_d_conv``, bias) and SiLU over
  ``x, B, C``; ``dt = softplus(dt + dt_bias)``; the SSD in its quadratic
  form over the whole sequence, ``y_t = sum_{s <= t} (C_t . B_s)
  exp(A sum_{k=s+1..t} dt_k) dt_s x_s`` with ``A = -exp(A_log)``, each head
  reading its group's ``B`` and ``C``; ``y + D x``; ``y * silu(z)`` normed
  over each of ``mamba_ngroups`` groups (``RMSNormGated``); ``out_proj``.
* ``final_layernorm``, the output head tied to the embedding.

Departures from ``modeling_zamba2.py``:

* Packed rows: each maximal stretch of one segment id (a document, or the
  row's padding) is its own sequence, from position 0, with its own conv
  window and a zero state; the published code has no packing.
* ``dt`` has no floor: ``time_step_limit`` is null, and the published
  CUDA path clamps nothing; its torch path clamps at ``time_step_min``
  (0.001), which ``softplus`` of these weights does not reach.
* The head runs over the vocabulary padded to a multiple of 256 with the
  padding masked out (none at 32,000); the loss is the mean cross entropy
  over the loss mask.
* The parameters are laid out as the port lays them out
  (:mod:`portbench.lm_hybrid`): ``in_proj`` as ``w_zx``, ``w_bc``,
  ``w_dt``; ``gate_up_proj`` as ``w_gu``; each matrix as ``(in, out)``.

Every operation is float32; the weights are the seed's
(``portbench.lm_hybrid.draw``), held between steps in the configuration's
type (bfloat16).  Layers, shared-block applications and loss chunks are
recomputed in the backward pass.  ``lower=True`` is the control: every
matrix product, forward and backward, takes operands in float8, as in
``reference/qwen2.py``, whose packing of the documents and AdamW this file
uses.

Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import lm_hybrid
from portbench.reference import qwen2

NEG = qwen2.NEG
batches = qwen2.batches


class Model(qwen2.Model):
    """``mm`` (float8 operands in the control), ``norm``, ``rope`` over
    split halves and the masked cross entropy of a chunk are Qwen2's."""

    def __init__(self, config: dict, lower: bool = False):
        super().__init__(config, lower)
        self.hd = config["attention_head_dim"]
        self.s = lm_hybrid.sizes(config)
        self.apps = {layer: a for a, layer in
                     enumerate(config["hybrid_layer_ids"])}

    def gated_norm(self, y, scale):
        g = self.s["g"]
        yg = y.view(*y.shape[:-1], g, -1)
        yg = yg * torch.rsqrt(torch.mean(yg * yg, -1, keepdim=True) + self.eps)
        return yg.reshape(y.shape) * scale

    def ssd(self, x, dt, a_log, b, c):
        """x (T, H, P), dt (T, H), b/c (T, G, N) -> y (T, H, P)."""
        t, h, _ = x.shape
        a = (dt * -torch.exp(a_log)).t()                        # (H, T)
        k_after_s = torch.ones(t, t, dtype=torch.bool, device=x.device)
        k_after_s = k_after_s.tril(-1)
        # [h, t, s] = sum over s < k <= t of a[h, k]: a masked running sum
        seg = torch.where(k_after_s, a[:, :, None], 0.0).cumsum(1)
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        decay = torch.where(causal, torch.exp(seg), 0.0)       # (H, T, T)
        cb = self.mm(c.permute(1, 0, 2), b.permute(1, 2, 0))   # (G, T, T)
        cb = cb.repeat_interleave(h // b.shape[1], dim=0)
        xdt = (x * dt[..., None]).permute(1, 0, 2)             # (H, T, P)
        return self.mm(cb * decay, xdt).permute(1, 0, 2)

    def mamba(self, p, h, t):
        """One Mamba2 layer over one sequence ``h`` (T, d)."""
        s = self.s
        length = h.shape[0]
        x = self.norm(h if t is None else h + t, p["in_norm"])
        z, xin = self.mm(x, p["w_zx"]).split(s["din"], dim=-1)
        dt = F.softplus(self.mm(x, p["w_dt"]) + p["dt_bias"])
        u = torch.cat([xin, self.mm(x, p["w_bc"])], dim=-1)      # (T, conv)
        u = F.conv1d(u.t()[None], p["conv_w"].t()[:, None, :], p["conv_b"],
                     padding=s["k"] - 1, groups=s["conv"])[0, :, :length]
        u = F.silu(u.t())
        gn = s["g"] * s["n"]
        xs, b, c = u.split([s["din"], gn, gn], dim=-1)
        xs = xs.reshape(length, s["h"], -1)
        y = self.ssd(xs, dt, p["a_log"], b.reshape(length, s["g"], s["n"]),
                     c.reshape(length, s["g"], s["n"]))
        y = (y + p["d_skip"][:, None] * xs).reshape(length, s["din"])
        y = self.gated_norm(y * F.silu(z), p["gate_norm"])
        return h + self.mm(y, p["w_out"])

    def shared(self, w, a, h, original):
        """Application ``a`` of its shared block over one sequence."""
        blk = {k[len("shared/"):]: x[a % self.s["nb"]]
               for k, x in w.items() if k.startswith("shared/")}
        c = self.c
        nh, nkv = c["num_attention_heads"], c["num_key_value_heads"]
        length = h.shape[0]
        x = self.norm(torch.cat([h, original], dim=-1), blk["attn/norm"])
        q = self.mm(x, blk["attn/wq"]).view(1, length, nh, self.hd)
        k = self.mm(x, blk["attn/wk"]).view(1, length, nkv, self.hd)
        v = self.mm(x, blk["attn/wv"]).view(length, nkv, self.hd)
        positions = torch.arange(length, device=h.device)[None]
        q, k = self.rope(q, positions)[0], self.rope(k, positions)[0]
        k = k.repeat_interleave(nh // nkv, dim=1)
        v = v.repeat_interleave(nh // nkv, dim=1)
        logits = self.mm(q.permute(1, 0, 2), k.permute(1, 2, 0))
        logits = logits * (self.hd / 2) ** -0.5
        causal = torch.ones(length, length, dtype=torch.bool,
                            device=h.device).tril()
        probs = torch.softmax(torch.where(causal, logits, NEG), -1)
        o = self.mm(probs, v.permute(1, 0, 2)).permute(1, 0, 2)
        x = self.norm(self.mm(o.reshape(length, -1), blk["attn/wo"]),
                      blk["mlp/norm"])
        gu = (self.mm(x, blk["mlp/w_gu"])
              + self.mm(self.mm(x, w["hybrid/adapter_a"][a]),
                        w["hybrid/adapter_b"][a]))
        gate, up = gu.chunk(2, dim=-1)
        return self.mm(self.mm(F.gelu(gate) * up, blk["mlp/wo"]),
                       w["hybrid/linear"][a])

    def sequence(self, w, tokens):
        """The final-normed hidden states of one sequence (T,) -> (T, d)."""
        h = original = w["embed"][tokens.long()]
        for i in range(self.c["num_hidden_layers"]):
            p = {k[len("blocks/"):]: x[i] for k, x in w.items()
                 if k.startswith("blocks/")}
            t = None
            if i in self.apps:
                t = checkpoint(self.shared, w, self.apps[i], h, original,
                               use_reentrant=False)
            h = checkpoint(self.mamba, p, h, t, use_reentrant=False)
        return self.norm(h, w["final_norm"])

    def hidden(self, w, batch):
        """(B, S, d): each row's documents (maximal stretches of one
        segment id; the whole row without ids) run alone, side by side."""
        tokens = batch["tokens"]
        seg = batch.get("segment_ids")
        rows = []
        for r in range(tokens.shape[0]):
            edges = [0, tokens.shape[1]]
            if seg is not None:
                ids = seg[r].cpu().numpy()
                edges[1:1] = (np.flatnonzero(ids[1:] != ids[:-1]) + 1).tolist()
            rows.append(torch.cat([self.sequence(w, tokens[r, s0:s1])
                                   for s0, s1 in zip(edges, edges[1:])]))
        return torch.stack(rows)

    def head(self, w):
        return (w["embed"].t() if lm_hybrid.tied(self.c) else w["lm_head"])

    def loss(self, w: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
             chunk: int = 1024) -> torch.Tensor:
        h = self.hidden(w, batch)
        head, mask = self.head(w), batch["loss_mask"]
        total = torch.zeros((), device=h.device)
        for i in range(0, h.shape[1], chunk):
            total = total + checkpoint(
                self.ce_chunk, h[:, i:i + chunk], head,
                batch["targets"][:, i:i + chunk].long(),
                mask[:, i:i + chunk], use_reentrant=False)
        return total / mask.sum().clamp(min=1.0)


def readings(config: dict, seed: int, batches_: List[Dict[str, np.ndarray]],
             device, lower: bool = False, steps: int = 3) -> dict:
    """The loss of each of ``steps`` steps on ``batches_``, each leaf's
    gradient as AdamW takes it in the first step (clipped: its first
    moment over ``1 - b1``), whole on the host under ``grads`` and as its
    norm, and each leaf's change and second moment's norm after the last
    step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = config["run"]["optimizer"]
    model = Model(config, lower)
    params = {k: x.clone()
              for k, x in lm_hybrid.draw(config, seed, device).items()}
    m = {k: torch.zeros_like(x, dtype=torch.float32)
         for k, x in params.items()}
    v = {k: torch.zeros_like(x, dtype=torch.float32)
         for k, x in params.items()}
    losses, grad_norms = [], {}
    for step in range(1, steps + 1):
        batch = {k: torch.as_tensor(x, device=device)
                 for k, x in batches_[step - 1].items()}
        w = {k: x.float().requires_grad_(True) for k, x in params.items()}
        value = model.loss(w, batch)
        grads = dict(zip(w.keys(), torch.autograd.grad(value,
                                                       list(w.values()))))
        losses.append(float(value.detach()))
        del w, value
        params = qwen2.adamw(opt, step, params, grads, m, v)
        del grads
        if step == 1:
            grad_norms = {k: float(torch.linalg.vector_norm(x))
                          / (1 - opt["b1"]) for k, x in m.items()}
            first = {k: (x / (1 - opt["b1"])).cpu() for k, x in m.items()}
    start = lm_hybrid.draw(config, seed, device)
    change = {k: float(torch.linalg.vector_norm(params[k].float()
                                                - start[k].float()))
              for k in params}
    moment2 = {k: float(torch.linalg.vector_norm(x)) for k, x in v.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "moment2_norms": moment2, "grads": first}
