"""Plain reference for the Qwen2 training cells: the documents
and their packing, and three training steps (loss, gradients, AdamW) in
float32 with TF32 off.

* Data: frozen copies of the synthetic documents and the first-fit packing
  that the training cells feed (document ``i`` of seed ``s`` is fully
  determined by ``(s, i)``), so the packing is worked out again from the
  documents, not read from the program.
* Model: Qwen2's decoder as published (RMSNorm, rotary positions on split
  halves, grouped-query attention with q/k/v biases, a SwiGLU MLP, an
  output head over the padded vocabulary with the padding masked out), the
  mean cross entropy over the loss mask.  Every operation is float32; the
  weights are the seed's (``portbench.lm.draw``), held between steps in the
  configuration's type (bfloat16), as the configuration states them.
  Layers, attention query blocks and loss chunks are recomputed in the
  backward pass, so that the full width fits beside nothing else.
* Optimizer: AdamW with global-norm clipping and the warm-up and cosine
  schedule, written out in float32.

``lower=True`` is the control: every matrix product, forward and
backward, takes operands rounded to float8 (e4m3 forward, e5m2 for
gradients, each scaled per tensor to its largest magnitude), the
precision below the configuration's bfloat16.

Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from portbench import lm

NEG = -1e30
FP8_MAX = 448.0


# ---------------------------------------------------------------------------
# Data: documents and packing
# ---------------------------------------------------------------------------

def doc_length(seed: int, index: int, mean: int, minimum: int) -> int:
    rng = np.random.default_rng((seed, index, 1))
    return max(minimum, int(rng.poisson(mean)))


def document(seed: int, index: int, vocab: int, mean: int,
             minimum: int) -> np.ndarray:
    """Order-1 structure: the next token is a fixed function of the last
    one with probability 0.7, else a random jump."""
    n = doc_length(seed, index, mean, minimum)
    rng = np.random.default_rng((seed, index, 2))
    toks = np.empty(n, dtype=np.int32)
    toks[0] = rng.integers(2, vocab)
    noise = rng.random(n)
    jumps = rng.integers(2, vocab, size=n)
    for t in range(1, n):
        if noise[t] < 0.7:
            toks[t] = (toks[t - 1] * 31 + 17) % (vocab - 2) + 2
        else:
            toks[t] = jumps[t]
    return toks


def pack(docs: Sequence[np.ndarray], seq_len: int):
    """First-fit packing into rows of ``seq_len``: (tokens, segment ids
    (0 = padding), positions within each document)."""
    pieces = [d[s:s + seq_len] for d in docs for s in range(0, len(d), seq_len)]
    rows: List[List[np.ndarray]] = []
    room: List[int] = []
    for piece in pieces:
        for i in range(len(rows)):
            if room[i] >= len(piece):
                rows[i].append(piece)
                room[i] -= len(piece)
                break
        else:
            rows.append([piece])
            room.append(seq_len - len(piece))
    n = len(rows)
    tokens = np.zeros((n, seq_len), dtype=np.int32)
    segs = np.zeros((n, seq_len), dtype=np.int32)
    pos = np.zeros((n, seq_len), dtype=np.int32)
    for i, row in enumerate(rows):
        ofs = 0
        for j, piece in enumerate(row):
            k = len(piece)
            tokens[i, ofs:ofs + k] = piece
            segs[i, ofs:ofs + k] = j + 1
            pos[i, ofs:ofs + k] = np.arange(k)
            ofs += k
    return tokens, segs, pos


def batches(seed: int, vocab: int, seq_len: int, rows: int, mean: int,
            minimum: int) -> Iterator[Dict[str, np.ndarray]]:
    """Packed batches: documents are added until packing gives more than
    ``rows`` rows; the first ``rows`` are the batch and the next batch
    starts from the next document."""
    doc = 0
    while True:
        buf = []
        while True:
            buf.append(document(seed, doc, vocab, mean, minimum))
            doc += 1
            tokens, segs, pos = pack(buf, seq_len + 1)
            if len(tokens) > rows:
                tokens, segs, pos = tokens[:rows], segs[:rows], pos[:rows]
                break
        yield {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
               "loss_mask": (segs[:, 1:] > 0).astype(np.float32),
               "positions": pos[:, :-1], "segment_ids": segs[:, :-1]}


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to a float8 type at a per-tensor scale."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with every product's operands in float8, as float8
    training computes them: e4m3 for the forward operands, e5m2 for the
    gradients in the backward products."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a), _fp8(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g, torch.float8_e5m2)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


class Model:
    def __init__(self, config: dict, lower: bool = False):
        self.c = config
        self.lower = lower
        self.hd = lm.head_dim(config)
        self.eps = config["rms_norm_eps"]

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.lower:
            return _Fp8Matmul.apply(a, b)
        return a @ b

    def norm(self, x, scale):
        return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True)
                               + self.eps) * scale

    def rope(self, x, positions):
        half = self.hd // 2
        freqs = self.c["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = positions[..., None].float() * freqs
        sin, cos = torch.sin(ang)[:, :, None], torch.cos(ang)[:, :, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attend(self, q, k, v, seg, start):
        """One block of queries (B, c, H, D) over all keys (B, S, H, D)."""
        b, c = q.shape[:2]
        s = k.shape[1]
        logits = self.mm(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))
        logits = logits / math.sqrt(self.hd)
        qpos = start + torch.arange(c, device=q.device)
        valid = (qpos[:, None] >= torch.arange(s, device=q.device)[None])
        valid = valid[None, None]
        if seg is not None:
            valid = valid & (seg[:, None, start:start + c, None]
                             == seg[:, None, None, :])
        p = torch.softmax(torch.where(valid, logits, NEG), -1)
        return self.mm(p, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)

    def layer(self, h, p, positions, seg, block):
        c = self.c
        nh, nkv = c["num_attention_heads"], c["num_key_value_heads"]
        b, s, _ = h.shape
        x = self.norm(h, p["attn/norm"])
        q = (self.mm(x, p["attn/wq"]) + p["attn/bq"]).view(b, s, nh, self.hd)
        k = (self.mm(x, p["attn/wk"]) + p["attn/bk"]).view(b, s, nkv, self.hd)
        v = (self.mm(x, p["attn/wv"]) + p["attn/bv"]).view(b, s, nkv, self.hd)
        q, k = self.rope(q, positions), self.rope(k, positions)
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
        outs = [checkpoint(self.attend, q[:, i:i + block], k, v, seg, i,
                           use_reentrant=False)
                for i in range(0, s, block)]
        o = torch.cat(outs, 1).reshape(b, s, nh * self.hd)
        h = h + self.mm(o, p["attn/wo"])
        x = self.norm(h, p["mlp/norm"])
        u = torch.nn.functional.silu(self.mm(x, p["mlp/wi"])) * \
            self.mm(x, p["mlp/wg"])
        return h + self.mm(u, p["mlp/wo"])

    def ce_chunk(self, h, head, t, m):
        logits = self.mm(h, head)
        v = logits.shape[-1]
        logits = torch.where(torch.arange(v, device=h.device)
                             < self.c["vocab_size"], logits, NEG)
        gold = torch.gather(logits, -1, t[..., None]).squeeze(-1)
        return ((torch.logsumexp(logits, -1) - gold) * m).sum()

    def loss(self, w: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
             block: int = 512, chunk: int = 1024) -> torch.Tensor:
        seg = batch.get("segment_ids")
        h = w["embed"][batch["tokens"].long()]
        for i in range(self.c["num_hidden_layers"]):
            p = {k[len("blocks/"):]: x[i] for k, x in w.items()
                 if k.startswith("blocks/")}
            h = checkpoint(self.layer, h, p, batch["positions"], seg, block,
                           use_reentrant=False)
        h = self.norm(h, w["final_norm"])
        mask = batch["loss_mask"]
        total = torch.zeros((), device=h.device)
        for i in range(0, h.shape[1], chunk):
            total = total + checkpoint(
                self.ce_chunk, h[:, i:i + chunk], w["lm_head"],
                batch["targets"][:, i:i + chunk].long(),
                mask[:, i:i + chunk], use_reentrant=False)
        return total / mask.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def learning_rate(opt: dict, step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    progress = (step - opt["warmup_steps"]) / max(
        opt["total_steps"] - opt["warmup_steps"], 1)
    progress = min(max(progress, 0.0), 1.0)
    decay = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (
        1 + math.cos(math.pi * progress))
    return opt["lr"] * decay


@torch.no_grad()
def adamw(opt: dict, step: int, params, grads, m, v):
    """One step in float32; returns the new parameters in their own type."""
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = torch.tensor(learning_rate(opt, step), dtype=torch.float32)
    lr = lr.to(gnorm.device)
    bc1 = 1 - opt["b1"] ** step
    bc2 = 1 - opt["b2"] ** step
    out = {}
    for k, p in params.items():
        g = grads[k] * scale
        m[k] = opt["b1"] * m[k] + (1 - opt["b1"]) * g
        v[k] = opt["b2"] * v[k] + (1 - opt["b2"]) * g * g
        delta = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + opt["eps"])
        delta = delta + opt["weight_decay"] * p.float()
        out[k] = (p.float() - lr * delta).to(p.dtype)
    return out


# ---------------------------------------------------------------------------
# Three steps
# ---------------------------------------------------------------------------

def readings(config: dict, seed: int, batches_: List[Dict[str, np.ndarray]],
             device, lower: bool = False, steps: int = 3) -> dict:
    """The loss of each of ``steps`` steps on ``batches_``, each leaf's
    gradient norm as AdamW takes it in the first step (clipped: its first
    moment over ``1 - b1``), and each leaf's change and second moment's
    norm after the last step.  The starting weights are drawn again for
    the change rather than held beside the state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = config["run"]["optimizer"]
    model = Model(config, lower)
    params = {k: x.clone() for k, x in lm.draw(config, seed, device).items()}
    m = {k: torch.zeros_like(x, dtype=torch.float32) for k, x in params.items()}
    v = {k: torch.zeros_like(x, dtype=torch.float32) for k, x in params.items()}
    losses, grad_norms = [], {}
    for step in range(1, steps + 1):
        batch = {k: torch.as_tensor(x, device=device)
                 for k, x in batches_[step - 1].items()}
        w = {k: x.float().requires_grad_(True) for k, x in params.items()}
        value = model.loss(w, batch)
        grads = torch.autograd.grad(value, list(w.values()))
        grads = dict(zip(w.keys(), grads))
        losses.append(float(value.detach()))
        del w, value
        params = adamw(opt, step, params, grads, m, v)
        del grads
        if step == 1:
            grad_norms = {k: float(torch.linalg.vector_norm(x))
                          / (1 - opt["b1"]) for k, x in m.items()}
    start = lm.draw(config, seed, device)
    change = {k: float(torch.linalg.vector_norm(params[k].float()
                                                - start[k].float()))
              for k in params}
    moment2 = {k: float(torch.linalg.vector_norm(x)) for k, x in v.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "moment2_norms": moment2}
