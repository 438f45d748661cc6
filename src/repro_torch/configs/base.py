"""Architecture + shape-cell configuration schema.

Every assigned architecture gets one module in this package defining
``CONFIG`` (the exact published dims) and ``reduced()`` (a tiny same-family
config for CPU smoke tests).  The launcher resolves ``--arch <id>`` through
:func:`repro_torch.configs.get_config`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    #                              (| zamba2: PublishedConfig)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    activation: str = "silu"     # silu | squared_relu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False     # llama4-style early-fusion shared
    moe_dense_residual: bool = False    # arctic-style dense+MoE in parallel
    capacity_factor: float = 1.25
    moe_group_size: int = 2048
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    # --- hybrid (zamba2) ---
    attn_every: int = 0                 # shared attn block period
    num_shared_blocks: int = 2          # alternating shared weight sets
    # --- VLM (llama-3.2-vision) ---
    cross_attn_every: int = 0           # cross-attn layer period
    num_image_tokens: int = 1024        # stub frontend output length
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    num_frames: int = 1500              # stub conv-frontend output length
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    remat: str = "full"                 # full | dots | none
    ce_chunk: int = 1024                # cross-entropy sequence chunking
    attn_chunk: int = 512               # q-chunk for chunked attention
    # Unroll layer scans: used by the dry-run analysis compiles so XLA's
    # cost model (which counts a while body once) sees every layer.
    scan_unroll: bool = False
    # Gradient accumulation: microbatches per optimizer step.  Activation
    # transients (SP all-gathers, saved carries, CE chunks) scale with the
    # microbatch, so this is the production memory knob for big train cells.
    grad_accum: int = 1
    # beyond-paper serving/training knobs (see EXPERIMENTS.md §Perf)
    kv_cache_dtype: str = "bfloat16"    # bfloat16 | float8
    grad_accum_dtype: str = "float32"   # float32 | bfloat16

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so embeddings shard on a 16-way model axis."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        attn = d * n_q + 2 * d * n_kv + n_q * d
        if self.activation == "squared_relu":
            mlp = 2 * d * ff
        else:
            mlp = 3 * d * ff                  # gated (SwiGLU)
        total = 2 * v * d                     # embed + head (untied)
        if self.family == "ssm":
            per_layer = self._ssm_params()
            total += self.num_layers * per_layer
        elif self.family == "hybrid":
            per_layer = self._ssm_params()
            total += self.num_layers * per_layer
            shared = attn + mlp
            total += self.num_shared_blocks * shared
        elif self.family == "moe":
            moe = self.num_experts * (3 * d * ff)
            if self.moe_shared_expert:
                moe += 3 * d * ff
            if self.moe_dense_residual:
                moe += 3 * d * ff
            total += self.num_layers * (attn + moe + d * self.num_experts)
        elif self.family == "encdec":
            # embed + untied head (total already = 2*v*d from above);
            # decoder layers carry self- AND cross-attention
            total += self.encoder_layers * (attn + mlp)
            total += self.num_layers * (2 * attn + mlp)
        elif self.family == "vlm":
            total += self.num_layers * (attn + mlp)
            n_cross = self.num_layers // max(self.cross_attn_every, 1)
            total += n_cross * attn
        else:
            total += self.num_layers * (attn + mlp)
        return int(total)

    def _ssm_params(self) -> int:
        d = self.d_model
        in_proj = d * (2 * self.d_inner + 2 * self.ssm_ngroups *
                       self.ssm_state + self.ssm_heads)
        conv = self.conv_dim * self.ssm_conv
        out = self.d_inner * d
        return in_proj + conv + out + 2 * self.ssm_heads

    def active_param_count(self) -> int:
        """MoE: parameters touched per token (for MODEL_FLOPS = 6*N_active*D)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        full_moe = self.num_experts * (3 * d * ff)
        active_moe = self.experts_per_token * (3 * d * ff)
        return int(self.param_count() - self.num_layers *
                   (full_moe - active_moe))


@dataclasses.dataclass(frozen=True)
class PublishedConfig(ModelConfig):
    """A model as published where it departs from the reference's ten
    architectures, whose :class:`ModelConfig` stays equal to the
    reference's field for field.

    * ``tie_embeddings``: the output head is the embedding's transpose
      (any family; ``lm_head`` is then no parameter of its own).
    * family ``zamba2`` (Zyphra's Zamba2 as ``modeling_zamba2.py`` has it):
      ``num_layers`` Mamba2 layers; before each layer in
      ``hybrid_layer_ids`` one application of shared block ``app %
      num_shared_blocks`` over the concatenation of the hidden state and
      the embedding, with a rank-``adapter_rank`` MLP adapter and a
      ``d x d`` linear of the application's own.
    """
    tie_embeddings: bool = False
    hybrid_layer_ids: Tuple[int, ...] = ()
    adapter_rank: int = 0

    def param_count(self) -> int:
        """Every parameter, the head once where it is tied (``zamba2``:
        each leaf counted exactly, norms and biases included)."""
        v, d = self.padded_vocab, self.d_model
        total = (self._zamba2_params() if self.family == "zamba2"
                 else super().param_count())
        return total - v * d if self.tie_embeddings else total

    def _zamba2_params(self) -> int:
        d, ff, h = self.d_model, self.d_ff, self.ssm_heads
        din, conv = self.d_inner, self.conv_dim
        nq = self.num_heads * self.resolved_head_dim
        nkv = self.num_kv_heads * self.resolved_head_dim
        mamba = (d + d * (2 * din + 2 * self.ssm_ngroups * self.ssm_state + h)
                 + (self.ssm_conv + 1) * conv + 3 * h + din + din * d)
        shared = (2 * d + 2 * d * (nq + 2 * nkv) + nq * d    # attention
                  + d + d * 2 * ff + ff * d)                # MLP
        application = d * d + self.adapter_rank * (d + 2 * ff)
        return (2 * self.padded_vocab * d + d + self.num_layers * mamba
                + self.num_shared_blocks * shared
                + len(self.hybrid_layer_ids) * application)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic sequence mixing: SSM/hybrid only.

    (All archs here are decoder-capable, so decode_32k always applies; see
    DESIGN.md §Arch-applicability for the skip rationale.)
    """
    if cell.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("pure full-attention architecture: a 512K KV-cache "
                       "decode is quadratic-history; skipped per spec")
    return True, ""
