"""The Zamba2 configuration (``configs/zamba2-7b.json``): the port's model
config from the file, and weights drawn on the device from the seed.

The weights are drawn as :mod:`portbench.lm` draws the dense model's: one
bfloat16 normal draw for every matrix and embedding, in the port's leaf
order (keys sorted, depth first), scaled by ``initializer_range``; norm
scales, ``a_log`` and ``d_skip`` are 1, ``dt_bias`` and the conv bias 0,
as the port initialises them.  The plain reference lays out the same
draw by the same shapes, from the configuration alone.  The output head is
the embedding (``tie_word_embeddings``, true unless the file says
otherwise), so it has no leaf.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import lm


def sizes(config: dict) -> dict:
    """The published widths under short names."""
    d = config["hidden_size"]
    din = config["mamba_expand"] * d
    g, n = config["mamba_ngroups"], config["mamba_d_state"]
    return dict(d=d, ff=config["intermediate_size"], din=din, g=g, n=n,
                h=din // config["mamba_headdim"], k=config["mamba_d_conv"],
                conv=din + 2 * g * n, v=lm.padded_vocab(config),
                nq=(config["num_attention_heads"]
                    * config["attention_head_dim"]),
                nkv=(config["num_key_value_heads"]
                     * config["attention_head_dim"]),
                L=config["num_hidden_layers"], r=config["adapter_rank"],
                apps=len(config["hybrid_layer_ids"]),
                nb=config["num_mem_blocks"])


def tied(config: dict) -> bool:
    return config.get("tie_word_embeddings", True)


def leaves(config: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(path, shape, init)`` of every parameter, in the port's leaf
    order; ``init`` is ``normal``, ``ones`` or ``zeros``."""
    s = sizes(config)
    d, ff, L, nb, n_app = s["d"], s["ff"], s["L"], s["nb"], s["apps"]
    blocks = {"in_norm": ((L, d), "ones"),
              "w_zx": ((L, d, 2 * s["din"]), "normal"),
              "w_bc": ((L, d, 2 * s["g"] * s["n"]), "normal"),
              "w_dt": ((L, d, s["h"]), "normal"),
              "dt_bias": ((L, s["h"]), "zeros"),
              "conv_w": ((L, s["k"], s["conv"]), "normal"),
              "conv_b": ((L, s["conv"]), "zeros"),
              "a_log": ((L, s["h"]), "ones"), "d_skip": ((L, s["h"]), "ones"),
              "gate_norm": ((L, s["din"]), "ones"),
              "w_out": ((L, s["din"], d), "normal")}
    attn = {"norm": ((nb, 2 * d), "ones"),
            "wq": ((nb, 2 * d, s["nq"]), "normal"),
            "wk": ((nb, 2 * d, s["nkv"]), "normal"),
            "wv": ((nb, 2 * d, s["nkv"]), "normal"),
            "wo": ((nb, s["nq"], d), "normal")}
    mlp = {"norm": ((nb, d), "ones"), "w_gu": ((nb, d, 2 * ff), "normal"),
           "wo": ((nb, ff, d), "normal")}
    hybrid = {"linear": ((n_app, d, d), "normal"),
              "adapter_a": ((n_app, d, s["r"]), "normal"),
              "adapter_b": ((n_app, s["r"], 2 * ff), "normal")}
    tree = {"blocks": blocks, "embed": ((s["v"], d), "normal"),
            "final_norm": ((d,), "ones"), "hybrid": hybrid,
            "shared": {"attn": attn, "mlp": mlp}}
    if not tied(config):
        tree["lm_head"] = ((d, s["v"]), "normal")
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{prefix}/{key}" if prefix else key)
        else:
            out.append((prefix, node[0], node[1]))
    walk(tree, "")
    return out


def draw(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{path: tensor}``: the weights of ``seed``, bfloat16, on
    ``device``; the normal leaves are views of one draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    spec = leaves(config)
    total = sum(_numel(s) for _, s, init in spec if init == "normal")
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.bfloat16)
    flat.mul_(config["initializer_range"])
    out, at = {}, 0
    for path, shape, init in spec:
        if init == "normal":
            out[path] = flat[at:at + _numel(shape)].view(shape)
            at += _numel(shape)
        else:
            fill = torch.ones if init == "ones" else torch.zeros
            out[path] = fill(shape, dtype=torch.bfloat16, device=device)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def model_config(config: dict):
    """The port's ``PublishedConfig`` (family ``zamba2``) for the
    configuration, as it is run."""
    from repro_torch.configs.base import PublishedConfig
    if (config["use_shared_attention_adapter"] or config["add_bias_linear"]
            or not config["use_shared_mlp_adapter"]
            or not config["use_mem_rope"] or config["use_long_context"]):
        raise ValueError("the port's zamba2 family is Zamba2-7B's block: MLP "
                         "adapters, RoPE, no attention adapters, no biases")
    run = config["run"]
    return PublishedConfig(
        name=config["name"], family="zamba2",
        num_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        head_dim=config["attention_head_dim"], activation=config["hidden_act"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=config["rms_norm_eps"], ssm_state=config["mamba_d_state"],
        ssm_headdim=config["mamba_headdim"],
        ssm_expand=config["mamba_expand"], ssm_conv=config["mamba_d_conv"],
        ssm_ngroups=config["mamba_ngroups"], ssm_chunk=config["chunk_size"],
        num_shared_blocks=config["num_mem_blocks"],
        hybrid_layer_ids=tuple(config["hybrid_layer_ids"]),
        adapter_rank=config["adapter_rank"], tie_embeddings=tied(config),
        dtype=run["dtype"], remat=run["remat"],
        attn_chunk=run["attn_chunk"], ce_chunk=run["ce_chunk"])
