"""The language-model configurations: the port's model config from a
configuration file, and weights drawn on the device from the seed.

Weights are one bfloat16 normal draw for every matrix and embedding (in
the port's leaf order, ``repro_torch.trees.tree_leaves``: keys sorted,
depth first), scaled by the configuration's ``initializer_range``; norm
scales are 1 and biases 0.  The plain reference draws the same numbers
with :func:`draw` and lays them out by the same shapes, from the
configuration alone.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def padded_vocab(config: dict) -> int:
    return -(-config["vocab_size"] // 256) * 256


def head_dim(config: dict) -> int:
    return config.get("head_dim") or (config["hidden_size"]
                                      // config["num_attention_heads"])


def leaves(config: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(path, shape, init)`` of every parameter of the dense model, in
    the port's leaf order; ``init`` is ``normal``, ``ones`` or ``zeros``."""
    d, ff = config["hidden_size"], config["intermediate_size"]
    L, v = config["num_hidden_layers"], padded_vocab(config)
    nq = config["num_attention_heads"] * head_dim(config)
    nkv = config["num_key_value_heads"] * head_dim(config)
    attn = {"norm": ((L, d), "ones"), "wq": ((L, d, nq), "normal"),
            "wk": ((L, d, nkv), "normal"), "wv": ((L, d, nkv), "normal"),
            "wo": ((L, nq, d), "normal"), "bq": ((L, nq), "zeros"),
            "bk": ((L, nkv), "zeros"), "bv": ((L, nkv), "zeros")}
    mlp = {"norm": ((L, d), "ones"), "wi": ((L, d, ff), "normal"),
           "wg": ((L, d, ff), "normal"), "wo": ((L, ff, d), "normal")}
    tree = {"blocks": {"attn": attn, "mlp": mlp},
            "embed": ((v, d), "normal"), "final_norm": ((d,), "ones"),
            "lm_head": ((d, v), "normal")}
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else k)
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
            n = _numel(shape)
            out[path] = flat[at:at + n].view(shape)
            at += n
        elif init == "ones":
            out[path] = torch.ones(shape, dtype=torch.bfloat16, device=device)
        else:
            out[path] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    tree: dict = {}
    for path, x in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return tree


def model_config(config: dict):
    """The port's ``ModelConfig`` for the configuration, as it is run."""
    from repro_torch.configs.base import ModelConfig
    run = config["run"]
    return ModelConfig(
        name=config["name"], family="dense",
        num_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        head_dim=head_dim(config), activation=config["hidden_act"],
        qkv_bias=True, rope_theta=config["rope_theta"],
        norm_eps=config["rms_norm_eps"], dtype=run["dtype"],
        remat=run["remat"], attn_chunk=run["attn_chunk"],
        ce_chunk=run["ce_chunk"])


# ---------------------------------------------------------------------------
# Training batches
# ---------------------------------------------------------------------------

def relabeling(config: dict, seed: int) -> np.ndarray:
    """The seed's relabeling of the vocabulary: ``table[t]`` for each token
    id, ids 0 and 1 (padding) kept, the others permuted.  Every seed packs
    the mix's same documents, so the work of a step (its tokens, padding
    and document lengths) is the same for every seed, and the seed still
    changes what the tokens are."""
    table = np.arange(config["vocab_size"], dtype=np.int32)
    rng = np.random.default_rng(seed)
    table[2:] = 2 + rng.permutation(config["vocab_size"] - 2).astype(np.int32)
    return table


def shape_batch(batch: Dict[str, np.ndarray], traffic: dict,
                table: np.ndarray) -> Dict[str, np.ndarray]:
    """The mix's view of a packed batch: tokens and targets relabeled by
    ``table``; without ``segment_ids`` where the mix concatenates
    documents without isolation, with positions that then run along the
    whole row."""
    keys = ("tokens", "targets", "loss_mask", "positions", "segment_ids")
    out = {k: batch[k] for k in keys}
    out["tokens"] = table[out["tokens"]]
    out["targets"] = table[out["targets"]]
    if not traffic["segment_ids"]:
        del out["segment_ids"]
        rows, seq = out["tokens"].shape
        out["positions"] = np.broadcast_to(
            np.arange(seq, dtype=np.int32), (rows, seq)).copy()
    return out


def data_args(config: dict, traffic: dict) -> dict:
    return dict(vocab=config["vocab_size"], seq_len=traffic["seq_len"],
                rows=traffic["rows"], mean=traffic["mean_doc_len"],
                minimum=traffic["min_doc_len"])


def reference_batches(config: dict, traffic: dict, seed: int, n: int,
                      skip: int = 0):
    """Batches ``skip`` to ``skip + n`` of the reference's packing of the
    mix's documents, as the mix and the seed shape them."""
    from portbench import harness
    ref = harness.reference_module(config)
    feed = ref.batches(traffic["documents_seed"], **data_args(config, traffic))
    table = relabeling(config, seed)
    out = [shape_batch(next(feed), traffic, table) for _ in range(skip + n)]
    return out[skip:]
