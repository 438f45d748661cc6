"""Hypothesis -> change -> measure driver over the dry run of the
PyTorch/CUDA port: the twin of ``benchmarks/perf_iterations.py``.

Runs the reference's chosen cells (worst roofline fraction, most
collective-bound, most representative of the paper's serving-side
technique, plus two recipe checks) through the same optimization
variants, each re-run and re-counted by
:func:`repro_torch.launch.dryrun.run_cell`, and prints the before/after
ledger.  A variant is ``ModelConfig`` overrides, sharding-rule overrides
and optimizer overrides, so every row is reproducible.  The dry run needs
no card: this process becomes rank 0 of a ``fake`` process group of 256
ranks (512 with ``--multi-pod``) and counts on ``meta`` tensors.  Records
go to ``results/dryrun_torch/``, tagged with the variant::

    PYTHONPATH=src python -m benchmarks.torch_perf_iterations \
        [--cell NAME] [--multi-pod]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

from repro_torch.launch import dryrun

# variant = (tag, config overrides, rule overrides, hypothesis
#            [, optimizer overrides])
Variant = Tuple[str, Dict, Optional[Dict], str]

CELLS: Dict[str, Dict] = {
    # -- most representative of the paper's technique: serving/decode is
    #    the limited-DLP regime MVE targets --------------------------------
    "qwen2-72b/decode_32k": {
        "arch": "qwen2-72b", "shape": "decode_32k",
        "variants": [
            ("kv8", {"kv_cache_dtype": "float8"}, None,
             "fp8 KV cache halves the dominant cache-read bytes "
             "(memory term ~ -45%) and the cache-resident peak"),
            ("wstationary", {}, {"batch": (), "kv_seq": ("data", "model")},
             "replicate the decode batch, shard the KV sequence over all "
             "256 chips: weight all-gathers (collective term) become tiny "
             "activation all-reduces"),
            ("kv8+wstat", {"kv_cache_dtype": "float8"},
             {"batch": (), "kv_seq": ("data", "model")},
             "compose both wins"),
        ],
    },
    # -- recipe-transfer check: the decode recipe found on qwen2-72b
    #    applied verbatim to the MQA architecture ---------------------------
    "granite-34b/decode_32k": {
        "arch": "granite-34b", "shape": "decode_32k",
        "variants": [
            ("kv8+wstat", {"kv_cache_dtype": "float8"},
             {"batch": (), "kv_seq": ("data", "model")},
             "transfer the qwen2-72b decode recipe unchanged: MQA's "
             "single-KV-head cache is 8x smaller, so the win should come "
             "almost entirely from the weight-stationary collective "
             "collapse"),
        ],
    },
    # -- most collective-bound: 128-expert MoE training -------------------
    "arctic-480b/train_4k": {
        "arch": "arctic-480b", "shape": "train_4k",
        "variants": [
            ("cap10", {"capacity_factor": 1.0}, None,
             "capacity 1.25->1.0 cuts dispatch/combine tensors and the "
             "expert all-to-all volume by 20%"),
            ("bf16accum", {"grad_accum_dtype": "bfloat16"}, None,
             "bf16 gradient accumulators halve the 7.5 GB/device "
             "accumulation state (peak -3.75 GB)"),
            ("group4k", {"moe_group_size": 4096}, None,
             "larger routing groups amortize per-group collectives"),
            ("composed", {"capacity_factor": 1.0,
                          "grad_accum_dtype": "bfloat16",
                          "grad_accum": 2}, None,
             "ga=4 re-gathers all 480B FSDP shards four times per step; "
             "bf16 accumulators buy the memory headroom to drop to ga=2 "
             "and halve the weight-gather collective volume"),
            ("zero-pod", {"grad_accum_dtype": "bfloat16"},
             {"embed": ("pod", "data")},
             "multi-pod only: ZeRO across pods — params/optimizer shard "
             "over 32 ways instead of 16 (the honest fix: 480B training "
             "state does not fit 256 chips with fp32 Adam)"),
            ("zero-pod-int8opt", {"grad_accum_dtype": "bfloat16"},
             {"embed": ("pod", "data")},
             "compose pod-ZeRO with block-quantized int8 Adam moments "
             "(~2 bytes/param instead of 8): optimizer state 7.5 -> "
             "1.9 GB/device — the paper's low-precision lesson applied "
             "to training state", {"state_format": "int8"}),
            ("zero-pod-int8-ga8",
             {"grad_accum_dtype": "bfloat16", "grad_accum": 8,
              "capacity_factor": 1.0},
             {"embed": ("pod", "data")},
             "ga=8 halves the remaining activation/dispatch transients; "
             "with pod-ZeRO + int8 moments the 480B train step should "
             "finally fit 16 GB", {"state_format": "int8"}),
            ("zero-pod-fit",
             {"grad_accum_dtype": "bfloat16", "grad_accum": 8,
              "capacity_factor": 1.0, "attn_chunk": 256,
              "ce_chunk": 512, "moe_group_size": 1024},
             {"embed": ("pod", "data")},
             "smaller attention/CE/MoE working sets shave the last "
             "transients (17.4 -> target <16 GB)",
             {"state_format": "int8"}),
        ],
    },
    # -- bonus: the attention-free arch — SSD chunk size trades the
    #    intra-chunk quadratic term against state-passing ------------------
    "mamba2-2.7b/train_4k": {
        "arch": "mamba2-2.7b", "shape": "train_4k",
        "variants": [
            ("chunk128", {"ssm_chunk": 128}, None,
             "SSD L-matrix traffic scales with chunk length "
             "(b,c,h,cs,cs): halving the chunk halves the dominant "
             "memory term's score share, at 2x the inter-chunk scan "
             "steps (cheap)"),
            ("chunk512", {"ssm_chunk": 512}, None,
             "counter-test: doubling the chunk should inflate the "
             "memory term"),
        ],
    },
    # -- worst roofline fraction among train cells: tiny model
    #    over-sharded on a 256-chip pod ------------------------------------
    "whisper-base/train_4k": {
        "arch": "whisper-base", "shape": "train_4k",
        "variants": [
            ("pure-dp",
             {},
             {"heads": (), "kv": (), "mlp": (), "vocab": (), "embed": (),
              "ssm_inner": (), "conv_dim": (), "seq": (),
              "act_heads": (), "act_vocab": (),
              "batch": ("pod", "data", "model")},
             "an 80M model has no business being tensor-parallel 16-way: "
             "replicate weights, run pure DP with batch over all 256 "
             "chips; collective term collapses to one gradient "
             "all-reduce"),
            ("dp-ce-sharded",
             {},
             {"heads": (), "kv": (), "mlp": (), "embed": (), "seq": (),
              "act_heads": (),
              "batch": ("pod", "data", "model")},
             "pure DP but keep the vocab/CE dimension sharded (vocab "
             "51865 is the only big axis left)"),
            ("dp-no-remat",
             {"remat": "none"},
             {"heads": (), "kv": (), "mlp": (), "embed": (), "seq": (),
              "act_heads": (),
              "batch": ("pod", "data", "model")},
             "an 80M model's activations fit easily at 1 example/device: "
             "drop per-layer remat, eliminating the recomputed forward "
             "(memory term ~ -35%, compute ~ -25%)"),
        ],
    },
}


def _fmt(rec: Dict) -> str:
    if rec.get("status") != "ok" or "roofline" not in rec:
        return rec.get("status", "?") + ":" + \
            rec.get("error", rec.get("reason", ""))[:70]
    r = rec["roofline"]
    return (f"compute={r['compute_s']*1e3:9.2f}ms "
            f"memory={r['memory_s']*1e3:9.2f}ms "
            f"coll={r['collective_s']*1e3:9.2f}ms "
            f"dom={r['dominant']:10s} "
            f"frac={r['roofline_fraction']:.4f} "
            f"peakGB={rec['memory']['peak_bytes_per_device']/2**30:6.2f}")


def run_cell_variants(name: str, force: bool = False,
                      multi_pod: bool = False) -> List[Tuple[str, Dict]]:
    """The cell's baseline and each of its variants through
    ``dryrun.run_cell`` (the ``zero-pod*`` variants only with
    ``multi_pod``); the caller has started the process group."""
    spec = CELLS[name]
    rows = []
    base = dryrun.run_cell(spec["arch"], spec["shape"], force=force,
                           multi_pod=multi_pod)
    rows.append(("baseline", base))
    print(f"[perf] {name:28s} baseline     {_fmt(base)}", flush=True)
    for variant in spec["variants"]:
        tag, overrides, rules, hypothesis = variant[:4]
        opt_overrides = variant[4] if len(variant) > 4 else None
        if tag.startswith("zero-pod") and not multi_pod:
            continue
        rec = dryrun.run_cell(spec["arch"], spec["shape"], tag=tag,
                              overrides=overrides, rule_overrides=rules,
                              force=force, multi_pod=multi_pod,
                              opt_overrides=opt_overrides)
        rows.append((tag, rec))
        print(f"[perf] {name:28s} {tag:12s} {_fmt(rec)}", flush=True)
        print(f"       hypothesis: {hypothesis}", flush=True)
    return rows


def main() -> None:
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(CELLS), default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    cells = [args.cell] if args.cell else sorted(CELLS)
    dryrun.fake_group(512 if args.multi_pod else 256)
    try:
        for c in cells:
            run_cell_variants(c, force=args.force, multi_pod=args.multi_pod)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
