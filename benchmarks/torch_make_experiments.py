"""The dry run's tables of the PyTorch/CUDA port from its cached records:
the twin of ``benchmarks/make_experiments.py``.

Prints three markdown sections built from ``results/dryrun_torch/``
(written by ``python -m repro_torch.launch.dryrun`` and
``benchmarks/torch_perf_iterations.py``): the dry-run table (both meshes:
status, peak memory, seconds, collective bytes) and the roofline table
(one H100 SXM's data-sheet rates), both from ``torch_roofline.py``, and
the before/after ledger of the tagged variant records.  The reference
fills a narrative template; the twin prints the tables under their
headings::

    PYTHONPATH=src python -m benchmarks.torch_make_experiments \
        [--results DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import torch_roofline

#: (arch, shape, mesh, tags) of the ledger, as in the reference
LEDGER_CELLS = [
    ("qwen2-72b", "decode_32k", "pod16x16",
     ["", "kv8", "wstationary", "kv8+wstat"]),
    ("granite-34b", "decode_32k", "pod16x16", ["", "kv8+wstat"]),
    ("arctic-480b", "train_4k", "pod16x16",
     ["", "cap10", "bf16accum", "group4k", "composed"]),
    ("arctic-480b", "train_4k", "pod2x16x16",
     ["", "cap10", "bf16accum", "group4k", "composed", "zero-pod",
      "zero-pod-int8opt", "zero-pod-int8-ga8", "zero-pod-fit"]),
    ("whisper-base", "train_4k", "pod16x16",
     ["", "pure-dp", "dp-ce-sharded", "dp-no-remat"]),
    ("mamba2-2.7b", "train_4k", "pod16x16",
     ["", "chunk128", "chunk512"]),
]


def perf_ledger(results_dir: str | None = None) -> str:
    """The before/after table from the tagged records."""
    results_dir = results_dir or torch_roofline.RESULTS_DIR
    lines = [
        "| cell | variant | compute (ms) | memory (ms) | collective (ms) |"
        " bound (ms) | peak GB | Δbound vs baseline |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch, shape, mesh, tags in LEDGER_CELLS:
        base_bound = None
        for tag in tags:
            suffix = f"__{tag}" if tag else ""
            path = os.path.join(results_dir,
                                f"{arch}__{shape}__{mesh}{suffix}.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                r = json.load(f)
            label = tag or "baseline"
            if r.get("status") != "ok" or "roofline" not in r:
                if r.get("status") == "ok":
                    # multi-pod runs carry no analysis; report memory only
                    pk = r["memory"]["peak_bytes_per_device"] / 2**30
                    lines.append(f"| {arch}/{shape}@{mesh} | {label} | — |"
                                 f" — | — | — | {pk:.2f} | — |")
                continue
            rl = r["roofline"]
            bound = max(rl["compute_s"], rl["memory_s"],
                        rl["collective_s"]) * 1e3
            if base_bound is None:
                base_bound = bound
            pk = r["memory"]["peak_bytes_per_device"] / 2**30
            lines.append(
                f"| {arch}/{shape}@{mesh} | {label} "
                f"| {rl['compute_s']*1e3:.2f} | {rl['memory_s']*1e3:.2f} "
                f"| {rl['collective_s']*1e3:.2f} | {bound:.2f} "
                f"| {pk:.2f} | {base_bound/bound:.2f}x |")
    return "\n".join(lines)


def document() -> str:
    return "\n\n".join([
        "## Dry run", torch_roofline.dryrun_table(),
        "## Roofline", torch_roofline.markdown_table("pod16x16"),
        "## Perf", perf_ledger(), ""])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=torch_roofline.RESULTS_DIR,
                    help="directory of the dry run's records")
    torch_roofline.RESULTS_DIR = ap.parse_args().results
    sys.stdout.write(document())


if __name__ == "__main__":
    main()
