"""Roofline table generator of the PyTorch port: reads
results/dryrun_torch/*.json (produced by ``python -m
repro_torch.launch.dryrun``) and renders the roofline table — all three
terms in seconds at one H100 SXM's data-sheet rates, the dominant
bottleneck, MODEL_FLOPS / counted FLOPs, and the roofline fraction — and
the dry-run table (both meshes: peak memory, the full-depth run's seconds,
collective bytes).  Twin of ``benchmarks/roofline.py``.

    PYTHONPATH=src python -m benchmarks.torch_roofline [--results DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Tuple

RESULTS_DIR = "results/dryrun_torch"


def load_records(mesh: str = "pod16x16", tag: str = "") -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(RESULTS_DIR, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        want_tag = r.get("tag", "") == tag
        if f"__{mesh}" in os.path.basename(path) and want_tag:
            recs.append(r)
    return recs


def roofline_rows(mesh: str = "pod16x16") -> List[Tuple[str, float, str]]:
    rows = []
    for r in load_records(mesh):
        key = f"roofline/{r['arch']}/{r['shape']}"
        if r["status"] == "skipped":
            rows.append((key, 0.0, "skipped:" + r["reason"][:60]))
            continue
        if r["status"] != "ok" or "roofline" not in r:
            rows.append((key, 0.0, "error:" +
                         r.get("error", "?").splitlines()[0][:60]))
            continue
        rl = r["roofline"]
        bound_us = max(rl["compute_s"], rl["memory_s"],
                       rl["collective_s"]) * 1e6
        rows.append((
            key, bound_us,
            f"dominant={rl['dominant']};"
            f"compute_ms={rl['compute_s']*1e3:.2f};"
            f"memory_ms={rl['memory_s']*1e3:.2f};"
            f"collective_ms={rl['collective_s']*1e3:.2f};"
            f"useful_ratio={rl['useful_flops_ratio']:.3f};"
            f"roofline_frac={rl['roofline_fraction']:.4f};"
            f"peakGB={r['memory']['peak_bytes_per_device']/2**30:.2f}"))
    return rows


def markdown_table(mesh: str = "pod16x16", tag: str = "") -> str:
    recs = load_records(mesh, tag)
    lines = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) |"
        " dominant | useful (6ND/counted) | roofline frac | peak GB/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped | — | — | — |")
            continue
        if r["status"] != "ok" or "roofline" not in r:
            err = r.get("error", "?").splitlines()[0][:40]
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"ERROR: {err} | — | — | — |")
            continue
        rl = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {rl['compute_s']*1e3:.1f} | {rl['memory_s']*1e3:.1f} "
            f"| {rl['collective_s']*1e3:.1f} | {rl['dominant']} "
            f"| {rl['useful_flops_ratio']:.3f} "
            f"| {rl['roofline_fraction']:.4f} "
            f"| {r['memory']['peak_bytes_per_device']/2**30:.2f} |")
    return "\n".join(lines)


def dryrun_table() -> str:
    """§Dry-run: compile proof for both meshes + memory + collectives."""
    lines = [
        "| arch | shape | mesh | status | peak GB/dev | meta run (s) |"
        " collective bytes/dev |",
        "|---|---|---|---|---|---|---|",
    ]
    for mesh in ("pod16x16", "pod2x16x16"):
        for r in load_records(mesh):
            if r["status"] == "ok":
                coll = r.get("collectives",
                             r.get("cost_raw", {}).get("collectives", {}))
                lines.append(
                    f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
                    f"| {r['memory']['peak_bytes_per_device']/2**30:.2f} "
                    f"| {r.get('compile_s', 0):.0f} "
                    f"| {coll.get('total', 0)/2**30:.2f} GiB |")
            else:
                why = (r.get("reason") or
                       r.get("error", "?").splitlines()[0])[:50]
                lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                             f"| {r['status']}: {why} | — | — | — |")
    return "\n".join(lines)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS_DIR,
                    help="directory of the dry run's records")
    RESULTS_DIR = ap.parse_args().results
    print(markdown_table())
    print()
    print(dryrun_table())
