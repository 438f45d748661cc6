"""Multi-pod dry run: every (architecture x input shape) cell run once,
abstractly, on the production meshes, with its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

PyTorch has no compiler to ask, so the step itself runs: :func:`main`
starts a ``fake`` process group of 256 ranks (512 with ``--multi-pod``)
in this one process, as rank 0, builds the production mesh on it, places
the cell's abstract arguments on ``meta`` tensors (nothing is allocated,
no collective moves data) and runs ``jitted_cell``'s step once under
:class:`~repro_torch.launch.hlo_analysis.CostCounter`, which counts what
rank 0 dispatches: FLOPs, bytes, collective result bytes and the peak of
live bytes.  A step that runs there proves the cell's placements and
reshapes on that mesh.

Methodology, kept from the reference: flops, bytes and collective bytes
are measured at 1 and 2 layer *units* and extrapolated as
``c1 + (units-1) * (c2 - c1)``, with the attention and cross-entropy
chunks set to the whole sequence and ``grad_accum`` 1 for those runs.
Eager dispatch counts every layer, so the extrapolation equals the
full-depth count of the same configuration.  The peak memory and the
proof come from the full-depth run with production chunking;
``compile_s`` is that run's seconds.

Results are cached as JSON under ``results/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, SHAPES, cell_supported, get_config
from ..optim import AdamWConfig
from ..parallel.axes import (DEFAULT_RULES, model_mesh, place,
                              sharding_context)
from ..trees import tree_map
from . import hlo_analysis
from .hlo_analysis import local_bytes, local_tensors, storage_key
from .mesh import make_production_mesh
from .steps import jitted_cell

RESULTS_DIR = "results/dryrun_torch"

# Gradient accumulation per arch for the train_4k cell: the reference's
# values, chosen for its own accelerator's memory; kept for parity.
TRAIN_GRAD_ACCUM = {
    "qwen2-72b": 4,
    "granite-34b": 4,
    "arctic-480b": 4,
    "nemotron-4-15b": 2,
    "llama4-scout-17b-a16e": 8,
    "llama-3.2-vision-11b": 2,
    "zamba2-2.7b": 4,
}


def result_path(arch: str, shape: str, multi_pod: bool,
                tag: str = "") -> str:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    suffix = f"__{tag}" if tag else ""
    return os.path.join(RESULTS_DIR,
                        f"{arch}__{shape}__{mesh_name}{suffix}.json")


def layer_plan(cfg) -> Tuple[Dict, Dict, int]:
    """(unit-1 overrides, unit-2 overrides, #units) for extrapolation."""
    fam = cfg.family
    if fam == "encdec":
        return ({"num_layers": 1, "encoder_layers": 1},
                {"num_layers": 2, "encoder_layers": 2}, cfg.num_layers)
    if fam == "vlm":
        e = cfg.cross_attn_every
        return ({"num_layers": e}, {"num_layers": 2 * e},
                cfg.num_layers // e)
    if fam == "hybrid":
        e = cfg.attn_every
        return ({"num_layers": e}, {"num_layers": 2 * e},
                cfg.num_layers // e)
    return ({"num_layers": 1}, {"num_layers": 2}, cfg.num_layers)


def analysis_chunks(cell) -> Dict:
    """The unit runs' overrides: per-step totals at ``grad_accum`` 1 (an
    accumulated step does the same work per token)."""
    return {"attn_chunk": cell.seq_len, "ce_chunk": cell.seq_len,
            "scan_unroll": True, "grad_accum": 1}


def on_meta(abstract):
    """``jitted_cell``'s abstract arguments as ``meta`` tensors."""
    return tuple(tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                device="meta"), a)
                 for a in abstract)


def place_args(args, shardings):
    """Each leaf of ``args`` (whole on every rank) that ``shardings``
    (``jitted_cell``'s ``step.arg_shardings``) places as a DTensor of this
    rank's part; the others as they are."""
    return tuple(tree_map(lambda x, w: x if w is None else place(x, w), a, s)
                 for a, s in zip(args, shardings))


def count_step(step, args) -> Dict:
    """One call of ``step(*args)`` under the cost counter: its counts, and
    the memory terms of this rank (``argument``: the arguments' local
    bytes; ``output``: the results'; ``alias``: the results' bytes that
    live in an argument's storage, e.g. a cache written in place;
    ``temp``: the peak of the bytes the step made, less the results it
    made)."""
    known = {storage_key(t) for t in local_tensors(args)}
    with hlo_analysis.CostCounter(known) as counter:
        out = step(*args)
    counts = counter.counts()
    output = local_bytes(out)
    alias = local_bytes([t for t in local_tensors(out)
                         if storage_key(t) in known])
    counts["memory"] = {
        "argument_bytes": local_bytes(args),
        "output_bytes": output,
        "temp_bytes": counts["peak_bytes"] - (output - alias),
        "alias_bytes": alias}
    return counts


def prepare_cell(cfg, cell, ctx, opt_cfg=None, args=None):
    """``(step, args)``: ``jitted_cell``'s step over ``ctx.mesh`` and its
    arguments, placed as ``step.arg_shardings`` places them: ``args`` (each
    leaf whole), or by default ``meta`` tensors of the abstract shapes; a
    decode step at the cache's last position.  The mesh's ``model``
    sub-mesh is made here, once, so that its bookkeeping is not counted as
    the step's."""
    step, abstract = jitted_cell(cfg, cell, ctx, opt_cfg=opt_cfg)
    args = place_args(on_meta(abstract) if args is None else args,
                      step.arg_shardings)
    if cell.kind == "decode":       # the step reads the index on the host
        args = args[:-1] + (cell.seq_len - 1,)
    model_mesh(ctx.mesh)
    return step, args


def count_cell(cfg, cell, ctx, opt_cfg=None) -> Dict:
    """:func:`count_step` of the cell's step on ``meta`` arguments
    (:func:`prepare_cell`)."""
    return count_step(*prepare_cell(cfg, cell, ctx, opt_cfg))


def _run_once(cfg, cell, multi_pod: bool, rules=None, opt_overrides=None):
    mesh = make_production_mesh(multi_pod=multi_pod)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    opt_cfg = AdamWConfig(**opt_overrides) if opt_overrides else None
    with sharding_context(mesh, merged) as ctx:
        counts = count_cell(cfg, cell, ctx, opt_cfg)
    return counts, mesh.size()


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             overrides: Optional[Dict] = None, tag: str = "",
             force: bool = False, analysis: bool = True,
             rule_overrides: Optional[Dict] = None,
             opt_overrides: Optional[Dict] = None) -> Dict:
    """Run one cell abstractly; returns (and caches) the analysis
    record."""
    path = result_path(arch, shape, multi_pod, tag)
    if not force and os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    cell = SHAPES[shape]
    if cell.kind == "train" and arch in TRAIN_GRAD_ACCUM:
        cfg = dataclasses.replace(
            cfg, grad_accum=TRAIN_GRAD_ACCUM[arch])
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    ok, why = cell_supported(cfg, cell)
    rec: Dict = {"arch": arch, "shape": shape,
                 "mesh": "2x16x16" if multi_pod else "16x16", "tag": tag,
                 "overrides": overrides or {},
                 "rule_overrides": {k: list(v) for k, v in
                                    (rule_overrides or {}).items()}}
    if not ok:
        rec.update(status="skipped", reason=why)
        _save(path, rec)
        return rec

    t0 = time.time()
    try:
        # 1) full-depth run: the runnability proof + memory
        full, chips = _run_once(cfg, cell, multi_pod, rules=rule_overrides,
                                opt_overrides=opt_overrides)
        mem = full["memory"]
        t_full = time.time() - t0
        rec.update(
            status="ok", chips=chips, compile_s=round(t_full, 2),
            memory={**mem, "peak_bytes_per_device":
                    mem["argument_bytes"] + mem["output_bytes"] +
                    mem["temp_bytes"] - mem["alias_bytes"]},
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
            cost_raw={"flops": float(full["flops"]),
                      "bytes": float(full["bytes"]),
                      "collectives": full["collectives"]},
        )

        if analysis:
            # 2) unit-extrapolated roofline terms
            o1, o2, units = layer_plan(cfg)
            chunks = analysis_chunks(cell)
            c1 = dataclasses.replace(cfg, **o1, **chunks)
            c2 = dataclasses.replace(cfg, **o2, **chunks)
            a, _ = _run_once(c1, cell, multi_pod, rules=rule_overrides,
                             opt_overrides=opt_overrides)
            b, _ = _run_once(c2, cell, multi_pod, rules=rule_overrides,
                             opt_overrides=opt_overrides)

            def extrap(x, y):
                return x + (units - 1) * (y - x)

            flops = extrap(float(a["flops"]), float(b["flops"]))
            nbytes = extrap(float(a["bytes"]), float(b["bytes"]))
            coll = {k: int(extrap(a["collectives"][k], b["collectives"][k]))
                    for k in a["collectives"]}
            rl = hlo_analysis.Roofline(
                flops_per_device=flops,
                bytes_per_device=nbytes,
                collective_bytes_per_device=float(coll["total"]),
                chips=chips,
                model_flops_total=hlo_analysis.model_flops(cfg, cell),
            )
            rec["collectives"] = coll
            rec["roofline"] = rl.as_dict()
            rec["extrapolation"] = {"units": units, "o1": o1, "o2": o2}
        rec["total_s"] = round(time.time() - t0, 2)
    except Exception as e:                      # record the failure
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    _save(path, rec)
    return rec


def _save(path: str, rec: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def fake_group(world: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks (collectives return at once and move nothing), unless it is
    already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-analysis", action="store_true",
                    help="full-depth run only (multi-pod proof runs)")
    args = ap.parse_args()

    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    try:
        for arch, shape in cells:
            for mp in meshes:
                fake_group(512 if mp else 256)
                # roofline analysis is single-pod only (per spec);
                # multi-pod runs prove the 'pod' axis shards.
                analysis = (not mp) and (not args.no_analysis)
                rec = run_cell(arch, shape, multi_pod=mp, force=args.force,
                               analysis=analysis)
                print(_line(arch, shape, mp, rec), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _line(arch: str, shape: str, mp: bool, rec: Dict) -> str:
    status = rec["status"]
    extra = ""
    if status == "ok" and "roofline" in rec:
        r = rec["roofline"]
        extra = (f" dominant={r['dominant']}"
                 f" compute={r['compute_s']*1e3:.2f}ms"
                 f" memory={r['memory_s']*1e3:.2f}ms"
                 f" coll={r['collective_s']*1e3:.2f}ms"
                 f" useful={r['useful_flops_ratio']:.2f}"
                 f" frac={r['roofline_fraction']:.3f}"
                 f" peakGB="
                 f"{rec['memory']['peak_bytes_per_device']/2**30:.2f}")
    elif status == "ok":
        extra = (f" peakGB="
                 f"{rec['memory']['peak_bytes_per_device']/2**30:.2f}"
                 f" compile={rec['compile_s']:.0f}s")
    elif status == "error":
        extra = " " + rec["error"].splitlines()[0]
    elif status == "skipped":
        extra = " (" + rec["reason"][:60] + ")"
    return (f"[dryrun] {arch:24s} {shape:12s} "
            f"{'2x16x16' if mp else '16x16':8s} {status}{extra}")


if __name__ == "__main__":
    main()
