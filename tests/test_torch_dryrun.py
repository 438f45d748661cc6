"""The port's ``launch/dryrun.py`` against the reference's, and the dry run
held against itself.

* ``layer_plan``, ``TRAIN_GRAD_ACCUM`` and ``result_path``'s file name
  for every architecture, and the records of the cells that
  ``cell_supported`` skips: equal to the reference's (the reference's
  module, which sets ``XLA_FLAGS`` when imported, runs in its own
  process).
* ``run_cell`` at the reference's small cell
  (``tests/test_sharding.py::test_dryrun_entrypoint_small``: reduced
  qwen2-0.5b, 8 x 64 tokens, train, ``(data 2, model 4)``) on a ``fake``
  group of 8: ``ok``, flops, collective bytes and temp bytes above 0, the
  reference's record keys; ``main`` prints the reference's line.
* For each of the six families (reduced, ``(data 2, model 2)``): the
  1- and 2-unit extrapolation equals the full-depth count, flops and
  collective bytes exactly.
* The ``meta`` count of reduced qwen2-0.5b's train cell at ``(data 1,
  model 1)`` equals the same counter over the real step on the CPU.

Each process group runs in a subprocess under a timeout.
"""
import json

import pytest

from _torch_dist import run_reference, run_script
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun

_REFERENCE = """
import json, os, sys
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch import dryrun
dryrun.RESULTS_DIR = sys.argv[1]
out = {}
for arch in ARCH_IDS:
    o1, o2, units = dryrun.layer_plan(get_config(arch))
    out[arch] = {
        "layer_plan": [o1, o2, units],
        "grad_accum": dryrun.TRAIN_GRAD_ACCUM.get(arch),
        "paths": [os.path.basename(dryrun.result_path(arch, s, mp, tag))
                  for s in SHAPES for mp in (False, True)
                  for tag in ("", "x")],
        "skipped": {s: dryrun.run_cell(arch, s) for s in SHAPES
                    if not dryrun.cell_supported(get_config(arch),
                                                 SHAPES[s])[0]}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    where = tmp_path_factory.mktemp("ref_dryrun")
    return json.loads(run_reference(_REFERENCE, 1, [where],
                                    timeout=300).splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_and_paths_equal_the_reference(arch, reference, tmp_path,
                                             monkeypatch):
    want = reference[arch]
    o1, o2, units = dryrun.layer_plan(get_config(arch))
    assert [o1, o2, units] == want["layer_plan"]
    assert dryrun.TRAIN_GRAD_ACCUM.get(arch) == want["grad_accum"]
    assert [p.split("/")[-1] for p in (
        dryrun.result_path(arch, s, mp, tag) for s in SHAPES
        for mp in (False, True) for tag in ("", "x"))] == want["paths"]
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    skipped = {s: dryrun.run_cell(arch, s) for s in SHAPES
               if s in want["skipped"]}
    assert skipped == want["skipped"]


# the keys of the reference's ok record (``repro.launch.dryrun.run_cell``)
REF_KEYS = {"arch", "shape", "mesh", "tag", "overrides", "rule_overrides",
            "status", "chips", "compile_s", "memory", "params",
            "active_params", "cost_raw", "collectives", "roofline",
            "extrapolation", "total_s"}
REF_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                   "alias_bytes", "peak_bytes_per_device"}

_SMALL_CELL = """
import contextlib, io, json, sys
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

dryrun.RESULTS_DIR = sys.argv[1]
dryrun.get_config = lambda arch: get_config(arch, reduced=True)
dryrun.SHAPES = {**SHAPES, "t": ShapeCell("t", 64, 8, "train")}
dryrun.make_production_mesh = lambda multi_pod=False: make_mesh(
    {"data": 2, "model": 4})
dryrun.fake_group(8)
rec = dryrun.run_cell("qwen2-0.5b", "t")
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    sys.argv[1:] = ["--arch", "qwen2-0.5b", "--shape", "long_500k"]
    dryrun.main()
print(json.dumps({"rec": rec, "printed": printed.getvalue()}))
"""


@pytest.fixture(scope="module")
def small_cell(tmp_path_factory):
    where = tmp_path_factory.mktemp("small_dryrun")
    return json.loads(run_script(_SMALL_CELL, [where],
                                 timeout=180).splitlines()[-1])


def test_run_cell_at_the_reference_small_cell(small_cell):
    rec = small_cell["rec"]
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["cost_raw"]["flops"] > 0
    assert rec["collectives"]["total"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert set(rec) == REF_KEYS
    assert set(rec["memory"]) == REF_MEMORY_KEYS
    assert rec["chips"] == 8
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] == (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])
    # qwen2-0.5b reduced has 2 layers: units 1 and 2
    assert rec["extrapolation"] == {"units": 2, "o1": {"num_layers": 1},
                                    "o2": {"num_layers": 2}}


def test_main_prints_the_reference_line(small_cell, reference):
    """The reference's line for a skipped cell (``main``'s format)."""
    why = reference["qwen2-0.5b"]["skipped"]["long_500k"]["reason"]
    assert small_cell["printed"] == (
        f"[dryrun] qwen2-0.5b               long_500k    16x16    skipped "
        f"({why[:60]})\n")


FAMILIES = ("qwen2-0.5b", "mamba2-2.7b", "zamba2-2.7b",
            "llama4-scout-17b-a16e", "llama-3.2-vision-11b", "whisper-base")

_EXTRAPOLATION = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.axes import sharding_context

dryrun.fake_group(4)
mesh = make_mesh({"data": 2, "model": 2})
cell = ShapeCell("t", 64, 8, "train")
out = {}
for arch in sys.argv[1].split(","):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              **dryrun.analysis_chunks(cell))
    o1, o2, units = dryrun.layer_plan(cfg)
    with sharding_context(mesh) as ctx:
        runs = [dryrun.count_cell(dataclasses.replace(cfg, **o), cell, ctx)
                for o in (o1, o2, {})]
    out[arch] = {"units": units, "runs": runs}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def extrapolations():
    return json.loads(run_script(_EXTRAPOLATION, [",".join(FAMILIES)],
                                 timeout=300).splitlines()[-1])


@pytest.mark.parametrize("arch", FAMILIES)
def test_unit_extrapolation_equals_the_full_depth_count(arch,
                                                        extrapolations):
    units = extrapolations[arch]["units"]
    a, b, full = extrapolations[arch]["runs"]
    assert units == 2 and full["flops"] > 0

    def extrap(x, y):
        return x + (units - 1) * (y - x)

    assert extrap(a["flops"], b["flops"]) == full["flops"]
    assert full["collectives"]["total"] > 0
    for kind, n in full["collectives"].items():
        assert extrap(a["collectives"][kind], b["collectives"][kind]) == n


_META_AND_CPU = """
import json
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LM
from repro_torch.models.specs import train_batch_specs
from repro_torch.optim import adamw_init
from repro_torch.parallel.axes import sharding_context

dryrun.fake_group(1)
mesh = make_mesh({"data": 1, "model": 1})
cfg = get_config("qwen2-0.5b", reduced=True)
cell = ShapeCell("t", 64, 4, "train")
gen = torch.Generator().manual_seed(0)
params = LM(cfg).init_params(gen, device="cpu")
specs, _ = train_batch_specs(cfg, cell)
batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                                 dtype=torch.int32),
         "positions": torch.arange(64, dtype=torch.int32).repeat(4, 1),
         "segment_ids": torch.ones(4, 64, dtype=torch.int32),
         "loss_mask": torch.ones(4, 64)}
batch["targets"] = batch["tokens"].roll(-1, 1)
assert {k: (tuple(x.shape), x.dtype) for k, x in batch.items()} == \\
    {k: (s.shape, s.dtype) for k, s in specs.items()}
with sharding_context(mesh) as ctx:
    meta = dryrun.count_cell(cfg, cell, ctx)
    step, args = dryrun.prepare_cell(cfg, cell, ctx, args=(
        params, adamw_init(params), batch))
    real = dryrun.count_step(step, args)
print(json.dumps({"meta": meta, "cpu": real}))
"""


def test_the_meta_count_equals_the_cpu_count():
    got = json.loads(run_script(_META_AND_CPU,
                                timeout=180).splitlines()[-1])
    assert got["meta"] == got["cpu"]
    assert got["meta"]["flops"] > 0 and got["meta"]["peak_bytes"] > 0


_LIVE_BYTES = """
import json
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.hlo_analysis import local_tensors, storage_key
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LM
from repro_torch.parallel.axes import sharding_context


class Polled(hlo_analysis.CostCounter):
    # beside the counter's live bytes, after every op: the bytes of the
    # storages it saw made that are still alive, polled through weak
    # references to the storages themselves
    def __init__(self, known):
        super().__init__(known)
        self.refs, self.pairs = {}, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for key in list(self._storages):
            if key not in self.refs:
                t = next(t for t in hlo_analysis._tensors(out)
                         if storage_key(t) == key)
                self.refs[key] = (StorageWeakRef(t.untyped_storage()),
                                  t.untyped_storage().nbytes())
        self.refs = {k: r for k, r in self.refs.items() if not r[0].expired()}
        self.pairs.append((self.live, sum(n for _, n in self.refs.values())))
        return out


dryrun.fake_group(1)
mesh = make_mesh({"data": 1, "model": 1})
cfg = get_config("qwen2-0.5b", reduced=True)
cell = ShapeCell("p", 64, 4, "prefill")
params = LM(cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 64),
                                 generator=torch.Generator().manual_seed(1),
                                 dtype=torch.int32),
         "positions": torch.arange(64, dtype=torch.int32).repeat(4, 1)}
with sharding_context(mesh) as ctx:
    # the first count of the process meets DTensor's caches cold
    cold = dryrun.count_cell(cfg, cell, ctx)
    warm = dryrun.count_cell(cfg, cell, ctx)
    step, args = dryrun.prepare_cell(cfg, cell, ctx, args=(params, batch))
    with Polled({storage_key(t) for t in local_tensors(args)}) as polled:
        step(*args)
print(json.dumps({"cold": cold, "warm": warm, "pairs": polled.pairs}))
"""


@pytest.fixture(scope="module")
def live_bytes():
    return json.loads(run_script(_LIVE_BYTES, timeout=180).splitlines()[-1])


def test_a_count_does_not_depend_on_dtensors_caches(live_bytes):
    """DTensor's sharding propagation makes fake tensors of the global
    shapes where its cache misses; none of them is the rank's memory."""
    assert live_bytes["cold"] == live_bytes["warm"]
    assert live_bytes["cold"]["peak_bytes"] > 0


def test_live_bytes_are_the_storages_still_alive(live_bytes):
    """After every op of a real CPU step, the counter's live bytes equal
    the bytes of the storages it saw made that have not been freed."""
    pairs = live_bytes["pairs"]
    assert len(pairs) > 100 and max(live for live, _ in pairs) > 0
    assert all(live == alive for live, alive in pairs)
