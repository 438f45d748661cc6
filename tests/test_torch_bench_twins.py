"""The port's benchmark twins in their quick modes on the CPU, against the
reference's sections (``benchmarks/run.py``'s quick runners).

* Row names equal the reference's in every twin: ``engine``,
  ``frontend``, ``targets``, ``timing``, ``opt``, ``kernels``,
  ``silicon``, ``resilience``.
* The model-derived fields equal the reference's exactly: ``targets`` and
  ``timing`` rows whole (modeled us, cycles, energy, instruction counts,
  stalls, envelopes), ``opt``'s derived column (instruction, cycle and VM
  step counts, the per-pass audit), ``silicon``'s asserted claims,
  ``kernels``' modeled cycles per target, ``resilience``'s fault counters.
  Wall times are the host's and are not compared.
* ``engine``'s memories equal the interpreter's (a corrupted executor
  fails the section); ``resilience`` resolves every ticket.
* ``torch_perf_iterations.CELLS`` equal the reference's; one cell's
  variants run at a reduced size through the port's ``run_cell`` on a
  ``fake`` group, each override visible in its record, and
  ``torch_make_experiments`` renders their ledger.
"""
import ast
import json
import pathlib

import pytest

from benchmarks import run as ref_run
from benchmarks import torch_run

from _torch_dist import run_script

ROOT = pathlib.Path(__file__).resolve().parent.parent
QUICK = ("engine", "frontend", "targets", "timing", "opt", "kernels",
         "silicon", "resilience")
_ROWS = {}


def _rows(section: str):
    """(port rows on the CPU, reference rows), each run once per module;
    the reference's engine section without its persistent XLA cache (an
    empty ``REPRO_MVE_XLA_CACHE`` turns it off)."""
    if section not in _ROWS:
        port = torch_run.QUICK_SECTIONS.get(section,
                                            torch_run.SECTIONS[section])
        ref = ref_run._QUICK_SECTIONS.get(section, ref_run.SECTIONS[section])
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_MVE_XLA_CACHE", "")
            want = [tuple(r) for r in ref()]
        _ROWS[section] = ([tuple(r) for r in port("cpu")], want)
    return _ROWS[section]


def _fields(derived: str) -> dict:
    return dict(kv.split("=", 1) for kv in derived.split(";") if "=" in kv)


@pytest.mark.parametrize("section", QUICK)
def test_row_names_equal_the_reference(section):
    got, want = _rows(section)
    assert [r[0] for r in got] == [r[0] for r in want]


@pytest.mark.parametrize("section", ("targets", "timing"))
def test_priced_rows_equal_the_reference_whole(section):
    got, want = _rows(section)
    assert got == want


def test_opt_derived_column_equals_the_reference():
    got, want = _rows("opt")
    assert [(n, d) for n, _, d in got] == [(n, d) for n, _, d in want]


def test_silicon_claims_equal_the_reference():
    got, want = _rows("silicon")
    for (name, us, derived), (_, rus, rderived) in zip(got, want):
        if name == "silicon/sweep_cache":     # warm_us is a wall time
            g, w = _fields(derived), _fields(rderived)
            del g["warm_us"], w["warm_us"]
            assert g == w
        elif name.startswith("silicon/pareto/"):
            assert derived == rderived, name
        else:                                 # identity and area rows
            assert (us, derived) == (rus, rderived), name


def test_kernels_model_cycles_equal_the_reference():
    got, want = _rows("kernels")
    for (name, _, derived), (_, _, rderived) in zip(got, want):
        if name.startswith("kernels/mve_transpose/"):
            assert derived == rderived, name
    assert dict((n, d) for n, _, d in got)["kernels/mdgather_pallas"] \
        == "plain"


def test_resilience_counters_equal_the_reference():
    got, want = _rows("resilience")
    keys = ("requests", "injected", "retries", "bisections", "recovered",
            "all_resolved")
    for (name, _, derived), (_, _, rderived) in zip(got, want):
        g, w = _fields(derived), _fields(rderived)
        assert {k: g.get(k) for k in keys} == {k: w.get(k) for k in keys}, \
            name


def test_engine_counters_equal_the_reference():
    got, want = _rows("engine")
    g = {n: _fields(d) for n, _, d in got}
    w = {n: _fields(d) for n, _, d in want}
    assert g["interp/sweep_total"] == w["interp/sweep_total"]
    for key in ("programs", "vm_signatures"):
        assert g["vm/compile_sweep"][key] == w["vm/compile_sweep"][key]
    assert g["fused/compile_sweep"]["xla_compiles"] == "0"


def test_engine_fails_on_a_diverging_executor(monkeypatch):
    """The memory equality assert stays: an executor whose result differs
    from the interpreter's fails the section."""
    from benchmarks import torch_engine_bench as engine
    from repro_torch.core.engine import CompiledProgram

    real = CompiledProgram.run

    def corrupt(self, memory, device=None):
        mem, state = real(self, memory, device)
        mem = mem.clone()
        mem.view(-1)[0] += 1
        return mem, state
    monkeypatch.setattr(CompiledProgram, "run", corrupt)
    with pytest.raises(AssertionError, match="interpreter"):
        engine.engine_vs_interp(iters=1, quick=True, device="cpu")


def test_resilience_fails_on_an_unresolved_ticket(monkeypatch):
    from benchmarks import torch_resilience_bench as resilience
    from repro_torch.runtime.scheduler import Ticket

    monkeypatch.setattr(Ticket, "done", lambda self: False)
    with pytest.raises(AssertionError, match="never resolved"):
        resilience.resilience_report(quick=True, device="cpu")


def _reference_cells() -> dict:
    """The reference's ``CELLS`` read from its source: importing that
    module sets ``XLA_FLAGS`` for the whole process."""
    tree = ast.parse((ROOT / "benchmarks" / "perf_iterations.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and node.target.id == "CELLS":
            return ast.literal_eval(node.value)
    raise AssertionError("no CELLS in benchmarks/perf_iterations.py")


def test_perf_cells_equal_the_reference():
    from benchmarks import torch_perf_iterations as perf
    assert perf.CELLS == _reference_cells()


_VARIANTS = """
import json, sys
sys.path.insert(0, sys.argv[2])
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from benchmarks import torch_make_experiments, torch_perf_iterations

dryrun.RESULTS_DIR = sys.argv[1]
dryrun.get_config = lambda arch: get_config(arch, reduced=True)
dryrun.SHAPES = {**SHAPES,
                 "decode_32k": ShapeCell("decode_32k", 64, 8, "decode")}
dryrun.make_production_mesh = lambda multi_pod=False: make_mesh(
    {"data": 2, "model": 4})
dryrun.fake_group(8)
rows = torch_perf_iterations.run_cell_variants("qwen2-72b/decode_32k")
print(json.dumps({"rows": rows, "ledger":
                  torch_make_experiments.perf_ledger(sys.argv[1])}))
"""


def test_a_cell_variants_at_a_reduced_size(tmp_path):
    out = run_script(_VARIANTS, [tmp_path, ROOT], timeout=240)
    got = json.loads(out.splitlines()[-1])
    recs = dict(got["rows"])
    cell = _reference_cells()["qwen2-72b/decode_32k"]
    assert list(recs) == ["baseline"] + [v[0] for v in cell["variants"]]
    for tag, overrides, rules, _ in cell["variants"]:
        rec = recs[tag]
        assert rec["status"] == "ok", rec
        assert rec["tag"] == tag
        assert rec["overrides"] == overrides
        assert rec["rule_overrides"] == {k: list(v)
                                         for k, v in (rules or {}).items()}
        assert rec["roofline"]["memory_s"] > 0
    assert recs["baseline"]["overrides"] == {}
    lines = got["ledger"].splitlines()
    assert [ln.split(" | ")[1] for ln in lines[2:]] == list(recs)
    assert all(ln.startswith("| qwen2-72b/decode_32k@pod16x16 |")
               for ln in lines[2:])
