"""``repro_torch.silicon`` and ``repro_torch.timing`` against the reference.

Silicon: ``EnergyParams.derive(MVEConfig()) == DEFAULT_ENERGY`` byte for
byte, the Table V area (3.56 %), derived constants, sweep records and
autotune fronts equal to the reference's; the records file is the port's
own.  Timing: every row of ``tests/data/timing_goldens.json`` reproduces
through the port's timed targets, hand-built op streams give the
reference's timelines, and every total lies in its ``[lb, ub]`` envelope.
"""
import dataclasses
import json
import pathlib

import pytest

from repro import timing as ref_timing
from repro.core.machine import MVEConfig as RefConfig
from repro.silicon import area as ref_area
from repro.silicon import autotune as ref_autotune
from repro.silicon import params as ref_params
from repro.silicon import sweep as ref_sweep

from repro_torch import targets, timing
from repro_torch.core import MVEConfig, cost
from repro_torch.core.patterns import PATTERNS
from repro_torch.silicon import area, autotune, params, sram, sweep

GOLDEN = pathlib.Path(__file__).parent / "data" / "timing_goldens.json"
SCHEMES = ("bs", "bp", "bh", "ac")
GEOMETRIES = [dict(), dict(num_arrays=16), dict(num_arrays=64, bitlines=512),
              dict(bitlines=128, wordlines=128)]


def test_derive_at_table_iv_is_default_energy_byte_for_byte():
    assert cost.EnergyParams.derive(MVEConfig()) == cost.DEFAULT_ENERGY
    ep, source = params.derived_energy(MVEConfig())
    assert dataclasses.astuple(ep) == dataclasses.astuple(
        cost.DEFAULT_ENERGY)
    assert source.startswith("derived:")


@pytest.mark.parametrize("geometry", range(len(GEOMETRIES)))
def test_derived_constants_equal_the_reference(geometry):
    g = GEOMETRIES[geometry]
    for scheme in SCHEMES:
        ep, src = params.derived_energy(MVEConfig(**g), scheme)
        rep, rsrc = ref_params.derived_energy(RefConfig(**g), scheme)
        assert dataclasses.astuple(ep) == dataclasses.astuple(rep)
        assert src == rsrc
        got = sram.estimate(params.spec_for(MVEConfig(**g)))
        want = ref_params.estimate(ref_params.spec_for(RefConfig(**g)))
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_area_table_v():
    ar = area.area_report()
    assert ar.overhead_pct == pytest.approx(3.56, abs=0.05)
    assert ar.neon_overhead_pct == pytest.approx(16.27, abs=0.1)
    for k, v in area.TABLE_V_MM2_7NM.items():
        assert ar.components[k] == pytest.approx(v, rel=1e-12)
    for g in GEOMETRIES:
        for kw in (dict(), dict(tech_nm=5.0), dict(storage_arrays=32)):
            assert dataclasses.asdict(area.area_report(MVEConfig(**g), **kw)) \
                == dataclasses.asdict(ref_area.area_report(RefConfig(**g),
                                                           **kw))
    bicameral = targets.get_target("mve-bicameral").area_report()
    assert bicameral.overhead_vs_cache_pct < ar.overhead_vs_cache_pct


def test_sweep_records_equal_the_reference(tmp_path):
    grid = [sweep.SweepPoint(scheme=s, num_arrays=na, bitlines=bl)
            for s in ("bs", "ac") for na, bl in ((32, 256), (16, 512))]
    ref_grid = [ref_sweep.SweepPoint(**dataclasses.asdict(p)) for p in grid]
    got = sweep.sweep(grid, cache_path=str(tmp_path / "port.json"))
    want = ref_sweep.sweep(ref_grid, cache_path=str(tmp_path / "ref.json"))
    assert list(got) == list(want)
    for key in got:
        assert dataclasses.asdict(got[key]) == dataclasses.asdict(want[key])
    # a warm load equals the cold records
    assert sweep.sweep(grid, cache_path=str(tmp_path / "port.json")) == got
    doc = json.loads((tmp_path / "port.json").read_text())
    assert doc == json.loads((tmp_path / "ref.json").read_text())


def test_records_file_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_SILICON_CACHE", str(tmp_path / "shared.json"))
    assert sweep.default_cache_path() == ".silicon_records_torch.json"
    assert sweep.default_cache_path() != ref_sweep.default_cache_path()


def test_autotune_equals_the_reference():
    quick = [autotune.Candidate(scheme=s, num_arrays=na, bitlines=bl)
             for s in ("bs", "bp") for na, bl in ((32, 256), (64, 256))]
    ref_quick = [ref_autotune.Candidate(**dataclasses.asdict(c))
                 for c in quick]
    got = autotune.autotune("daxpy", quick)
    want = ref_autotune.autotune("daxpy", ref_quick)
    assert [dataclasses.asdict(p) for p in got.points] == \
        [dataclasses.asdict(p) for p in want.points]
    assert [p.label for p in got.front] == [p.label for p in want.front]
    heavy = autotune.autotune_stream([("daxpy", 5)], quick)
    for lp, hp in zip(got.points, heavy.points):
        assert hp.cycles == pytest.approx(5 * lp.cycles)


# ---------------------------------------------------------------------------
# Timing.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_timing_goldens_reproduce(golden, name):
    """The frozen rows of ``tests/data/timing_goldens.json`` (read, never
    written here), through the port's ``mve-bs-timed`` and ``neon-timed``
    targets on the static trace."""
    run = PATTERNS[name]()
    entry = {}
    for tname, uarch in (("mve-bs-timed", "mve-bs"),
                         ("neon-timed", "mobile-core")):
        tl = targets.compile(run.program, target=tname,
                             device="cpu").timeline()
        assert tl.uarch == uarch
        assert tl.lower_bound <= tl.total_cycles <= tl.upper_bound
        entry[uarch] = {
            "cycles": round(tl.total_cycles, 2),
            "stalls": {k: round(v, 2) for k, v in sorted(tl.stalls.items())},
            "lower_bound": round(tl.lower_bound, 2),
            "upper_bound": round(tl.upper_bound, 2),
        }
    assert entry == golden["patterns"][name]


LAB = dict(fetch_rate=64, decode_latency=0.0, issue_width=8,
           issue_latency=0.0, chaining=False, chain_latency=2.0,
           mem_ports=1, fus={"array": {"pipes": 2}})

# (fu, duration, defs, uses) per op; streams from the reference's
# tests/test_timing.py hazard cases plus mixed ones
STREAMS = {
    "raw": [("array", 10, (1,), ()), ("array", 5, (), (1,))],
    "waw": [("array", 10, (1,), ()), ("array", 3, (1,), ())],
    "war": [("array", 10, (), (1,)), ("array", 1, (1,), ())],
    "ports": [("mem", 7, (1,), ()), ("mem", 7, (2,), ())],
    "structural": [("array", 4, (1,), ()), ("array", 4, (2,), ()),
                   ("array", 4, (3,), ())],
    "mixed": [("mem", 6, (1,), ()), ("array", 9, (2,), (1,)),
              ("array", 3, (1,), (2,)), ("mem", 2, (), (1, 2)),
              ("array", 5, (4,), ()), ("mem", 4, (5,), (4,))],
}


@pytest.mark.parametrize("chaining", [False, True])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_pipeline_streams_equal_the_reference(name, chaining):
    cfg = dict(LAB, chaining=chaining)
    got = timing.simulate_pipeline(
        [timing.TimedOp(fu, float(d), defs=df, uses=u)
         for fu, d, df, u in STREAMS[name]],
        timing.UarchConfig.from_dict("lab", cfg))
    want = ref_timing.simulate_pipeline(
        [ref_timing.TimedOp(fu, float(d), defs=df, uses=u)
         for fu, d, df, u in STREAMS[name]],
        ref_timing.UarchConfig.from_dict("lab", cfg))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.lower_bound <= got.total_cycles <= got.upper_bound


def test_uarch_configs_equal_the_reference():
    assert timing.list_uarchs() == ref_timing.list_uarchs()
    for name in timing.list_uarchs():
        assert dataclasses.asdict(timing.get_uarch(name)) == \
            dataclasses.asdict(ref_timing.get_uarch(name))
