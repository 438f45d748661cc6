"""``benchmarks/torch_paper_claims.py`` against the reference's
``benchmarks/paper_claims.py``.

* Each of the nine paper sections (Table II, Figs. 7, 8, 9, 10/11, 12b,
  12c, 13, Table V) run by the port on ``device="cpu"`` gives the
  reference's rows: names, values and derived strings, exact — the gaps
  to the paper included (fig7's 1.35x against the paper's 2.9x).
* The port's ``table2`` and ``fig7`` rows equal the frozen
  ``tests/data/golden_traces.json``.
* The twin of ``tests/test_silicon.py::TestGoldenPreservation``: the
  port's ``EP`` patched to ``EnergyParams.derive(MVEConfig())`` leaves
  those rows byte-identical.
"""
import json
import pathlib

import pytest

from benchmarks import paper_claims as ref_claims
from benchmarks import torch_paper_claims as claims
from repro_torch.core import MVEConfig, cost

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_traces.json"

REFERENCE = {
    "table2": ref_claims.table2_latencies,
    "fig7": ref_claims.fig7_neon,
    "fig8": ref_claims.fig8_gpu,
    "fig9": ref_claims.fig9_gemm_sweep,
    "fig10": ref_claims.fig10_11_rvv,
    "fig12b": ref_claims.fig12b_scaling,
    "fig12c": ref_claims.fig12c_precision,
    "fig13": ref_claims.fig13_schemes,
    "tableV": ref_claims.tableV_area,
}


@pytest.fixture(scope="module")
def reference_rows():
    return {name: [tuple(r) for r in fn()] for name, fn in REFERENCE.items()}


@pytest.fixture(scope="module")
def port_rows():
    return {name: [tuple(r) for r in fn(device="cpu")]
            for name, fn in claims.SECTIONS.items()}


def test_sections_are_the_reference_runners():
    assert list(claims.SECTIONS) == list(REFERENCE)


@pytest.mark.parametrize("section", list(REFERENCE))
def test_section_equals_the_reference(section, reference_rows, port_rows):
    got, want = port_rows[section], reference_rows[section]
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        assert g == w, (g, w)


def test_headline_rows_letter_for_letter(port_rows):
    rows = {name: derived for sec in port_rows.values()
            for name, _, derived in sec}
    assert rows["fig7/average"] == (
        "speedup=1.35x[paper:2.9x];energy=4.27x[paper:8.8x];"
        "idle=0.05[0.40];compute=0.17[0.25];data=0.78[0.35]")
    assert rows["fig8/average"] == "speedup=11.20x[paper:9.3x]"
    assert rows["fig9/crossover"] == \
        "gpu_wins_above_flops=8388608.0[paper:~6.0e6]"
    assert rows["fig10/average"].startswith(
        "speedup=2.66x[paper:2.0x-3.8x];")
    assert rows["fig13/ac"].startswith("mve_vs_rvv=3.74x[paper:2.0x];")
    assert rows["tableV/neon"] == "16.27%[paper:16.321%]"


def _golden_sections(rows):
    return {section: {name: [us, derived] for name, us, derived
                      in rows[section]} for section in ("table2", "fig7")}


def test_table2_and_fig7_equal_the_golden_file(port_rows):
    golden = json.loads(GOLDEN.read_text())
    got = _golden_sections(port_rows)
    for section in ("table2", "fig7"):
        assert golden[section]
        assert got[section] == golden[section], section


def test_goldens_byte_identical_with_derived_energy(monkeypatch):
    """Re-price the frozen claims with *derived* params: the rows match the
    golden file byte for byte."""
    derived = cost.EnergyParams.derive(MVEConfig())
    monkeypatch.setattr(claims, "EP", derived)
    golden = json.loads(GOLDEN.read_text())
    got = _golden_sections({"table2": claims.table2_latencies(device="cpu"),
                            "fig7": claims.fig7_neon(device="cpu")})
    for section in ("table2", "fig7"):
        for name, row in golden[section].items():
            assert got[section][name] == row, name


def test_patched_energy_reaches_the_rows(monkeypatch):
    """``EP`` is what fig7 prices energy with: doubling the Neon SIMD op's
    energy moves the average energy ratio."""
    import dataclasses
    base = {n: d for n, _, d in claims.fig7_neon(device="cpu")}
    monkeypatch.setattr(claims, "EP", dataclasses.replace(
        claims.EP, e_simd_op=2 * claims.EP.e_simd_op))
    moved = {n: d for n, _, d in claims.fig7_neon(device="cpu")}
    assert moved["fig7/average"] != base["fig7/average"]


def test_cuda_without_a_card_raises(monkeypatch):
    """Every section resolves its device first: with no card the default
    ``cuda`` raises instead of running on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in claims.SECTIONS.values():
        with pytest.raises(RuntimeError, match="cuda"):
            fn()
