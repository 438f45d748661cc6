"""The port's ``launch/hlo_analysis.py`` against the reference's.

* ``collective_bytes`` (pure text) on the reference's own HLO string
  (``tests/test_sharding.py::test_collective_bytes_parser``) and on seeded
  random HLO texts: the dicts are equal.
* ``Roofline.as_dict`` on seeded inputs, with the reference's three
  hardware constants set on the port's module: equal; the port's own
  constants are the H100 SXM's data-sheet figures.
* ``model_flops`` for every architecture and shape cell: equal.
* ``CostCounter``: the flash operators' flop formulas on the CPU and on
  ``meta``; the peak of live bytes; and, on a ``fake`` process group of 8
  ranks (in a subprocess), a DTensor matmul counted at the rank's local
  product, hand-issued collectives and a DTensor redistribution at their
  result bytes per kind.
"""
import json

import numpy as np
import pytest
import torch

from _torch_dist import run_script
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import hlo_analysis as ref_hlo
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import hlo_analysis

REF_HLO = """
      %all-reduce.1 = f32[1024,8]{1,0} all-reduce(f32[1024,8]{1,0} %x)
      %ag = bf16[16,256]{1,0} all-gather(bf16[2,256]{1,0} %y)
      %t = (f32[128]{0}, f32[64]{0}) all-reduce(%a, %b)
      %rs = f32[32]{0} reduce-scatter(f32[256]{0} %z)
      %fusion.2 = f32[9]{0} fusion(%w), calls=%all_reduce_like
      %cp = u8[100]{0} collective-permute(u8[100]{0} %q)
    """

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute", "fusion", "add", "all-gather-start",
          "all-reduce-start")
_TYPES = ("pred", "s8", "u8", "bf16", "f16", "f32", "s32", "u64", "f64",
          "c64", "c128", "token", "f8e4m3fn")


def _random_hlo(seed: int) -> str:
    """A module of random collective, fusion and elementwise lines: tuple
    results, ``-start`` forms, ``ROOT`` lines, unknown element types and
    scalar shapes."""
    rng = np.random.default_rng(seed)
    lines = ["HloModule m", "ENTRY %main {"]
    for i in range(int(rng.integers(5, 30))):
        def shape():
            dims = rng.integers(1, 300, size=int(rng.integers(0, 4)))
            return (f"{rng.choice(_TYPES)}[{','.join(map(str, dims))}]"
                    "{0}")
        n = int(rng.integers(1, 4))
        result = shape() if n == 1 else \
            "(" + ", ".join(shape() for _ in range(n)) + ")"
        root = "ROOT " if rng.random() < 0.1 else ""
        kind = rng.choice(_KINDS)
        lines.append(f"  {root}%v.{i} = {result} {kind}({shape()} %p{i}), "
                     f"replica_groups={{}}")
    lines.append("}")
    return "\n".join(lines)


@pytest.mark.parametrize("seed", [None] + list(range(12)))
def test_collective_bytes_equals_the_reference(seed):
    text = REF_HLO if seed is None else _random_hlo(seed)
    got = hlo_analysis.collective_bytes(text)
    assert got == ref_hlo.collective_bytes(text)
    if seed is None:                 # the reference's own assertions
        assert got["all-reduce"] == 1024 * 8 * 4 + 128 * 4 + 64 * 4
        assert got["all-gather"] == 16 * 256 * 2
        assert got["reduce-scatter"] == 32 * 4
        assert got["collective-permute"] == 100


def test_the_port_prices_an_h100():
    assert hlo_analysis.PEAK_FLOPS == 989e12
    assert hlo_analysis.HBM_BW == 3.35e12
    assert hlo_analysis.NVLINK_BW == 450e9


@pytest.mark.parametrize("seed", range(8))
def test_roofline_equals_the_reference(seed, monkeypatch):
    monkeypatch.setattr(hlo_analysis, "PEAK_FLOPS", ref_hlo.PEAK_FLOPS)
    monkeypatch.setattr(hlo_analysis, "HBM_BW", ref_hlo.HBM_BW)
    monkeypatch.setattr(hlo_analysis, "NVLINK_BW", ref_hlo.ICI_BW)
    rng = np.random.default_rng(seed)
    args = dict(flops_per_device=float(rng.uniform(1e9, 1e15)),
                bytes_per_device=float(rng.uniform(1e6, 1e13)),
                collective_bytes_per_device=float(rng.uniform(0, 1e12)),
                chips=int(rng.choice([1, 8, 256, 512])),
                model_flops_total=float(rng.uniform(1e12, 1e18)))
    got = hlo_analysis.Roofline(**args)
    want = ref_hlo.Roofline(**args)
    assert got.as_dict() == want.as_dict()
    assert got.bound_s == want.bound_s


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equals_the_reference(arch, shape):
    assert ARCH_IDS == REF_ARCH_IDS and sorted(SHAPES) == sorted(REF_SHAPES)
    assert hlo_analysis.model_flops(get_config(arch), SHAPES[shape]) == \
        ref_hlo.model_flops(ref_get_config(arch), REF_SHAPES[shape])


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("grad", [False, True])
def test_a_flash_call_counts_its_formula(device, grad):
    """torch's ``scaled_dot_product_attention`` convention: 4 B H Sq Sk D
    forward (GQA at the q heads, no causal discount), 2.5 times that
    backward; the plain version's own ops are not counted."""
    b, h, hk, sq, sk, d = 2, 6, 2, 24, 40, 64
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, h, sq, d, generator=gen).to(device)
    k, v = (torch.randn(b, hk, sk, d, generator=gen).to(device)
            for _ in range(2))
    fwd = 4 * b * h * sq * sk * d
    if grad:
        q.requires_grad_()
    with hlo_analysis.CostCounter() as counter:
        out = flash_attention(q, k, v, causal=True)
        if grad:
            out.backward(torch.ones_like(out))
    assert counter.flops == fwd + (fwd * 5 // 2 if grad else 0)
    assert counter.counts()["collectives"]["total"] == 0
    # the operator's inputs and outputs (and ones_like, the backward's)
    assert counter.bytes > 0


def test_peak_of_live_bytes():
    """Storages made under the counter add to the live bytes until their
    last tensor goes; views share their base's storage; a known storage is
    never counted."""
    known = torch.zeros(1000)
    with hlo_analysis.CostCounter(
            {hlo_analysis.storage_key(known)}) as counter:
        a = torch.zeros(100)                     # 400 bytes
        view = a[10:]
        b = torch.ones(50, dtype=torch.float64)  # 400
        del a
        assert counter.live == 800               # ``view`` keeps ``a``'s
        del view
        c = torch.zeros(25)                      # 100
        known.add_(1)
        assert counter.live == 500
        del b, c
    assert counter.live == 0
    assert counter.peak_bytes == 800


_FAKE_GROUP = """
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import CostCounter
from repro_torch.launch.mesh import make_mesh

dryrun.fake_group(8)
mesh = make_mesh({"model": 8})
out = {}
x = DTensor.from_local(torch.empty(256, 1024, device="meta"), mesh,
                       (Replicate(),), run_check=False)
w = DTensor.from_local(torch.empty(1024, 64, device="meta"), mesh,
                       (Shard(1),), run_check=False)
with CostCounter() as c:
    y = x @ w
out["matmul"] = c.counts()
with CostCounter() as c:
    t = torch.empty(16, 8, device="meta")
    dist.all_gather_into_tensor(torch.empty(128, 8, device="meta"), t)
    dist.reduce_scatter_tensor(torch.empty(2, 8, device="meta"), t)
    dist.all_reduce(t)
    z = y.redistribute(mesh, (Replicate(),))
out["collectives"] = c.counts()
out["redistributed"] = list(z.to_local().shape)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_group_counts():
    return json.loads(run_script(_FAKE_GROUP, timeout=120).splitlines()[-1])


def test_a_dtensor_matmul_counts_the_ranks_own_product(fake_group_counts):
    """(256, 1024) @ (1024, 512) with the weight split over 8 ranks: the
    rank's (256, 1024) @ (1024, 64), not the global product (nor both)."""
    got = fake_group_counts["matmul"]
    assert got["flops"] == 2 * 256 * 1024 * 64
    assert got["bytes"] == (256 * 1024 + 1024 * 64 + 256 * 64) * 4
    assert got["collectives"]["total"] == 0


def test_collectives_count_their_result_bytes(fake_group_counts):
    got = fake_group_counts["collectives"]["collectives"]
    assert fake_group_counts["redistributed"] == [256, 512]
    assert got["all-gather"] == 128 * 8 * 4 + 256 * 512 * 4
    assert got["reduce-scatter"] == 2 * 8 * 4
    assert got["all-reduce"] == 16 * 8 * 4
    assert got["all-to-all"] == got["collective-permute"] == 0
    assert got["total"] == sum(got[k] for k in (
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"))
    assert fake_group_counts["collectives"]["flops"] == 0
