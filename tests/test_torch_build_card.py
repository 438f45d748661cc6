"""The CUDA sources build for ``sm_90a`` (skipped without a card).

Every ``src/repro_torch/kernels/csrc/*.cu`` is built by ``nvcc`` (one
process per source, started together, ``kernels/_build.py``) and loads;
``ptxas`` (``-Xptxas -v``, the build's ``<name>.log``) shows no spill in
any instance of the flash and SSD kernels; ``cuobjdump --dump-sass``
finds the tensor cores' matrix instructions in each kernel that must run
on them.

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_build_card.py
"""
import re
import subprocess
from pathlib import Path

import pytest

from repro_torch.kernels import _build

from _torch_card import require_card

pytestmark = pytest.mark.card

# (source, kernel: a substring of the mangled names) that must not spill
NO_SPILLS = [("flash_attention", "flash_fwd_mma_kernel"),
             ("flash_attention", "flash_fwd_tf32_kernel"),
             ("flash_attention", "flash_seg_tiles_kernel"),
             ("flash_attention_bwd", "flash_bwd_delta_kernel"),
             ("flash_attention_bwd", "flash_bwd_dkdv_mma_kernel"),
             ("flash_attention_bwd", "flash_bwd_gqa_sum_kernel"),
             ("flash_attention_bwd", "flash_bwd_dq_mma_kernel"),
             ("flash_attention_bwd", "flash_bwd_dkdv_tf32_kernel"),
             ("flash_attention_bwd", "flash_bwd_dq_tf32_kernel"),
             ("ssd_chunk", "ssd_fwd_kernel"),
             ("ssd_chunk", "ssd_bwd_dx_kernel"),
             ("ssd_chunk", "ssd_bwd_ds_kernel"),
             ("ssd_chunk", "ssd_gather_kernel"),
             ("ssd_chunk", "ssd_apply_kernel"),
             ("ssd_chunk", "ssd_cross_kernel")]
# the kernels that must run on the tensor cores (a substring of their
# mangled names: bitplane_gemm_kernel<true> is int8_matmul's instance,
# <false> bitplane_matmul's), and the SASS mnemonic of their matrix
# instructions (the float32 flash kernels': HMMA.1688.F32.TF32)
TENSOR_CORE_KERNELS = {"flash_fwd_mma_kernel": "HMMA",
                       "flash_bwd_dkdv_mma_kernel": "HMMA",
                       "flash_bwd_dq_mma_kernel": "HMMA",
                       "flash_fwd_tf32_kernel": "TF32",
                       "flash_bwd_dkdv_tf32_kernel": "TF32",
                       "flash_bwd_dq_tf32_kernel": "TF32",
                       "bitplane_gemm_kernelILb1E": "IMMA",
                       "bitplane_gemm_kernelILb0E": "IMMA"}


@pytest.fixture(scope="module")
def libs():
    """``{source: its library}``, every source built and loaded."""
    require_card()
    libs = _build.build_all()
    for name in libs:
        _build.load(name)
    return libs


def ptxas_usage(log: str) -> dict:
    """``{kernel: "registers ...; spills ..."}`` from ``nvcc -Xptxas -v``
    output."""
    usage, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            usage[fn] = []
        elif fn and ("spill" in line or "registers" in line):
            usage[fn].append(line.split(":", 1)[-1].strip())
    return {fn: "; ".join(parts) for fn, parts in usage.items()}


@pytest.fixture(scope="module")
def sass_counts(libs) -> dict:
    """HMMA / IMMA instructions (and the TF32 ones among the HMMA) per
    kernel in the built libraries' SASS (``cuobjdump``, beside ``nvcc`` in
    the CUDA toolkit)."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    counts = {}
    for path in libs.values():
        sass = subprocess.run([str(tool), "--dump-sass", str(path)],
                              check=True, capture_output=True, text=True,
                              timeout=300).stdout
        for block in sass.split("Function : ")[1:]:
            fn = block.split(None, 1)[0]
            counts[fn] = {op: block.count(op) for op in ("HMMA", "IMMA")}
            counts[fn]["TF32"] = block.count(".TF32")
    return counts


def test_every_source_builds_and_loads(libs):
    assert sorted(libs) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert all(path.exists() for path in libs.values())


@pytest.mark.parametrize("source,kernel", NO_SPILLS,
                         ids=[kernel for _, kernel in NO_SPILLS])
def test_kernel_does_not_spill(libs, source, kernel):
    usage = ptxas_usage((_build.BUILD_DIR / f"{source}.log").read_text())
    mine = {fn: u for fn, u in usage.items() if kernel in fn}
    assert mine, f"{kernel}: no instance in the ptxas log"
    for fn, u in mine.items():
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", u)
        assert spill is not None and not any(
            int(x) for x in spill.groups()), f"{fn} spills: {u}"


@pytest.mark.parametrize("kernel,op", TENSOR_CORE_KERNELS.items())
def test_kernel_runs_on_the_tensor_cores(sass_counts, kernel, op):
    mine = {fn: c for fn, c in sass_counts.items() if kernel in fn}
    assert mine and all(c[op] for c in mine.values()), \
        f"{kernel}: no {op} in its SASS: {mine}"
