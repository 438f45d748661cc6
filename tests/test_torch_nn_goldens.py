"""The reference's frozen per-block cost rows (``tests/data/
nn_goldens.json``) reproduced by ``repro_torch.nn``.

For every default-shape zoo block: the emitted program size, the register
allocation, and the priced cycles, energy and instruction mix on
``mve-bs`` and ``rvv-1d`` — each block executed on the port
(``device="cpu"``) and checked against its oracle first.  The goldens are
read, never written: equality is exact (floats round-trip through JSON).
"""
import json
import pathlib

import pytest

from repro_torch import targets
from repro_torch.nn import BLOCK_KERNELS

GOLDEN = pathlib.Path(__file__).parent / "data" / "nn_goldens.json"
_TARGETS = ("mve-bs", "rvv-1d")


def _block_entry(name: str) -> dict:
    run = BLOCK_KERNELS[name]()
    entry = {
        "instrs": len(run.kernel.program),
        "n_regs": run.kernel.n_regs,
        "max_live": run.kernel.max_live,
        "exactness": run.exactness,
    }
    for tname in _TARGETS:
        art = targets.compile(run.kernel, target=tname, device="cpu")
        mem, state = art.run(run.memory)
        run.check(mem, state)
        tl = art.timeline(state)
        mix = art.instruction_mix()
        entry[tname] = {
            "cycles": tl.total_cycles,
            "energy_pj": art.energy(state).total_pj,
            "vector_instructions": mix.vector,
            "scalar_instructions": mix.scalar,
        }
    return entry


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("name", sorted(BLOCK_KERNELS))
def test_block_rows_reproduce(golden, name):
    """Exact program size + per-target cycle/energy rows per block."""
    assert _block_entry(name) == golden["blocks"][name], \
        f"{name}: cost rows differ from the reference's goldens"


def test_goldens_cover_the_port_zoo(golden):
    assert sorted(golden["blocks"]) == sorted(BLOCK_KERNELS)
