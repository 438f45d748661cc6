"""The port stands alone: ``repro_torch`` imports and runs with ``jax`` and
the reference package made unimportable, and importing it neither builds
nor loads a CUDA kernel.
"""
import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None            # any import of these now raises
import importlib, pkgutil
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
from repro_torch.kernels import _build
assert not _build._LIBS, "a kernel library was loaded at import"
assert not _build.BUILD_DIR.exists() or not any(
    p.stat().st_mtime > START for p in _build.BUILD_DIR.iterdir()), \
    "importing the package built something"
import numpy as np
from repro_torch.core import patterns
from repro_torch.core.machine import to_numpy
run = patterns.PATTERNS["{pattern}"]()
mem, state = patterns.run_pattern(run, device="cpu")
run.check(to_numpy(mem), state)
assert not _build._LIBS
assert not any(m == "jax" or m.startswith("jax.") or m == "repro"
               or m.startswith("repro.") for m in sys.modules
               if sys.modules[m] is not None)
print("OK", len(mods), len(state.trace))
"""


def _run(pattern):
    import time
    script = _SCRIPT.replace("START", repr(time.time())).replace(
        "{pattern}", pattern)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_runs_without_jax_or_the_reference_package():
    proc = _run("daxpy")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_port_sources_name_neither_package():
    """No module of the port (nor the on-card smoke script) imports
    ``jax`` or anything of ``repro``."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        assert not pat.search(path.read_text()), path
