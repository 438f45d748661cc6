"""MVE core: the paper's contribution as a composable module.

Layers:
  isa      — instruction set (Table II), stride modes, intrinsics
  machine  — cache geometry, control registers, lane flattening, the
             element-type table and conversion rules of the executors
  interp   — step executor (the semantic oracle; see docs/ISA.md)
  engine   — whole-program compiler + straight-line eager executor
             (mode "fused"), single image or an explicit batch axis
  vm       — fault-hook registry; the program-as-data datapath is still
             to be ported (ROADMAP.md)
  cost     — BS/BP/BH/AC cycle models + controller/CB timeline
  patterns — Section IV data-parallel patterns for 12 mobile libraries
             (built with the kernel frontend, :mod:`repro_torch.frontend`)

Kernels are authored one level up, in :mod:`repro_torch.frontend`
(docs/FRONTEND.md): a tracing builder over named operands that lowers to
the ``isa.Program`` IR these modules execute.  Every strided load and
store of both executors goes through
:mod:`repro_torch.kernels.ops` (``mdv_gather`` / ``mdv_scatter_``).
"""
from . import cost, engine, interp, isa, machine, vm  # noqa: F401
from .engine import (CompiledProgram, cache_info,  # noqa: F401
                     compile_program)
from .interp import MVEInterpreter  # noqa: F401
from .machine import MVEConfig  # noqa: F401

# ``patterns`` is imported lazily (PEP 562): it builds its programs with
# the kernel frontend (:mod:`repro_torch.frontend`), which itself imports this
# package for the ISA — eager import here would be circular.
_LAZY = {"patterns", "run_pattern"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        patterns = importlib.import_module(".patterns", __name__)
        return patterns if name == "patterns" else patterns.run_pattern
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _LAZY)
