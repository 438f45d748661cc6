"""Hand-written Hopper kernels for the port's compute hot-spots.

  mdgather   — MVE ``vsld`` multi-dimensional strided gather
               (CUDA C++, ``csrc/mdgather.cu``)
  mdscatter  — MVE ``vsst`` multi-dimensional strided scatter with
               last-lane-wins collisions (CUDA C++, ``csrc/mdscatter.cu``)

Each kernel has its plain PyTorch version in ``ref.py``; ``ops.py`` holds
the wrappers the executors call.  A wrapper takes the plain version only
for a tensor that lies on the CPU; for a CUDA tensor it launches the
kernel or raises.

Submodules import lazily (PEP 562) and nothing here compiles at import:
``_build`` runs ``nvcc`` at the first launch.
"""
_LAZY = {"ops", "ref", "mdgather", "mdscatter", "_build"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _LAZY)
