"""PyTorch/CUDA port of the MVE reproduction (``src/repro`` is the JAX
reference; this package is its counterpart module for module).

Sub-packages keep the reference's names so the counterpart of a module is
found by path:

  core      — ISA, machine geometry, step oracle, compiled engine, cost
              models, the 14 Section-IV patterns
  frontend  — the ``@mve.kernel`` tracing builder
  kernels   — the hand-written Hopper kernels (CUDA C++ under
              ``kernels/csrc``) with their plain PyTorch versions
  convert   — programs, geometry and machine state carried across from the
              reference package for the parity tests

Entry points that allocate take ``device=`` and default to
``torch.device("cuda")``; asked for a CUDA device on a machine without one
they raise.  Importing the package builds nothing: the CUDA sources are
compiled at the first kernel launch (:mod:`repro_torch.kernels._build`).
"""
