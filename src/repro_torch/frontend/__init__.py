"""MVE kernel frontend: trace kernels, never touch registers or offsets.

    import repro_torch.frontend as mve
    from repro_torch.frontend import SEQ, BCAST, DERIVED, CR
    from repro_torch.core.isa import DType

    @mve.kernel
    def daxpy(b, n=8192, alpha=1.5):
        x = b.input("x", (n,), DType.F)
        y = b.inout("y", (n,), DType.F)
        b.width(32)
        with b.dims(n):
            b.scalar(4)
            vy = y.load(SEQ)
            vy += alpha * x.load(SEQ)
            y.store(vy, SEQ)

Layers (design note: docs/FRONTEND.md):

  builder  — tracing ``KernelBuilder`` / ``@mve.kernel`` API
  regalloc — liveness-based linear-scan virtual->physical allocation
  operands — named tensor operands + flat-memory planner

Built kernels lower to the unchanged :class:`repro_torch.core.isa.Program` IR:
every executor and the serving stack accept them directly.
"""
from .builder import (BuildError, Kernel, KernelBuilder,  # noqa: F401
                      VectorHandle, kernel)
from .operands import (BCAST, CR, DERIVED, SEQ,  # noqa: F401
                       MemoryPlan, Operand, OperandError, OperandRef)
from .regalloc import (DEFAULT_MAX_REGS, RegisterPressureError,  # noqa: F401
                       allocate, live_intervals, max_pressure)
