"""What the engine takes from the program-as-data VM layer.

The VM datapath itself (dense opcode/flag/immediate tables executed by one
step loop over a fixed register file) is still to be ported (ROADMAP.md
queue A: ``core/vm.py``).  Until then this module holds only the pieces
:mod:`repro_torch.core.engine` shares with it: the executor-boundary fault
hook registry and the :class:`VMUnsupported` exception.
"""
from __future__ import annotations

import threading


class VMUnsupported(Exception):
    """Program cannot be lowered to the VM (e.g. too many live registers)."""


# ---------------------------------------------------------------------------
# Executor-boundary fault hook (chaos engineering).
# ---------------------------------------------------------------------------

# One process-wide hook shared by every executor.  A fault injector installs
# its hook to inject failures/latency at the real executor boundaries;
# ``None`` (the default) makes every site a no-op.
_FAULT_HOOK = None
_FAULT_HOOK_LOCK = threading.Lock()


def set_fault_hook(hook):
    """Install ``hook(site, **ctx)`` at the executor boundaries; returns
    the previous hook (restore it when done).  :mod:`repro_torch.core.engine`
    fires ``engine.compile`` / ``engine.dispatch`` / ``engine.finalize``."""
    global _FAULT_HOOK
    with _FAULT_HOOK_LOCK:
        prev, _FAULT_HOOK = _FAULT_HOOK, hook
    return prev


def fire_fault_hook(site: str, **ctx) -> None:
    hook = _FAULT_HOOK
    if hook is not None:
        hook(site, **ctx)
