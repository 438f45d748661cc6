"""Sampled integrity audit of served results.

A bit-flipped SRAM cell does not raise — it *silently* serves a wrong
answer.  The only defense is re-computation on an independent path and a
bit-exact compare, which is exactly the repo's conformance contract
(``tests/test_conformance.py``: interp == fused == VM, bit for bit).
:class:`ResultAuditor` packages that contract as a runtime component the
scheduler samples per served request:

* ``method="cross"`` — re-execute on the *other* executor (a VM-served
  result is checked against the fused engine and vice versa).  Cheap
  (one extra warm dispatch).  In the reference the two executors share
  no datapath code past the program walk; in this port the VM runs the
  fused executor's datapath, so ``"cross"`` re-executes the same
  datapath under the other mode's name.  It still catches corruption
  that happens after the dispatch (the SRAM bit-flip model injects into
  the served copy), not a fault of the shared datapath itself.
* ``method="oracle"`` — re-execute on the stepwise interpreter, the
  semantic ground truth.  Orders of magnitude slower; for forensic runs
  and low sample rates.

On mismatch the auditor returns the reference payload — the scheduler
serves *that*, counts ``audit_corrected``, and records a breaker failure
against the corrupted executor tier so repeat corruption demotes it.

Sampling is deterministic per ``(seed, rid)``: the same chaos replay
audits the same requests, independent of retry interleaving.

Re-executions run on ``device`` (default ``cuda``); the reference
payload comes back to the host as NumPy arrays, as served results do.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.machine import resolve_device, to_numpy

AuditReference = Tuple[np.ndarray, Dict[int, np.ndarray], np.ndarray]


class ResultAuditor:
    def __init__(self, rate: float = 1.0, seed: int = 0,
                 method: str = "cross", injector=None, device=None):
        if method not in ("cross", "oracle"):
            raise ValueError(f"unknown audit method {method!r}")
        self.device = resolve_device(device)
        self.rate = float(rate)
        self.seed = seed
        self.method = method
        self.injector = injector        # suspended during reference runs
        self._lock = threading.Lock()
        self.checked = 0
        self.mismatches = 0
        self._oracles: Dict[object, object] = {}

    def should_audit(self, rid: int) -> bool:
        if self.rate <= 0.0:
            return False
        if self.rate >= 1.0:
            return True
        return np.random.default_rng((self.seed, rid)).random() < self.rate

    # -- the check ---------------------------------------------------------
    def check(self, program, memory_in, cfg, served_memory, served_tag,
              served_mode: str) -> Optional[AuditReference]:
        """Bit-compare a served result against an independent
        re-execution; returns ``None`` when it verifies, else the
        reference ``(memory, regs, tag)`` to serve instead."""
        ref = self._reference(program, memory_in, cfg, served_mode)
        mem, regs, tag = ref
        with self._lock:
            self.checked += 1
        if np.array_equal(mem, np.asarray(served_memory)) and \
                np.array_equal(tag, np.asarray(served_tag)):
            return None
        with self._lock:
            self.mismatches += 1
        return ref

    def _reference(self, program, memory_in, cfg,
                   served_mode: str) -> AuditReference:
        if self.injector is not None:
            with self.injector.suspended():
                return self._reference_unshielded(
                    program, memory_in, cfg, served_mode)
        return self._reference_unshielded(program, memory_in, cfg,
                                          served_mode)

    def _reference_unshielded(self, program, memory_in, cfg,
                              served_mode: str) -> AuditReference:
        program = list(program)
        if self.method == "cross" and served_mode in ("vm", "fused"):
            from ..core.engine import compile_program
            other = "fused" if served_mode == "vm" else "vm"
            cp = compile_program(program, cfg, mode=other,
                                 device=self.device)
            if cp.mode != served_mode:      # no silent same-mode "audit"
                mem, state = cp.run(memory_in)
                return (to_numpy(mem),
                        {r: to_numpy(v) for r, v in state.regs.items()},
                        to_numpy(state.tag))
        # oracle method, an oracle-served result, or a cross request whose
        # other mode fell back to the served one: stepwise ground truth.
        mem_i, st_i = self._oracle(cfg).run_stepwise(program, memory_in)
        return (to_numpy(mem_i),
                {r: to_numpy(v) for r, v in st_i.regs.items()},
                to_numpy(st_i.tag))

    def _oracle(self, cfg):
        o = self._oracles.get(cfg)
        if o is None:
            from ..core.interp import MVEInterpreter
            o = self._oracles[cfg] = MVEInterpreter(cfg, compiled=False,
                                                    device=self.device)
        return o

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"checked": self.checked, "mismatches": self.mismatches}
