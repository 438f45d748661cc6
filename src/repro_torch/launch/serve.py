"""Serving driver: continuous batching with MVE dimension-level masking.

The paper's central abstraction — pack multi-dimensional, irregular
parallelism onto a fixed wide lane axis and mask whole *dimension
elements* rather than per-element predicates — is exactly the shape of
continuous-batching decode:

  * the decode batch is a fixed :class:`repro_torch.core.packing.LaneGrid`
    (requests = the highest dimension; a mask bit per request slot),
  * arriving requests claim masked-off slots; finished requests release
    them; prefill and decode interleave freely because every slot feeds
    its own next token (prompt token while prefilling, last sample after),
  * ONE batched decode step serves whatever mix is resident: per-slot
    sequence positions ride in a (B,)-shaped cache index, and inactive
    slots are simply computed-and-discarded — dimension-level masking,
    not per-token predication.

The cache lives on the engine's device (``cuda`` unless the caller names
another) and is updated in place by every step; per step one ``(B,)``
vector of token ids comes back to the host.  A slot's recurrent state
(the ``ssm`` and ``hybrid`` families) is zeroed when a request is admitted
to it; the reference keeps the previous request's state there
(ROADMAP.md, C9).  The cross caches of the ``vlm`` and ``encdec`` families
stay zero, as in the reference, whose ``Request`` carries no image or
audio: the engine serves their decoders text-only (ROADMAP.md, C10).

:class:`MVEProgramServer` is the second front door: concurrent MVE
*program* requests served by the signature-batched scheduler
(:mod:`repro_torch.runtime.scheduler`), on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.machine import resolve_device
from ..core.packing import LaneGrid
from ..models.lm import LM


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None


@dataclasses.dataclass
class SlotState:
    request: Request
    length: int = 0                     # tokens resident in this slot
    prompt_pos: int = 0                 # prompt tokens consumed


class ContinuousBatchingEngine:
    """Fixed-slot continuous batching, one batched decode per step.

    Greedy decoding; prefill streams prompt tokens through the same
    batched step (so a long prompt never stalls other slots)."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int,
                 max_seq: int, clock: Callable[[], float] = time.monotonic,
                 device=None):
        self.cfg = cfg
        self.model = LM(cfg)
        self.params = params
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.grid = LaneGrid((max_seq, batch_slots))   # top dim = requests
        self.clock = clock
        self._queue: List[Request] = []
        self._done: Dict[int, Request] = {}
        self.cache = self.model.init_cache(batch_slots, max_seq, self.device)
        self.steps = 0

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submitted_at = self.clock()
        self._queue.append(req)

    def _try_admit(self) -> None:
        while self._queue:
            slot = self.grid.allocate(None)
            if slot is None:
                return
            req = self._queue.pop(0)
            # the slot's recurrent state (ssm, hybrid) is its last
            # request's: zero it, or the new request starts from there
            self.model.clear_slot(self.cache, slot)
            self.grid._payload[slot] = SlotState(req)

    # -- main loop -------------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: admit, one batched decode, evict.

        Returns the number of active slots served."""
        self._try_admit()
        active = self.grid.active_slots()
        if len(active) == 0:
            return 0
        b = self.grid.top
        tokens = np.zeros((b, 1), np.int64)
        lengths = np.zeros((b,), np.int64)
        for slot in active:
            st: SlotState = self.grid.payload(slot)
            req = st.request
            if st.prompt_pos < len(req.prompt):
                tokens[slot, 0] = int(req.prompt[st.prompt_pos])
            else:
                tokens[slot, 0] = req.output[-1]
            lengths[slot] = st.length
        logits, self.cache = self.model.decode_step(
            self.params, self.cache,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(lengths).to(self.device))
        # greedy pick on the device; the first maximum wins, as np.argmax
        picks = logits[:, : self.cfg.vocab_size].argmax(dim=-1).cpu().numpy()
        self.steps += 1

        served = 0
        for slot in active:
            st = self.grid.payload(slot)
            req = st.request
            st.length += 1
            served += 1
            if st.prompt_pos < len(req.prompt):
                st.prompt_pos += 1
                if st.prompt_pos < len(req.prompt):
                    continue             # still prefilling
            nxt = int(picks[slot])
            req.output.append(nxt)
            if req.first_token_at is None:
                req.first_token_at = self.clock()
            eos = (req.eos_id is not None and nxt == req.eos_id)
            if (len(req.output) >= req.max_new_tokens or eos
                    or st.length >= self.max_seq - 1):
                req.done_at = self.clock()
                self._done[req.rid] = req
                self.grid.release(slot)
        return served

    def run_until_drained(self, max_iters: int = 10_000
                          ) -> Dict[int, Request]:
        it = 0
        while (self._queue or len(self.grid.active_slots())) and \
                it < max_iters:
            self.step()
            it += 1
        return self._done

    @property
    def occupancy(self) -> float:
        return self.grid.occupancy()


# ---------------------------------------------------------------------------
# MVE program serving: the front door over the signature-batched scheduler.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProgramRequest:
    """One client's MVE program submission (compare :class:`Request`).

    Timing and results delegate to the underlying scheduler
    :class:`~repro_torch.runtime.scheduler.Ticket` — one source of truth."""

    rid: int
    program: tuple
    memory: np.ndarray
    ticket: object = None                # runtime.scheduler.Ticket
    result: Optional[object] = None      # ServeResult once served
    error: Optional[BaseException] = None  # typed SchedulerError on failure

    @property
    def submitted_at(self) -> float:
        return self.ticket.submitted_at

    @property
    def done_at(self) -> Optional[float]:
        return self.ticket.done_at

    @property
    def latency(self) -> float:
        """Submit-to-completion seconds; raises until finished."""
        return self.ticket.latency


class MVEProgramServer:
    """Serving facade for MVE programs: request bookkeeping + latency
    accounting over :class:`repro_torch.runtime.scheduler.MVEScheduler`.

    The LM path above packs concurrent *decode* requests onto the lane
    grid; this path packs concurrent *program* requests onto batched
    dispatches grouped by VM signature — the same dimension-level-batching
    idea one level up the stack.  Used by
    ``benchmarks/torch_serving_bench.py`` to replay the Table III workload
    mix.  ``scheduler_kwargs`` go to :class:`MVEScheduler` (``device=``
    among them: ``cuda`` unless the caller names another); results come
    back as host NumPy arrays (``req.result`` is a
    :class:`~repro_torch.runtime.scheduler.ServeResult`).

    Thread-safe like the scheduler it wraps; ``keep_done`` bounds the
    finished-request history a long-lived server retains.
    """

    def __init__(self, scheduler=None, keep_done: int = 4096,
                 **scheduler_kwargs):
        import threading
        from collections import OrderedDict

        from ..runtime.scheduler import MVEScheduler
        self.scheduler = scheduler or MVEScheduler(**scheduler_kwargs)
        self.keep_done = keep_done
        self._lock = threading.Lock()
        self._next_rid = 0
        self._inflight: "OrderedDict[int, ProgramRequest]" = OrderedDict()
        self._done: "OrderedDict[int, ProgramRequest]" = OrderedDict()

    def submit(self, program, memory=None, target=None,
               deadline_s=None) -> ProgramRequest:
        """Accepts a raw ``(program, memory)`` pair or a frontend
        :class:`~repro_torch.frontend.Kernel` plus named operand arrays — the
        same overloads as :meth:`MVEScheduler.submit`; kernel requests
        read results back by name (``req.result.operands``).  ``target``
        selects a registered :mod:`repro_torch.targets` target (unknown names
        raise a ``ProgramError`` listing what is registered);
        ``deadline_s`` bounds the request's submit-to-resolution time."""
        ticket = self.scheduler.submit(program, memory, target=target,
                                       deadline_s=deadline_s)
        with self._lock:
            req = ProgramRequest(rid=self._next_rid,
                                 program=ticket.program,
                                 memory=ticket.memory, ticket=ticket)
            self._next_rid += 1
            self._inflight[req.rid] = req
        return req

    def run_until_drained(self) -> Dict[int, ProgramRequest]:
        """Serve everything in flight; returns rid -> finished request.

        A request the scheduler resolved with a typed error (quarantine,
        deadline, shed, cancellation — docs/SERVING.md "Failure
        semantics") finishes with ``req.error`` set and ``req.result``
        ``None``; one failed request never aborts the drain of the
        others."""
        self.scheduler.drain()
        with self._lock:
            inflight = list(self._inflight.items())
        for rid, req in inflight:            # blocks outside the lock
            try:
                req.result = req.ticket.result()
            except Exception as e:
                req.error = e
        with self._lock:
            for rid, req in inflight:
                self._done[rid] = req
                self._inflight.pop(rid, None)
            while len(self._done) > self.keep_done:
                self._done.popitem(last=False)
            return dict(self._done)      # snapshot, not the internal dict

    def health(self) -> Dict:
        """The underlying scheduler's health snapshot (worker liveness,
        breakers, quarantine, retry/shed/audit counters) — what a
        mesh-level coordinator scrapes."""
        return self.scheduler.health()

    def latency_stats(self, last: Optional[int] = None) -> Dict[str, float]:
        """Mean/p50/p95 request latency (seconds) over finished requests
        (the ``last`` most recent ones when given — e.g. one replay)."""
        with self._lock:
            reqs = [self._done[rid] for rid in sorted(self._done)]
        if not reqs:
            return {"mean": 0.0, "p50": 0.0, "p95": 0.0}
        if last is not None:
            reqs = reqs[-last:]
        lats = np.array([r.latency for r in reqs])
        return {"mean": float(lats.mean()),
                "p50": float(np.percentile(lats, 50)),
                "p95": float(np.percentile(lats, 95))}
