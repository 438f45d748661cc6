"""The program's own spans (``repro_torch.obs``), as the per-layer readers
take them.

The program records spans while a ``torch.profiler`` session records host
operations, and not under one that records the device alone.  So on the
card a run with ``--trace 1`` holds those of the traced slice that names
the idle gaps (``trace.traced``'s second, host-recorded slice: one step, or
one round of the MVE patterns), and nothing of the device-only slice that
``busy_s`` and ``idle_share.*`` are read over, nor of the window.  (On the
CPU both slices record host operations, so both hold spans.)  Each root
span instance is one unit of work: a batch (``engine.dispatch``) or a step
(``launch.train_step``), or one call of a root of its own (``data.pack``,
``launch.batch_to``).

A training reading is the median over the root's instances.  The MVE
cell's batches run 12 programs of different sizes, so a median over them
would follow one program; an MVE reading is the mean over the batches (one
of each program on the card), so that the parts add up to a batch.  Where
the program has no such span (a version without ``repro_torch.obs``) or
took no device time (the CPU), a reader returns ``None``.
"""
from __future__ import annotations

import statistics
from typing import Optional, Sequence


def snapshot():
    """``repro_torch.obs.snapshot()``, or ``None`` where the program has
    no such module."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.snapshot()


def _instances(root: str):
    return (snapshot() or {}).get(root) or None


def _reduce(values, mean: bool) -> float:
    return statistics.fmean(values) if mean else statistics.median(values)


def host(root: str, name: Optional[str] = None, scale: float = 1e3,
         mean: bool = False) -> Optional[float]:
    """The host seconds of ``name`` (the root itself by default) within
    each of ``root``'s instances, times ``scale``: their median, or with
    ``mean`` their mean."""
    instances = _instances(root)
    if instances is None:
        return None
    name = name or root
    return scale * _reduce([rec[name].host_s if name in rec else 0.0
                            for rec in instances], mean)


def device(root: str, names: Sequence[str], scale: float = 1e3,
           mean: bool = False) -> Optional[float]:
    """The device seconds of the spans named ``names`` within each of
    ``root``'s instances, times ``scale``: their median, or with ``mean``
    their mean.  A span that opened inside another of ``names`` is counted
    in it (a chunk's recompute runs inside its backward), not again."""
    instances = _instances(root)
    if instances is None:
        return None
    names = set(names)
    values, timed = [], False
    for rec in instances:
        total = 0.0
        for name in names & rec.keys():
            stat = rec[name]
            if stat.parent in names:
                continue
            if stat.device_s is not None:
                total += stat.device_s
                timed = True
        values.append(total)
    return scale * _reduce(values, mean) if timed else None
