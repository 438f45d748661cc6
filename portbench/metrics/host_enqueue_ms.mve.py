"""Mean host milliseconds of one ``run_batch_async`` + ``finalize_batch``
call in the window: the benchmark's own span around its call into the
executor (``core/engine.py``)."""


def read(outcome):
    return outcome.spans.mean_ms("enqueue") if outcome.spans else None
