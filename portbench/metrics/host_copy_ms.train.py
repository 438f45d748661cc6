"""Host milliseconds of moving one step's packed batch to the device by
itself: the program's span ``launch.batch_to`` in
``launch/train.py::_batch_to``, median over the traced steps that record
host operations.  That slice begins on a drained device, so the copy does
not wait for a queued step there; the window's wait for the queue is what
``host_pipeline_ms.train`` has beyond this and ``host_pack_ms.train``."""
from portbench import program_spans


def read(outcome):
    return program_spans.host("launch.batch_to")
