"""Median device milliseconds a training step spends in the chunked
cross-entropy: the program's spans ``model.ce`` (forward), ``.backward``
and ``.recompute`` (which runs inside the backward, so it is counted
there) around ``models/common.py::_ce_chunk``, summed within each traced
step (``launch.train_step``) that records host operations."""
from portbench import program_spans

NAMES = ("model.ce", "model.ce.recompute", "model.ce.backward")


def read(outcome):
    return program_spans.device("launch.train_step", NAMES)
