"""Median device milliseconds a training step spends recomputing its
checkpointed layers in the backward: the program's span
``model.layer.recompute`` (``models/lm.py::_remat``), summed within each
traced step (``launch.train_step``) that records host operations."""
from portbench import program_spans


def read(outcome):
    return program_spans.device("launch.train_step",
                                ("model.layer.recompute",))
