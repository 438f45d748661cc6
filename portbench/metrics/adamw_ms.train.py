"""Median device milliseconds of a training step's AdamW update: the
program's span ``optim.adamw`` (``optim/adamw.py::adamw_update``) within
each traced step (``launch.train_step``) that records host operations."""
from portbench import program_spans


def read(outcome):
    return program_spans.device("launch.train_step", ("optim.adamw",))
