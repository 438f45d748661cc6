"""Median device milliseconds a training step spends in attention: the
program's spans ``model.attention`` (forward), ``.recompute`` (remat's) and
``.backward`` around the ``chunked_attention`` calls of ``models/lm.py``,
summed within each traced step (``launch.train_step``) that records
host operations."""
from portbench import program_spans

NAMES = ("model.attention", "model.attention.recompute",
         "model.attention.backward")


def read(outcome):
    return program_spans.device("launch.train_step", NAMES)
