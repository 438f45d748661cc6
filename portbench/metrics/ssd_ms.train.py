"""Median device milliseconds a training step spends in the Mamba2 scan:
the program's spans ``model.ssd`` (forward), ``.recompute`` (remat's) and
``.backward`` around ``models/ssm.py::ssd_chunked`` (in ``mamba_mixer``),
summed within each traced step (``launch.train_step``) that records host
operations."""
from portbench import program_spans

NAMES = ("model.ssd", "model.ssd.recompute", "model.ssd.backward")


def read(outcome):
    return program_spans.device("launch.train_step", NAMES)
