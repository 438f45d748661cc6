"""Median device milliseconds a training step spends in Zamba2's shared
blocks: the program's spans ``model.shared`` (an application's forward:
its attention, MLP, adapter and linear) and ``.backward`` (which holds the
application's checkpoint recompute and its backward, once each;
``models/lm.py::LM._shared_application``), summed within each traced step
(``launch.train_step``) that records host operations.  Its attention is
also in ``attention_ms.train``."""
from portbench import program_spans

NAMES = ("model.shared", "model.shared.backward")


def read(outcome):
    return program_spans.device("launch.train_step", NAMES)
