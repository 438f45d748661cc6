"""Host microseconds a batch of images spends routing its loads
and stores before each kernel launch (the cached plan's lookup, the
operands' layout and the output's allocation): the program's span
``kernels.route`` in ``kernels/mdgather.py`` and ``kernels/mdscatter.py``,
summed within each batch (``engine.dispatch``) and averaged over the
batches of the traced slice that records host operations: one of each
pattern."""
from portbench import program_spans


def read(outcome):
    return program_spans.host("engine.dispatch", "kernels.route", scale=1e6,
                              mean=True)
