"""Device milliseconds a batch of images spends in the executor's
stores (``SST``, ``RST``), each with the conversion of its register: the
program's span ``engine.store`` around those steps of
``core/engine.py::CompiledProgram._execute``, summed within each batch
(``engine.dispatch``) and averaged over the batches of the traced slice
that records host operations: one of each pattern."""
from portbench import program_spans


def read(outcome):
    return program_spans.device("engine.dispatch", ("engine.store",),
                                mean=True)
