"""Share of its bytes bound that the ``mdgather`` kernels reach in the
traced slice: the bytes every ``vsld`` of the traced batches must move
(``counts.mve_access_bytes``, from the frozen programs) at 3.35 TB/s, over
the summed device time of the ``mdgather_*`` kernels."""
from portbench.metrics_common import mve_roofline


def read(outcome):
    return mve_roofline(outcome, "load", ("mdgather_",))
