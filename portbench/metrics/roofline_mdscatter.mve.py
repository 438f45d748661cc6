"""Share of its bytes bound that the ``mdscatter`` kernels reach in the
traced slice: the bytes every ``vsst`` of the traced batches must move
(``counts.mve_access_bytes``, from the frozen programs) at 3.35 TB/s, over
the summed device time of the ``mdscatter_*`` kernels."""
from portbench.metrics_common import mve_roofline


def read(outcome):
    return mve_roofline(outcome, "store", ("mdscatter_",))
