"""Share of their operations bound that the flash forward and backward
kernels reach over the traced steps: 4 D operations a visible pair a head
forward and 10 D backward (``counts.flash_step_operations``; a recomputed
forward is not counted) at 989 TFLOP/s, over the summed device time of
every ``flash_fwd*`` and ``flash_bwd*`` kernel."""
from portbench import counts
from portbench.metrics_common import train_work

KERNELS = ("flash_fwd", "flash_bwd")


def read(outcome):
    trace = outcome.trace
    if trace is None:
        return None
    seconds = trace.seconds_of(KERNELS)
    work = train_work(outcome, traced=True)
    if seconds <= 0 or work is None:
        return None
    ops = counts.flash_step_operations(outcome.cell.config, work[1])
    return 100.0 * ops / counts.BF16_FLOPS_PER_S / seconds
