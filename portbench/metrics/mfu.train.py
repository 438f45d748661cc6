"""Model FLOPs of the window's steps over their time and the card's bf16
peak (989 TFLOP/s dense): 6 x the parameters that enter a matrix product
(the output head once) x the tokens, plus 12 x layers x heads x head_dim x
the visible (query, key) pairs (``counts.step_model_flops``), from the
published sizes and the reference's packing of the documents."""
from portbench import counts
from portbench.metrics_common import train_work


def read(outcome):
    work = train_work(outcome, traced=False)
    seconds = outcome.window.get("window_s", 0.0)
    if work is None or seconds <= 0:
        return None
    flops = counts.step_model_flops(outcome.cell.config, *work)
    return 100.0 * flops / seconds / counts.BF16_FLOPS_PER_S
