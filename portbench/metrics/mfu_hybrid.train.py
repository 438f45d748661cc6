"""Model FLOPs of the window's Zamba2 steps over their time and the
card's bf16 peak (989 TFLOP/s dense): 6 x the parameters a token meets in
a matrix product (the tied head once) x the tokens, attention's products
over the visible pairs, and the SSD's whole-chunk products
(``counts_hybrid.step_model_flops``), from the published sizes and the
reference's packing of the documents."""
from portbench import counts, counts_hybrid
from portbench.metrics_common import train_work


def read(outcome):
    work = train_work(outcome, traced=False)
    seconds = outcome.window.get("window_s", 0.0)
    if work is None or seconds <= 0:
        return None
    flops = counts_hybrid.step_model_flops(outcome.cell.config, *work)
    return 100.0 * flops / seconds / counts.BF16_FLOPS_PER_S
