"""The training loop of ``loops/train.py`` for the Zamba2 configuration
(``configs/zamba2-7b.json``): the same training object, window and traced
steps, with the weights and the port's model config of
:mod:`portbench.lm_hybrid` (the ``zamba2`` family, its head tied to the
embedding) in place of the dense model's.  The check's reference is the
configuration's own (``reference/zamba2.py``).

The check compares what ``train``'s compares and one number more,
``grad_elementwise_gap``: for each leaf, the program's first gradient as
AdamW took it (its first moment over ``1 - b1``, kept on the host after
step 1) against the reference's, ``|g - g_ref| / |g_ref|``, the worst leaf.
On this model the norms of a leaf's gradient, change and second moment
hardly tell a product computed in float8 from one in bfloat16; the
direction of the gradient does (PERF.md).
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, Optional

import torch

from portbench import harness, lm, lm_hybrid
from portbench.loops import train
from portbench.loops.train import Trainer
from portbench.trace import Spans

ELEMENTWISE = "grad_elementwise_gap"


@dataclasses.dataclass
class HybridTrainer(Trainer):
    """``train``'s training object that also keeps, after its first step,
    each leaf's gradient as AdamW took it, in float32 on the host."""
    b1: float = 0.9
    first_grads: Optional[Dict[str, torch.Tensor]] = None

    def step(self) -> dict:
        metrics = super().step()
        if self.first_grads is None:
            self.first_grads = {
                k: (x.float() / (1 - self.b1)).cpu()
                for k, x in train._flat(self.opt["m"]).items()}
        return metrics


def build(cell: harness.Cell, seed: int, device: torch.device,
          spans: Spans) -> HybridTrainer:
    from repro_torch.data.pipeline import DataConfig, make_train_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamWConfig, adamw_init

    config, traffic = cell.config, cell.traffic
    model = LM(lm_hybrid.model_config(config))
    opt_cfg = AdamWConfig(**config["run"]["optimizer"])
    params = lm.nest(lm_hybrid.draw(config, seed, device))
    data = DataConfig(vocab_size=config["vocab_size"],
                      seq_len=traffic["seq_len"],
                      global_batch=traffic["rows"],
                      seed=traffic["documents_seed"],
                      mean_doc_len=traffic["mean_doc_len"],
                      min_doc_len=traffic["min_doc_len"])
    return HybridTrainer(make_train_step(model, opt_cfg), params,
                         adamw_init(params, opt_cfg.state_format),
                         make_train_batches(data), traffic,
                         lm.relabeling(config, seed), device, spans,
                         b1=opt_cfg.b1)


def first_steps(trainer: HybridTrainer, config: dict, steps: int = 3
                ) -> dict:
    """``train.first_steps``, and under ``grads`` each leaf's first
    gradient."""
    out = train.first_steps(trainer, config, steps)
    out["grads"] = trainer.first_grads
    return out


def elementwise_gap(prog: Dict[str, torch.Tensor],
                    ref: Dict[str, torch.Tensor]) -> float:
    """The largest ``|g - g_ref| / |g_ref|`` over the reference's leaves
    (a leaf the program lacks reads 1)."""
    worst = 0.0
    for k, want in ref.items():
        got = prog.get(k)
        size = float(torch.linalg.vector_norm(want))
        miss = (float(torch.linalg.vector_norm(got.float() - want))
                if got is not None else size)
        worst = max(worst, miss / max(size, 1e-30))
    return worst


def compare(prog: dict, ref: dict, batches_prog, batches_ref, limits: dict
            ) -> Dict[str, harness.Check]:
    """``train.compare`` on the numbers it knows, and the worst leaf's
    first gradient element by element where the mix gives that a limit."""
    checks = train.compare(prog, ref, batches_prog, batches_ref,
                           {k: v for k, v in limits.items()
                            if k != ELEMENTWISE})
    if ELEMENTWISE in limits:
        checks[ELEMENTWISE] = harness.Check(
            elementwise_gap(prog["grads"], ref["grads"]), limits[ELEMENTWISE])
    return checks


# ``train.run``'s code over this module's ``build``, ``first_steps`` and
# ``compare``: its set-up, window, traced steps and order of the check are
# the dense cells' own, and ``loops/train.py`` runs as it is
run = types.FunctionType(
    train.run.__code__,
    {**vars(train), "build": build, "first_steps": first_steps,
     "compare": compare}, "run")
