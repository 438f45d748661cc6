"""The port's training driver on the CPU: the three tests of
``tests/test_train_loop.py`` (loss decreases, checkpoint restart resumes
exactly, gradient accumulation) through ``repro_torch.launch.train``, one
``make_train_step`` step against the reference's from the same parameters,
state and batch (``grad_accum`` 1 and 2, fp32 and int8 moments), the
entry point's refusals, and the reference's own loop failing to resume
int8 moments (ROADMAP C13; the port resumes them).

Step parity, float32 parameters: loss and metrics within ``rtol 1e-6``;
fp32 moments within ``1e-5`` of each leaf's largest entry; int8 moments
within one quantization step; the new parameters within ``1e-4`` of each
leaf's largest entry.  AdamW's ``m / sqrt(v)`` magnifies the gradients'
last-digit differences where a gradient is tiny: the key bias ``bk`` moves
every logit of a query row alike, so its exact gradient is 0 and both
sides step on rounding noise (worst measured 3.8e-5 of the leaf's
largest entry; every other leaf under 1e-6).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeCell as RefShapeCell
from repro.configs import get_config as ref_get_config
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.launch.train import TrainLoopConfig as RefTrainLoopConfig
from repro.launch.train import train_loop as ref_train_loop
from repro.models import LM as RefLM
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TrainLoopConfig, train_loop
from repro_torch.models import LM
from repro_torch.trees import tree_leaves
from repro_torch.optim import AdamWConfig

from _torch_train import reference_params, train_batch

STEP_TOL = 1e-5
PARAM_TOL = 1e-4


def _cfg():
    return get_config("qwen2-0.5b", reduced=True)


def test_train_loss_decreases():
    cell = ShapeCell("t", 64, 4, "train")
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12)
    m = train_loop(_cfg(), cell, TrainLoopConfig(steps=12, log_every=100),
                   opt_cfg=opt, seed=0, device="cpu")
    assert np.isfinite(m["loss"]) and m["final_step"] == 12.0
    m1 = train_loop(_cfg(), cell, TrainLoopConfig(steps=1, log_every=100),
                    opt_cfg=opt, seed=0, device="cpu")
    assert m["loss"] < m1["loss"] - 0.2, (m["loss"], m1["loss"])


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_checkpoint_restart_exact_resume(tmp_path, fmt):
    """10 steps straight, and 5 + a new ``train_loop`` call resuming from
    the step-5 checkpoint: the same final loss, bit for bit on the CPU
    (the reference's test allows 5e-3), with either moment format (the
    reference's loop restores fp32 moments only)."""
    cell = ShapeCell("t", 32, 4, "train")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                      state_format=fmt)
    m_full = train_loop(_cfg(), cell, TrainLoopConfig(
        steps=10, ckpt_dir=str(tmp_path / "a"), ckpt_every=5,
        log_every=100), opt_cfg=opt, seed=0, device="cpu")
    d2 = str(tmp_path / "b")
    train_loop(_cfg(), cell, TrainLoopConfig(steps=5, ckpt_dir=d2,
                                             ckpt_every=5, log_every=100),
               opt_cfg=opt, seed=0, device="cpu")
    m_resumed = train_loop(_cfg(), cell, TrainLoopConfig(
        steps=10, ckpt_dir=d2, ckpt_every=5, log_every=100), opt_cfg=opt,
        seed=0, device="cpu")
    assert m_full["loss"] == m_resumed["loss"]
    assert m_resumed["final_step"] == 10.0


def test_reference_does_not_resume_int8_moments(tmp_path):
    """ROADMAP C13, the reference's side: its ``train_loop`` shapes the
    restore template's moments like the float32 parameters, while int8
    moments are saved as ``{"q", "s"}``, so resuming them raises
    ``KeyError`` in ``repro/checkpoint/store.py``'s ``load_checkpoint``
    (the port's side is ``test_checkpoint_restart_exact_resume[int8]``)."""
    cell = RefShapeCell("t", 32, 4, "train")
    opt = RefAdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                         state_format="int8")
    d = str(tmp_path / "ref")
    ref_train_loop(ref_get_config("qwen2-0.5b", reduced=True), cell,
                   RefTrainLoopConfig(steps=1, ckpt_dir=d, ckpt_every=1,
                                      log_every=100), opt_cfg=opt)
    with pytest.raises(KeyError, match="opt/m/") as err:
        ref_train_loop(ref_get_config("qwen2-0.5b", reduced=True), cell,
                       RefTrainLoopConfig(steps=2, ckpt_dir=d, ckpt_every=1,
                                          log_every=100), opt_cfg=opt)
    last = err.traceback[-1]
    assert str(last.path).endswith("repro/checkpoint/store.py")
    assert last.name == "load_checkpoint"


def test_grad_accum_equivalence():
    """grad_accum=2 gives (numerically close) the same loss."""
    cell = ShapeCell("t", 32, 4, "train")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)
    m1 = train_loop(_cfg(), cell, TrainLoopConfig(steps=3, log_every=100),
                    opt_cfg=opt, seed=0, device="cpu")
    m2 = train_loop(dataclasses.replace(_cfg(), grad_accum=2), cell,
                    TrainLoopConfig(steps=3, log_every=100), opt_cfg=opt,
                    seed=0, device="cpu")
    assert abs(m1["loss"] - m2["loss"]) < 5e-2, (m1["loss"], m2["loss"])


def _close(got, want, path, tol=STEP_TOL):
    w = np.asarray(want, np.float64)
    np.testing.assert_allclose(got.double().numpy(), w, rtol=tol,
                               atol=tol * max(np.abs(w).max(), 1e-30),
                               err_msg=path)


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_the_reference(grad_accum, fmt):
    cfg = dataclasses.replace(ref_get_config("qwen2-0.5b", reduced=True),
                              grad_accum=grad_accum)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, state_format=fmt)
    ref_step = ref_make_train_step(RefLM(cfg), RefAdamWConfig(**kw))
    params = reference_params(cfg)
    first = train_batch(cfg, seed=2)
    params, state, _ = ref_step(params, ref_adamw_init(params, fmt),
                                {k: jnp.asarray(v) for k, v in first.items()})
    batch = train_batch(cfg, seed=5)
    want_p, want_s, want_m = ref_step(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(LM(convert.model_config_from_reference(cfg)),
                           AdamWConfig(**kw))
    got_p, got_s, got_m = step(
        convert.params_from_reference(params, "cpu"),
        convert.opt_state_from_reference(state, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got_m) == sorted(want_m)
    for name in got_m:
        np.testing.assert_allclose(float(got_m[name]), float(want_m[name]),
                                   rtol=1e-6, err_msg=name)
    want = dict(tree_leaves(want_p))
    for path, g in tree_leaves(got_p):
        assert not g.requires_grad and g.grad_fn is None, path
        _close(g, want[path], path, PARAM_TOL)
    assert int(got_s["step"]) == 2
    for name in ("m", "v"):
        want = dict(tree_leaves(want_s[name]))
        for path, g in tree_leaves(got_s[name]):
            if path.endswith("/q"):
                assert np.abs(g.numpy().astype(int) - want[path]).max() <= 1
            else:
                _close(g, want[path], f"{name}/{path}")


def test_entry_point_runs_on_the_cpu_when_asked(capsys, tmp_path):
    train_mod.main(["--reduced", "--steps", "2", "--batch", "2", "--seq",
                    "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                    "--ckpt-every", "2"])
    assert "'final_step': 2.0" in capsys.readouterr().out
    assert (tmp_path / "step_00000002" / "manifest.json").exists()


def test_entry_point_refuses_a_mesh_and_defaults_to_cuda():
    with pytest.raises(RuntimeError, match="--model 2 needs 2 ranks.*"
                       "torchrun --nproc-per-node 2"):
        train_mod.main(["--reduced", "--model", "2", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        train_mod.main(["--reduced", "--data", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_loop(_cfg(), ShapeCell("t", 16, 2, "train"),
                       TrainLoopConfig(steps=1))
