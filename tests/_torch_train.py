"""Shared helpers of the ``test_torch_train_*`` and ``test_torch_flash_grad``
parity tests: a packed training batch from the reference's data pipeline,
the reference's parameters in float32, the port's loss and gradients on the
CPU, and the comparison of both with ``jax.value_and_grad`` of the
reference's ``LM.loss`` (tolerances in ``tests/test_torch_train_loss.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data import DataConfig, make_train_batches
from repro.models import LM as RefLM

from repro_torch import convert
from repro_torch.models import LM
from repro_torch.trees import tree_leaves

B, S = 2, 64
GATE = 0.5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
EXTRAS = ("image_embeds", "frames")     # in the parameters' type


def train_batch(cfg, seq=S, seed=0, segments=True):
    """A packed batch of the reference's pipeline (short documents, so
    each row holds several) as NumPy; a vlm's image embeddings and an
    encdec's frames drawn from the seed."""
    batch = next(make_train_batches(DataConfig(
        cfg.vocab_size, seq, B, seed=seed, mean_doc_len=12, min_doc_len=4)))
    batch.pop("next_doc")
    if not segments:
        batch.pop("segment_ids")
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.num_frames, cfg.d_model)).astype(np.float32)
    return batch


def reference_params(cfg):
    params = RefLM(cfg).init_params(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    if "cross" in params:
        params["cross"]["gate"] = jnp.full_like(params["cross"]["gate"],
                                                GATE)
    return params


def port_loss(cfg, params, batch):
    """The port's loss, metrics and ``{path: gradient}`` on the CPU."""
    model = LM(convert.model_config_from_reference(cfg))
    tparams = convert.params_from_reference(params, device="cpu")
    for _, leaf in tree_leaves(tparams):
        leaf.requires_grad_(True)
    loss, metrics = model.loss(tparams, {
        k: convert.tensor_from_reference(v, "cpu") for k, v in batch.items()})
    loss.backward()
    return (loss.detach(), {k: m.detach() for k, m in metrics.items()},
            {p: x.grad for p, x in tree_leaves(tparams)})


def check_against_reference(cfg, batch, params=None):
    params = reference_params(cfg) if params is None else params
    ref_model = RefLM(cfg)
    (want, want_m), want_g = jax.value_and_grad(ref_model.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = port_loss(cfg, params, batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    for name in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=name)
    want_g = dict(tree_leaves(want_g))
    assert sorted(grads) == sorted(want_g)
    for path, g in grads.items():
        w = np.asarray(want_g[path])
        assert g is not None and tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max() + 1e-12,
                                   err_msg=path)
    return float(want), want_m


def bf16_differences(arch):
    """The bf16 loss and gradients of both packages on ``train_batch``
    (the reference's bf16 parameters carried across as they are): the
    loss's relative difference and the gradient leaf furthest apart,
    relative to its largest entry.  Recorded, not gated: the two
    frameworks round bf16 products at other points."""
    from repro.configs import get_config
    cfg = get_config(arch, reduced=True)
    params = RefLM(cfg).init_params(jax.random.PRNGKey(0))
    if "cross" in params:
        params["cross"]["gate"] = jnp.full_like(params["cross"]["gate"],
                                                GATE)
    batch = {k: jnp.asarray(v, jnp.bfloat16) if k in EXTRAS else v
             for k, v in train_batch(cfg).items()}
    (want, _), want_g = jax.value_and_grad(RefLM(cfg).loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = port_loss(cfg, params, batch)
    want_g = dict(tree_leaves(want_g))
    errs = {p: float(np.abs(g.float().numpy() - np.asarray(
        want_g[p], np.float32)).max() / max(np.abs(np.asarray(
            want_g[p], np.float32)).max(), 1e-30)) for p, g in grads.items()}
    worst = max(errs, key=errs.get)
    return abs(float(loss) - float(want)) / abs(float(want)), worst, \
        errs[worst]


if __name__ == "__main__":
    # PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_torch_train.py
    from repro.configs import ARCH_IDS
    for a in ARCH_IDS:
        rel, leaf, err = bf16_differences(a)
        print(f"{a}: bf16 loss rel diff {rel:.3e}; worst gradient leaf "
              f"{leaf} at {err:.3e} of its largest entry", flush=True)
