"""``repro_torch.{optim,data,checkpoint}`` vs ``repro.{optim,data,checkpoint}``
on the CPU, and the manager tests of ``tests/test_substrate.py`` on the
port.

* AdamW: one ``adamw_update`` from the same state (moments made by two
  reference steps; fp32 and int8 formats) equal to the reference's: new
  parameters within ``rtol 1e-6`` / ``atol 1e-6 * max``, fp32 moments
  within ``rtol 1e-6``, int8 moments within one quantization step (``q``
  within 1 where the two sides land on either side of a rounding
  boundary, ``s`` within ``rtol 1e-6``), ``lr`` and ``grad_norm`` within
  ``rtol 1e-6``.  The two frameworks evaluate the same fp32 expressions
  (``pow``, ``sqrt``, ``cos`` may differ by an ulp).
* Data: batches bit-equal to the reference's, resume and host sharding.
* Checkpoints: the reference's on-disk format both ways (bf16 params and
  int8 moments included), atomic saves, retention, emergency saves.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro.data import DataConfig as RefDataConfig
from repro.data import make_train_batches as ref_batches
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine

from repro_torch import convert
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, reshard_tree,
                                    save_checkpoint)
from repro_torch.data import DataConfig, make_train_batches
from repro_torch.data.pipeline import SyntheticTextSource
from repro_torch.trees import tree_leaves
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm)

RTOL = 1e-6


def _tree(rng, dtype=np.float32):
    """A parameter-shaped tree: matrices, a stacked 3-D leaf, a vector and
    a scalar."""
    return {"w": rng.standard_normal((6, 10)).astype(dtype),
            "blocks": {"k": rng.standard_normal((2, 5, 8)).astype(dtype),
                       "b": rng.standard_normal((8,)).astype(dtype)},
            "gate": np.asarray(rng.standard_normal(), dtype)}


def _assert_tree_close(got, want, rtol=RTOL, what=""):
    want = dict(tree_leaves(want))
    for path, g in tree_leaves(got):
        w = np.asarray(want[path], np.float64)
        np.testing.assert_allclose(
            g.double().numpy(), w, rtol=rtol,
            atol=rtol * max(np.abs(w).max(), 1e-30), err_msg=f"{what}{path}")


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
@pytest.mark.parametrize("weight_decay,clip_norm", [(0.1, 1.0), (0.0, 0.5)])
def test_adamw_update_matches_the_reference(fmt, weight_decay, clip_norm):
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, state_format=fmt,
              weight_decay=weight_decay, clip_norm=clip_norm)
    params = jax.tree.map(jnp.asarray, _tree(rng))
    state = ref_adamw_init(params, fmt)
    for _ in range(2):                   # moments that are not zero
        params, state, _ = ref_adamw_update(
            RefAdamWConfig(**kw), params,
            jax.tree.map(jnp.asarray, _tree(rng)), state)
    grads = _tree(rng)
    want_p, want_s, want_m = ref_adamw_update(
        RefAdamWConfig(**kw), params, jax.tree.map(jnp.asarray, grads),
        state)
    got_p, got_s, got_m = adamw_update(
        AdamWConfig(**kw), convert.params_from_reference(params, "cpu"),
        convert.params_from_reference(grads, "cpu"),
        convert.opt_state_from_reference(state, "cpu"))
    _assert_tree_close(got_p, want_p, what="params/")
    for name in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(got_m[name]), float(want_m[name]),
                                   rtol=RTOL)
    assert int(got_s["step"]) == int(want_s["step"]) == 3
    assert got_s["step"].dtype == torch.int32
    if fmt == "fp32":
        for name in ("m", "v"):
            _assert_tree_close(got_s[name], want_s[name], what=f"{name}/")
        return
    for name in ("m", "v"):
        want = dict(tree_leaves(want_s[name]))
        for path, g in tree_leaves(got_s[name]):
            w = np.asarray(want[path])
            assert g.dtype == (torch.int8 if path.endswith("/q")
                               else torch.float32), path
            if path.endswith("/q"):
                assert np.abs(g.numpy().astype(int) - w).max() <= 1, path
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                           err_msg=path)


def test_adamw_keeps_the_parameter_type():
    p = {"w": torch.arange(32.0).reshape(4, 8).to(torch.bfloat16)}
    for fmt in ("fp32", "int8"):
        new, st, _ = adamw_update(AdamWConfig(state_format=fmt), p,
                                  {"w": torch.ones(4, 8)},
                                  adamw_init(p, fmt))
        assert new["w"].dtype == torch.bfloat16
        assert not torch.equal(new["w"], p["w"])


def test_adamw_matches_numpy_reference():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.05,
                      clip_norm=1e9, total_steps=100, min_lr_ratio=1.0)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    new_p, _, metrics = adamw_update(cfg, p, g, adamw_init(p))
    m = 0.1 * np.array([0.1, 0.2, -0.3])
    v = 0.05 * np.array([0.1, 0.2, -0.3]) ** 2
    mh, vh = m / 0.1, v / 0.05
    want = np.array([1.0, -2.0, 3.0]) - 1e-2 * (
        mh / (np.sqrt(vh) + 1e-8) + 0.05 * np.array([1.0, -2.0, 3.0]))
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)
    assert float(metrics["grad_norm"]) > 0


def test_adamw_clipping():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, clip_norm=0.1,
                      weight_decay=0.0)
    p = {"w": torch.ones(4)}
    new_p, _, metrics = adamw_update(cfg, p, {"w": torch.full((4,), 100.0)},
                                     adamw_init(p))
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(global_norm({"a": torch.full((4,), 100.0)})) == \
        pytest.approx(200.0)
    assert (new_p["w"] - 1.0).abs().max() < 0.02


def test_cosine_schedule_matches_the_reference():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                      min_lr_ratio=0.1)
    ref_cfg = RefAdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                             min_lr_ratio=0.1)
    for s in (0, 1, 5, 9, 10, 11, 37, 60, 109, 110, 200):
        np.testing.assert_allclose(
            float(cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32))),
            float(ref_cosine(ref_cfg, jnp.int32(s))), rtol=RTOL, atol=1e-7)
    lrs = [float(cosine_schedule(cfg, s)) for s in (0, 5, 10, 60, 110)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0) and 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1)


def test_adamw_int8_state_tracks_fp32():
    """Block-quantized moments converge close to fp32 Adam (the
    reference's test, gradients by ``torch.autograd``)."""
    gen = torch.Generator().manual_seed(0)
    w_true = torch.randn(8, 8, generator=gen)
    x = torch.randn(32, 8, generator=gen)
    y = x @ w_true

    def loss_fn(w):
        return torch.mean((x @ w - y) ** 2)

    finals = {}
    for fmt in ("fp32", "int8"):
        cfg = AdamWConfig(lr=5e-2, warmup_steps=0, weight_decay=0.0,
                          total_steps=100, min_lr_ratio=1.0,
                          state_format=fmt)
        p = {"w": torch.zeros(8, 8)}
        st = adamw_init(p, fmt)
        for _ in range(60):
            w = p["w"].requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(w), (w,))
            p, st, _ = adamw_update(cfg, {"w": w.detach()}, {"w": g}, st)
        finals[fmt] = float(loss_fn(p["w"]))
    assert finals["int8"] < 0.1
    assert finals["int8"] < finals["fp32"] * 20 + 0.05
    assert adamw_init({"w": torch.zeros(8, 8)}, "int8")["m"]["w"]["q"].dtype \
        == torch.int8


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed,hosts", [
    (500, 32, 4, 0, 1), (151936, 128, 8, 3, 1), (51865, 64, 8, 1, 2)])
def test_batches_bit_equal_to_the_reference(vocab, seq, batch, seed, hosts):
    for host in range(hosts):
        got = make_train_batches(DataConfig(vocab, seq, batch, seed=seed),
                                 host=host, num_hosts=hosts)
        want = ref_batches(RefDataConfig(vocab, seq, batch, seed=seed),
                           host=host, num_hosts=hosts)
        for _ in range(3):
            a, b = next(got), next(want)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_batches_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=500, seq_len=32, global_batch=4)
    it = make_train_batches(cfg)
    b2 = next(it)
    b1 = next(make_train_batches(cfg))
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])
    nxt = int(b2["next_doc"])
    b3 = next(it)
    b3r = next(make_train_batches(cfg, start_doc=nxt))
    np.testing.assert_array_equal(b3["tokens"], b3r["tokens"])
    s1, s2 = SyntheticTextSource(cfg), SyntheticTextSource(cfg)
    for i in (0, 7, 123):
        np.testing.assert_array_equal(s1.document(i), s2.document(i))


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _ckpt_tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)},
            "h": torch.linspace(-3, 3, 7).to(torch.bfloat16),
            "s": torch.tensor(7, dtype=torch.int32)}


def _assert_bits(got, want):
    for (path, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


def test_checkpoint_roundtrip(tmp_path):
    t = _ckpt_tree()
    save_checkpoint(str(tmp_path), 7, t, {"note": "x"})
    restored, meta = load_checkpoint(str(tmp_path), t, device="cpu")
    assert meta["note"] == "x" and latest_step(str(tmp_path)) == 7
    _assert_bits(restored, t)
    assert not os.path.exists(tmp_path / "step_00000007.tmp")


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _ckpt_tree())
    bad = dict(_ckpt_tree(), a=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="shape mismatch for a"):
        load_checkpoint(str(tmp_path), bad, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), bad, device="cpu")


def test_manager_async_retention_and_emergency(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save_async(s, _ckpt_tree(), {"step": s})
    mgr.wait()
    assert latest_step(str(tmp_path)) == 30
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert len(steps) == 2 and 10 not in steps
    path = mgr.save_emergency(31, _ckpt_tree(), {"step": 31})
    assert os.path.exists(os.path.join(path, "manifest.json"))
    _, meta = load_checkpoint(str(tmp_path), _ckpt_tree(), step=31,
                              device="cpu")
    assert meta["emergency"] is True


def test_manager_copies_before_the_caller_moves_on(tmp_path):
    """An async save writes the values of the moment it was asked for,
    though the caller overwrites its tensors right after."""
    mgr = CheckpointManager(str(tmp_path))
    t = _ckpt_tree()
    mgr.save_async(1, t)
    t["a"].fill_(-1.0)
    mgr.wait()
    restored, _ = load_checkpoint(str(tmp_path), t, device="cpu")
    _assert_bits(restored["a"], _ckpt_tree()["a"])


def test_reshard_tree_roundtrip():
    t = _ckpt_tree()
    _assert_bits(reshard_tree(t, "cpu"), t)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            reshard_tree(t, None)                 # cuda by default


def _train_state():
    """bf16 parameters and an int8 AdamW state after one reference step."""
    p = {"w": jnp.arange(32.0).reshape(4, 8).astype(jnp.bfloat16),
         "n": jnp.ones((8,), jnp.float32)}
    st = ref_adamw_init(p, "int8")
    p, st, _ = ref_adamw_update(RefAdamWConfig(lr=1e-2, warmup_steps=0,
                                               state_format="int8"), p,
                                {"w": jnp.ones((4, 8)), "n": jnp.ones(8)},
                                st)
    return {"params": p, "opt": st}


def test_a_reference_checkpoint_loads_in_the_port(tmp_path):
    state = _train_state()
    ref_save(str(tmp_path), 3, state, {"step": 3, "next_doc": 9})
    template = convert.params_from_reference(state, "cpu")
    got, meta = load_checkpoint(str(tmp_path), template, device="cpu")
    assert meta == {"step": 3, "next_doc": 9}
    _assert_bits(got, template)
    assert got["params"]["w"].dtype == torch.bfloat16
    assert got["opt"]["m"]["w"]["q"].dtype == torch.int8


def test_a_port_checkpoint_loads_in_the_reference(tmp_path):
    state = _train_state()
    port = convert.params_from_reference(state, "cpu")
    save_checkpoint(str(tmp_path), 4, port, {"step": 4})
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), state)
    got, meta = ref_load(str(tmp_path), template)
    assert meta == {"step": 4}
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(state)):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32),
                                      err_msg=str(path))
