"""``repro_torch.models`` vs ``repro.models``: the model pieces and the
dense LM slice (prefill through the flash route, then decode), on the same
parameters carried across from the reference.

The slice's config is qwen2-0.5b's reduced config made narrow but with
``head_dim=64``, so prefill takes the flash route on both sides (the
reduced config's ``head_dim=8`` never reaches the kernel).  The reference
runs on the CPU, its attention through its own plain version (its Pallas
kernel is held against that in ``tests/test_kernels.py``); the port runs
on ``device="cpu"``, where the flash wrapper takes its plain version.

Tolerances:
  * float32 parameters on both sides: ``rtol = atol = 1e-5``.  The two
    frameworks sum the same products in other orders (matmul blocking,
    softmax, the flash route's online softmax on one side) and evaluate
    pow/exp/rsqrt with ulp-level differences; over two layers that moves
    logits of magnitude ~1 by ~4e-7 here.  1e-5 leaves a 25x margin and
    still catches any slip of semantics (a missing bias, a wrong rotation
    or mask shifts logits by >= 1e-3).
  * bfloat16 parameters: ``rtol = atol = 4e-2``, the tolerance of the
    reference's own prefill/decode test (``tests/test_models.py``).
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro.models import attention as ref_attention
from repro.models import common as ref_common

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, ShapeCell, get_config
from repro_torch.models.lm import PORTED_FAMILIES
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import LM, attention, common
from repro_torch.models.specs import train_batch_specs
from repro_torch.trees import tree_leaves

B, S = 2, 32
TIGHT = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=4e-2, atol=4e-2)


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _slice_config():
    return dataclasses.replace(
        ref_get_config("qwen2-0.5b", reduced=True), num_heads=2,
        num_kv_heads=1, head_dim=64, d_model=128, use_pallas=True)


@pytest.fixture(scope="module")
def slice_models():
    cfg_ref = _slice_config()
    ref_model = RefLM(cfg_ref)
    params = ref_model.init_params(jax.random.PRNGKey(0))
    model = LM(convert.model_config_from_reference(cfg_ref))
    tokens = np.random.default_rng(0).integers(
        1, cfg_ref.vocab_size, (B, S + 8)).astype(np.int32)
    return ref_model, model, params, tokens


def _batch(tokens, n, port):
    pos = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    if port:
        return {"tokens": torch.from_numpy(tokens[:, :n]).long(),
                "positions": torch.from_numpy(pos)}
    return {"tokens": jnp.asarray(tokens[:, :n]), "positions": jnp.asarray(pos)}


def _pad_cache(cache, extra, port):
    if port:
        return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, extra))
                for k, v in cache.items()}
    return {k: jnp.pad(v, ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0)))
            for k, v in cache.items()}


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_the_reference(slice_models, dtype):
    ref_model, model, params, tokens = slice_models
    tol = TIGHT if dtype == "float32" else BF16
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tparams = convert.params_from_reference(params, device="cpu")
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)

    ref_logits, ref_cache = ref_model.prefill(params, _batch(tokens, S, False))
    logits, cache = prefill(tparams, _batch(tokens, S, True))
    assert logits.shape == (B, model.cfg.padded_vocab)
    assert logits.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(logits), _f32(ref_logits), **tol)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == ref_cache[name].shape
        np.testing.assert_allclose(_f32(cache[name]), _f32(ref_cache[name]),
                                   **tol)

    ref_cache = _pad_cache(ref_cache, 8, port=False)
    cache = _pad_cache(cache, 8, port=True)
    for t in range(S, S + 2):
        ref_logits, ref_cache = ref_model.decode_step(
            params, ref_cache, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        logits, cache = decode(tparams, cache,
                               torch.from_numpy(tokens[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(_f32(logits), _f32(ref_logits), **tol)
        np.testing.assert_allclose(_f32(cache["k"]), _f32(ref_cache["k"]),
                                   **tol)


def test_port_prefill_decode_consistency(slice_models):
    """The port's own decode equals its prefill one token longer
    (the reference's test_arch_prefill_decode_consistency), in bf16."""
    _, model, params, tokens = slice_models
    tparams = convert.params_from_reference(params, device="cpu")
    _, cache = model.prefill(tparams, _batch(tokens, S, True))
    cache = _pad_cache(cache, 8, port=True)
    for t in range(S, S + 2):
        logits, cache = model.decode_step(
            tparams, cache, torch.from_numpy(tokens[:, t:t + 1]).long(),
            torch.tensor(t))
        want, _ = model.prefill(tparams, _batch(tokens, t + 1, True))
        np.testing.assert_allclose(_f32(logits), _f32(want), **BF16)


def test_per_row_cache_index_equals_scalar(slice_models):
    """A (B,) cache index with every row at the same position is the
    scalar call (continuous batching's form of decode)."""
    _, model, params, tokens = slice_models
    tparams = convert.params_from_reference(
        jax.tree.map(lambda a: a.astype(jnp.float32), params), device="cpu")
    _, cache = model.prefill(tparams, _batch(tokens, S, True))
    cache = _pad_cache(cache, 2, port=True)
    other = {k: v.clone() for k, v in cache.items()}
    tok = torch.from_numpy(tokens[:, S:S + 1]).long()
    a, _ = model.decode_step(tparams, cache, tok, S)
    b, _ = model.decode_step(tparams, other, tok, torch.full((B,), S))
    assert torch.equal(a, b) and torch.equal(cache["k"], other["k"])


PORTED_ARCHS = [a for a in ARCH_IDS
                if get_config(a).family in PORTED_FAMILIES]


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_param_tree_names_and_shapes_match_the_reference(arch):
    ref_tree = RefLM(ref_get_config(arch, reduced=True)).abstract_params()
    tree = LM(get_config(arch, reduced=True)).abstract_params()
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_tree)
    leaves = tree_leaves(tree)
    assert [jax.tree_util.keystr(p) for p, _ in ref_leaves] == \
        ["".join(f"[{k!r}]" for k in path.split("/")) for path, _ in leaves]
    for (_, r), (_, t) in zip(ref_leaves, leaves):
        assert tuple(t.shape) == tuple(r.shape)
        assert str(t.dtype).replace("torch.", "") == str(r.dtype)
    assert LM(get_config(arch, reduced=True)).param_axes() == \
        RefLM(ref_get_config(arch, reduced=True)).param_axes()


def test_configs_equal_the_reference():
    """Every field but the reference's ``use_pallas`` (a route switch the
    port does not have) is carried over."""
    for arch in ARCH_IDS:
        for reduced in (False, True):
            ref = ref_get_config(arch, reduced)
            want = dataclasses.asdict(ref)
            assert want.pop("use_pallas") is False
            assert dataclasses.asdict(get_config(arch, reduced)) == want
            assert get_config(arch, reduced).param_count() == \
                ref.param_count()
            assert convert.model_config_from_reference(ref) == \
                get_config(arch, reduced)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-base"])
def test_other_families_say_they_are_not_ported(arch):
    """The last two families serve (``tests/test_torch_vlm_encdec.py``)
    and now train too: ``loss`` gives a finite objective from a training
    batch (its parity with the reference is
    ``tests/test_torch_train_loss.py``).  An unknown family is still
    refused."""
    assert arch in PORTED_ARCHS
    cfg = get_config(arch, reduced=True)
    model = LM(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    specs, _ = train_batch_specs(cfg, ShapeCell("t", 4, 1, "train"))
    batch = {"tokens": torch.ones(1, 4, dtype=torch.long),
             "targets": torch.ones(1, 4, dtype=torch.long),
             "loss_mask": torch.ones(1, 4),
             "positions": torch.zeros(1, 4, dtype=torch.int32),
             **{n: torch.zeros(d.shape, dtype=d.dtype) for n, d in
                specs.items() if n in ("image_embeds", "frames")}}
    loss, metrics = model.loss(params, batch)
    assert torch.isfinite(loss) and float(metrics["tokens"]) == 4.0
    with pytest.raises(ValueError, match="unknown family"):
        LM(dataclasses.replace(cfg, family="retrieval"))


def test_loss_says_it_is_not_ported():
    """Training is ported: ``loss`` of the dense family is the masked mean
    CE (about ln V at init) and needs the batch's ``targets``."""
    model = LM(get_config("qwen2-0.5b", reduced=True))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.ones(1, 4, dtype=torch.long),
             "positions": torch.zeros(1, 4, dtype=torch.int32)}
    with pytest.raises(KeyError, match="targets"):
        model.loss(params, batch)
    batch.update(targets=torch.ones(1, 4, dtype=torch.long),
                 loss_mask=torch.tensor([[1.0, 1.0, 0.0, 0.0]]))
    loss, metrics = model.loss(params, batch)
    assert float(metrics["tokens"]) == 2.0 and float(metrics["aux"]) == 0.0
    assert abs(float(loss) - np.log(model.cfg.vocab_size)) < 0.5


def test_init_params_is_seeded_and_follows_the_declarations():
    cfg = get_config("qwen2-0.5b", reduced=True)
    model = LM(cfg)
    a = model.init_params(torch.Generator().manual_seed(1), device="cpu")
    b = model.init_params(torch.Generator().manual_seed(1), device="cpu")
    for (path, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y), path
    assert (a["final_norm"] == 1).all() and (a["blocks"]["attn"]["bq"] == 0
                                             ).all()
    assert a["embed"].dtype == torch.bfloat16
    assert 0.01 < a["embed"].float().std() < 0.03


def test_materialized_tensors_are_freed_with_their_tree():
    """Nothing but the returned tree refers to the tensors
    ``materialize_tree`` makes: a leaf replaced in the tree (as a cast to
    float32 in place does) is freed at once, without waiting for the
    garbage collector."""
    defs = LM(get_config("qwen2-0.5b", reduced=True)).defs
    gc.disable()
    try:
        tree = common.materialize_tree(defs, torch.Generator().manual_seed(0),
                                       "cpu")
        ref = weakref.ref(tree["embed"])
        tree["embed"] = tree["embed"].float()
        assert ref() is None
    finally:
        gc.enable()


def test_entry_points_default_to_cuda():
    model = LM(get_config("qwen2-0.5b", reduced=True))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        convert.params_from_reference({"w": np.zeros(2, np.float32)})


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32) * 37, (2, 1))
    jx, jscale = (jnp.asarray(a).astype(dtype) for a in (x, scale))
    tx, tscale = (convert.tensor_from_reference(a, "cpu")
                  for a in (jx, jscale))
    tol = TIGHT if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(
        _f32(common.rmsnorm(tx, tscale)), _f32(ref_common.rmsnorm(jx, jscale)),
        **tol)
    got = common.rope(tx, torch.from_numpy(pos), 1e6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(
        _f32(got), _f32(ref_common.rope(jx, jnp.asarray(pos), 1e6)), **tol)


@pytest.mark.parametrize("length,d", [(16, 8), (1500, 512)])
def test_sinusoidal_positions(length, d):
    np.testing.assert_array_equal(
        common.sinusoidal_positions(length, d, device="cpu").numpy(),
        np.asarray(ref_common.sinusoidal_positions(length, d)))


@pytest.mark.parametrize("name", ["silu", "gelu", "squared_relu"])
def test_activations(name):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(
        common.activation_fn(name)(torch.from_numpy(x)).numpy(),
        np.asarray(ref_common.activation_fn(name)(jnp.asarray(x))), **TIGHT)


@pytest.mark.parametrize("route,d,chunk,segments", [
    ("flash", 64, 512, False), ("flash", 128, 512, False),
    ("plain", 16, 8, False), ("plain", 64, 16, True)])
def test_chunked_attention_both_routes(route, d, chunk, segments):
    rng = np.random.default_rng(d + chunk)
    q = rng.standard_normal((2, 32, 4, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, 32, 2, d)).astype(np.float32)
            for _ in range(2))
    seg = np.repeat(np.array([[1, 2], [1, 1]], np.int32), 16, axis=1)
    kw = {"segment_ids": seg} if segments else {}
    want = ref_attention.chunked_attention(
        *map(jnp.asarray, (q, k, v)), chunk=chunk,
        use_pallas=route == "flash",
        **{n: jnp.asarray(a) for n, a in kw.items()})
    got = attention.chunked_attention(
        *map(torch.from_numpy, (q, k, v)), chunk=chunk,
        **{n: torch.from_numpy(a) for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("index", ["scalar", "rows"])
def test_update_cache_and_decode_attention(index):
    rng = np.random.default_rng(9)
    ck, cv = (rng.standard_normal((3, 10, 2, 64)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((3, 1, 2, 64)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((3, 1, 4, 64)).astype(np.float32)
    ci = 6 if index == "scalar" else np.array([2, 9, 12], np.int32)
    jci = jnp.int32(ci) if index == "scalar" else jnp.asarray(ci)
    tci = ci if index == "scalar" else torch.from_numpy(ci)
    want_k, want_v = ref_attention.update_cache(
        *map(jnp.asarray, (ck, cv, kn, vn)), jci)
    got_k, got_v = attention.update_cache(
        *(torch.from_numpy(a.copy()) for a in (ck, cv, kn, vn)), tci)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    want = ref_attention.decode_attention(jnp.asarray(q), want_k, want_v, jci)
    got = attention.decode_attention(torch.from_numpy(q), got_k, got_v, tci)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
