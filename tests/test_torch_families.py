"""``repro_torch.models`` vs ``repro.models`` for the ``moe``, ``ssm`` and
``hybrid`` families: the MoE block, the SSD scan and the Mamba2 block, and
each family's LM (prefill, then decode) on the reduced configs, with the
reference's parameters carried across by ``convert.params_from_reference``;
their serving engine and C9 are in ``tests/test_torch_families_serve.py``.

The reference runs on the CPU (its attention through its plain path: the
reduced configs' head_dim of 16 never reaches a flash kernel on either
side); the port runs on ``device="cpu"``.

Tolerances, as in ``tests/test_torch_models.py``: float32 parameters
``rtol = atol = 1e-5`` (the frameworks sum the same products in other
orders; a slip of semantics — a dropped token kept, a wrong decay, a
missing skip term — moves logits by >= 1e-3), bfloat16 parameters the
reference's own ``4e-2``.

MoE routing ties: the port's top-k is tie-stable (the lower expert index
first, as ``jax.lax.top_k``); ``test_moe_router_ties_break_toward_the_lower_
expert`` routes every token on an all-zero router, where every choice is a
tie.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm

from repro_torch import convert
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import LM, moe, ssm

B, S = 2, 40                 # S > the reduced ssm_chunk (32): a padded chunk
TIGHT = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=4e-2, atol=4e-2)
ARCHS = ("llama4-scout-17b-a16e", "mamba2-2.7b", "zamba2-2.7b",
         "arctic-480b")
KV = ("k", "v", "shared_k", "shared_v")


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def family_model(request):
    cfg = ref_get_config(request.param, reduced=True)
    ref_model = RefLM(cfg)
    params = ref_model.init_params(jax.random.PRNGKey(0))
    model = LM(convert.model_config_from_reference(cfg))
    tokens = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    return ref_model, model, params, tokens


def _batch(tokens, n, port):
    pos = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    if port:
        return {"tokens": torch.from_numpy(tokens[:, :n]).long(),
                "positions": torch.from_numpy(pos)}
    return {"tokens": jnp.asarray(tokens[:, :n]),
            "positions": jnp.asarray(pos)}


def _pad_cache(cache, extra, port):
    """Room for ``extra`` more positions in the KV rows; the recurrent
    state has no sequence axis."""
    out = dict(cache)
    for name in KV:
        if name in cache:
            out[name] = (torch.nn.functional.pad(cache[name],
                                                 (0, 0, 0, 0, 0, extra))
                         if port else
                         jnp.pad(cache[name], ((0, 0), (0, 0), (0, extra),
                                               (0, 0), (0, 0))))
    return out


# ---------------------------------------------------------------------------
# each family's LM as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_the_reference(family_model, dtype):
    ref_model, model, params, tokens = family_model
    tol = TIGHT if dtype == "float32" else BF16
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tparams = convert.params_from_reference(params, device="cpu")
    prefill, decode = make_prefill_step(model), make_decode_step(model)

    ref_logits, ref_cache = ref_model.prefill(params,
                                              _batch(tokens, S, False))
    logits, cache = prefill(tparams, _batch(tokens, S, True))
    assert logits.shape == (B, model.cfg.padded_vocab)
    assert logits.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(logits), _f32(ref_logits), **tol)
    assert sorted(cache) == sorted(ref_cache)
    for name in cache:
        assert tuple(cache[name].shape) == ref_cache[name].shape, name
        assert str(cache[name].dtype) == f"torch.{ref_cache[name].dtype}"
        np.testing.assert_allclose(_f32(cache[name]), _f32(ref_cache[name]),
                                   **tol, err_msg=name)

    ref_cache = _pad_cache(ref_cache, 4, port=False)
    cache = _pad_cache(cache, 4, port=True)
    for t in range(S, S + 2):
        ref_logits, ref_cache = ref_model.decode_step(
            params, ref_cache, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        logits, cache = decode(tparams, cache,
                               torch.from_numpy(tokens[:, t:t + 1]).long(), t)
        np.testing.assert_allclose(_f32(logits), _f32(ref_logits), **tol)
        for name in cache:
            np.testing.assert_allclose(_f32(cache[name]),
                                       _f32(ref_cache[name]), **tol,
                                       err_msg=name)


def test_decode_updates_the_cache_in_place(family_model):
    """The port's deliberate divergence, for the recurrent state too: the
    caller's tensors are written and returned."""
    _, model, params, tokens = family_model
    tparams = convert.params_from_reference(params, device="cpu")
    _, cache = model.prefill(tparams, _batch(tokens, S, True))
    cache = _pad_cache(cache, 2, port=True)
    before = {n: c.clone() for n, c in cache.items()}
    ptrs = {n: c.data_ptr() for n, c in cache.items()}
    _, out = model.decode_step(tparams, cache,
                               torch.from_numpy(tokens[:, S:S + 1]).long(), S)
    assert out is cache
    for n, c in cache.items():
        assert c.data_ptr() == ptrs[n]
        assert not torch.equal(c, before[n]), n


def test_per_row_cache_index_equals_scalar(family_model):
    """A (B,) cache index with every row at the same position is the
    scalar call (continuous batching's form of decode)."""
    _, model, params, tokens = family_model
    tparams = convert.params_from_reference(
        jax.tree.map(lambda a: a.astype(jnp.float32), params), device="cpu")
    _, cache = model.prefill(tparams, _batch(tokens, S, True))
    cache = _pad_cache(cache, 2, port=True)
    other = {k: v.clone() for k, v in cache.items()}
    tok = torch.from_numpy(tokens[:, S:S + 1]).long()
    a, _ = model.decode_step(tparams, cache, tok, S)
    b, _ = model.decode_step(tparams, other, tok, torch.full((B,), S))
    assert torch.equal(a, b)
    for name in cache:
        assert torch.equal(cache[name], other[name]), name


def test_port_prefill_decode_consistency(family_model):
    """The port's own decode equals its prefill one token longer (the
    reference's test_arch_prefill_decode_consistency), in bf16."""
    _, model, params, tokens = family_model
    tparams = convert.params_from_reference(params, device="cpu")
    _, cache = model.prefill(tparams, _batch(tokens, S, True))
    cache = _pad_cache(cache, 4, port=True)
    for t in range(S, S + 2):
        logits, cache = model.decode_step(
            tparams, cache, torch.from_numpy(tokens[:, t:t + 1]).long(), t)
        want, _ = model.prefill(tparams, _batch(tokens, t + 1, True))
        np.testing.assert_allclose(_f32(logits), _f32(want), **BF16)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def _moe_case(arch, **over):
    cfg = dataclasses.replace(ref_get_config(arch, reduced=True), **over)
    lm = RefLM(cfg)
    p = jax.tree.map(lambda a: a[0].astype(jnp.float32),
                     lm.init_params(jax.random.PRNGKey(1))["blocks"]["moe"])
    return cfg, p


@pytest.mark.parametrize("case", [
    ("llama4-scout-17b-a16e", {}, (2, 32)),            # shared expert
    ("arctic-480b", {}, (2, 32)),                      # top-2, dense resid.
    ("llama4-scout-17b-a16e", {"capacity_factor": 0.25}, (2, 32)),  # drops
    ("arctic-480b", {"capacity_factor": 0.25}, (1, 48)),            # drops
    ("llama4-scout-17b-a16e", {"moe_group_size": 24}, (2, 20)),     # pads
])
def test_moe_ffn_matches_the_reference(case):
    arch, over, (b, s) = case
    cfg, p = _moe_case(arch, **over)
    x = np.random.default_rng(3).standard_normal((b, s, cfg.d_model)
                                                 ).astype(np.float32)
    want, want_aux = ref_moe.moe_ffn(p, jnp.asarray(x), cfg)
    tp = convert.params_from_reference(p, device="cpu")
    tcfg = convert.model_config_from_reference(cfg)
    got, aux = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    np.testing.assert_allclose(float(aux), float(want_aux), **TIGHT)
    if over.get("capacity_factor"):
        # capacity max(ceil(k*g/E*cf), 4) really drops tokens here: the
        # output differs from the same call with room for every token
        roomy, _ = moe.moe_ffn(tp, torch.from_numpy(x), dataclasses.replace(
            tcfg, capacity_factor=float(cfg.num_experts)))
        assert (roomy - got).abs().max() > 1e-3


def test_moe_router_ties_break_toward_the_lower_expert():
    cfg, p = _moe_case("arctic-480b")
    p = dict(p, router=jnp.zeros_like(p["router"]))
    x = np.random.default_rng(4).standard_normal((2, 16, cfg.d_model)
                                                 ).astype(np.float32)
    want, want_aux = ref_moe.moe_ffn(p, jnp.asarray(x), cfg)
    got, aux = moe.moe_ffn(convert.params_from_reference(p, device="cpu"),
                           torch.from_numpy(x),
                           convert.model_config_from_reference(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    np.testing.assert_allclose(float(aux), float(want_aux), **TIGHT)
    probs = np.full((3, 8), 0.125, np.float32)
    probs[1, [2, 5]] = 0.5
    vals, idx = jax.lax.top_k(jnp.asarray(probs), 3)
    tvals, tidx = moe.top_k_stable(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(vals))


# ---------------------------------------------------------------------------
# SSD and the Mamba2 block
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, bsz=2, s=45, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (bsz, s, h)).astype(np.float32)
    a_log = rng.standard_normal(h).astype(np.float32) * 0.5
    b, c = (rng.standard_normal((bsz, s, g, n)).astype(np.float32)
            for _ in range(2))
    init = rng.standard_normal((bsz, g, h // g, p, n)).astype(np.float32)
    return x, dt, a_log, b, c, init


@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked_equals_naive_and_the_reference(initial):
    """S = 45 over chunks of 16: the last chunk padded with zeros."""
    x, dt, a_log, b, c, init = _ssd_inputs(5)
    ref_args = tuple(map(jnp.asarray, (x, dt, a_log, b, c)))
    args = tuple(map(torch.from_numpy, (x, dt, a_log, b, c)))
    ri = jnp.asarray(init) if initial else None
    ti = torch.from_numpy(init) if initial else None
    y_ref, st_ref = ref_ssm.ssd_chunked(*ref_args, 16, initial_state=ri)
    y, st = ssm.ssd_chunked(*args, 16, initial_state=ti)
    y_n, st_n = ssm.ssd_naive(*args, initial_state=ti)
    y_rn, st_rn = ref_ssm.ssd_naive(*ref_args, initial_state=ri)
    for got, want in ((y, y_ref), (st, st_ref), (y_n, y_rn), (st_n, st_rn),
                      (y, y_n), (st, st_n)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4,
                                   atol=1e-4)
    assert st.dtype == torch.float32 and st.shape == st_ref.shape


def test_segsum_masks_above_the_diagonal():
    x = np.random.default_rng(6).standard_normal((2, 3, 8)).astype(np.float32)
    want = np.asarray(ref_ssm._segsum(jnp.asarray(x)))
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1]).all() and not np.isinf(
        got[..., 1, 0]).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TIGHT)


def test_ssd_decode_step_matches_the_reference():
    x, dt, a_log, b, c, init = _ssd_inputs(7, s=1)
    want = ref_ssm.ssd_decode_step(
        jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]), jnp.asarray(a_log),
        jnp.asarray(b[:, 0]), jnp.asarray(c[:, 0]), jnp.asarray(init))
    state = torch.from_numpy(init.copy())
    got = ssm.ssd_decode_step(
        torch.from_numpy(x[:, 0]), torch.from_numpy(dt[:, 0]),
        torch.from_numpy(a_log), torch.from_numpy(b[:, 0]),
        torch.from_numpy(c[:, 0]), state)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **TIGHT)
    assert torch.equal(state, torch.from_numpy(init))   # not written


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_mamba_block_prefill_and_decode_match_the_reference(arch):
    cfg = ref_get_config(arch, reduced=True)
    p = jax.tree.map(lambda a: a[1].astype(jnp.float32),
                     RefLM(cfg).init_params(jax.random.PRNGKey(2))["blocks"])
    tp = convert.params_from_reference(p, device="cpu")
    tcfg = convert.model_config_from_reference(cfg)
    x = np.random.default_rng(8).standard_normal((2, 37, cfg.d_model)
                                                 ).astype(np.float32)
    want, wst = ref_ssm.mamba_block(p, jnp.asarray(x[:, :36]), cfg)
    got, st = ssm.mamba_block(tp, torch.from_numpy(x[:, :36]), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(_f32(st[name]), _f32(wst[name]), **TIGHT)
    want, wst = ref_ssm.mamba_block(p, jnp.asarray(x[:, 36:]), cfg,
                                    state=wst)
    got, st = ssm.mamba_block(tp, torch.from_numpy(x[:, 36:]), tcfg,
                              state=st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(_f32(st[name]), _f32(wst[name]), **TIGHT)
    # a prompt shorter than the conv window: the state is left-padded
    want, wst = ref_ssm.mamba_block(p, jnp.asarray(x[:, :2]), cfg)
    got, st = ssm.mamba_block(tp, torch.from_numpy(x[:, :2]), tcfg)
    np.testing.assert_allclose(_f32(st["conv"]), _f32(wst["conv"]), **TIGHT)
