"""``repro_torch.models`` vs ``repro.models`` for the ``vlm``
(llama-3.2-vision) and ``encdec`` (whisper) families: prefill, every cache
leaf (``cross_k`` / ``cross_v`` included) and two decode steps, the cross
attention, whisper's encoder, and ``common.layernorm``.  Their serving
engine is in ``tests/test_torch_vlm_encdec_serve.py``.

The configs are the reduced ones with ``head_dim=64`` and, on the
reference's side, ``use_pallas=True``: every attention — self, encoder,
cross, and cross in decode at one query row — takes the Pallas flash kernel
in interpret mode there and the flash route's plain version in the port
(as ``tests/test_torch_models.py`` does for the dense slice).  Parameters
come from ``jax.random.PRNGKey(0)`` through
``convert.params_from_reference``.  The vlm's gates are declared zero
(``tanh(0) = 0``: its cross layers add nothing at init), so every vlm case
sets them to ``GATE`` on both sides first.

Tolerances, as in ``tests/test_torch_models.py``: float32 parameters
``rtol = atol = 1e-5``, bfloat16 the reference's own ``4e-2``.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro.models import common as ref_common
from repro.models import lm as ref_lm

from repro_torch import convert
from repro_torch.configs import ShapeCell, get_config
from repro_torch.kernels import ops as kops
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import LM, attention, common, lm
from repro_torch.models.specs import prefill_batch_specs

B, S = 2, 24
TIGHT = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=4e-2, atol=4e-2)
GATE = 0.5
ARCHS = ("llama-3.2-vision-11b", "whisper-base")
EXTRA = {"vlm": "image_embeds", "encdec": "frames"}
SELF_KV = ("k", "v")
# flash-route calls, (q rows, k rows, causal): count, per prefill and per
# decode step (the reduced configs: vlm 4 layers, 2 cross, 16 image
# tokens; whisper 2 + 2 layers, 32 frames)
FLASH_CALLS = {
    "vlm": ({(S, S, True): 4, (S, 16, False): 2}, {(1, 16, False): 2}),
    "encdec": ({(32, 32, False): 2, (S, S, True): 2, (S, 32, False): 2},
               {(1, 32, False): 2})}


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _config(arch):
    return dataclasses.replace(ref_get_config(arch, reduced=True),
                               head_dim=64, use_pallas=True)


def _gated(params, gate=GATE):
    """The reference's tree with every vlm gate set to ``gate``."""
    if "cross" not in params:
        return params
    cross = dict(params["cross"])
    cross["gate"] = jnp.full_like(cross["gate"], gate)
    return {**params, "cross": cross}


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg = _config(request.param)
    ref_model = RefLM(cfg)
    params = _gated(ref_model.init_params(jax.random.PRNGKey(0)))
    model = LM(convert.model_config_from_reference(cfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    # the extra input at its declared shape, values exact in bfloat16
    name = EXTRA[cfg.family]
    spec = prefill_batch_specs(model.cfg, ShapeCell("t", S, B, "prefill")
                               )[0][name]
    extra = np.array(jnp.asarray(rng.standard_normal(spec.shape),
                                 jnp.bfloat16).astype(jnp.float32))
    return ref_model, model, params, tokens, (name, extra)


def _batch(tokens, extra, n, port, dtype):
    pos = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    name, x = extra
    if port:
        return {"tokens": torch.from_numpy(tokens[:, :n]).long(),
                "positions": torch.from_numpy(pos),
                name: torch.from_numpy(x).to(getattr(torch, dtype))}
    return {"tokens": jnp.asarray(tokens[:, :n]),
            "positions": jnp.asarray(pos),
            name: jnp.asarray(x).astype(dtype)}


def _pad_self_kv(cache, extra, port):
    """Room for ``extra`` more positions in the self-attention KV rows;
    the cross caches keep their length."""
    out = dict(cache)
    for name in SELF_KV:
        out[name] = (torch.nn.functional.pad(cache[name],
                                             (0, 0, 0, 0, 0, extra))
                     if port else
                     jnp.pad(cache[name], ((0, 0), (0, 0), (0, extra),
                                           (0, 0), (0, 0))))
    return out


def _cast(params, dtype):
    return (jax.tree.map(lambda a: a.astype(jnp.float32), params)
            if dtype == "float32" else params)


# ---------------------------------------------------------------------------
# each family's LM as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_the_reference(models, dtype):
    ref_model, model, params, tokens, extra = models
    tol = TIGHT if dtype == "float32" else BF16
    params = _cast(params, dtype)
    tparams = convert.params_from_reference(params, device="cpu")
    prefill, decode = make_prefill_step(model), make_decode_step(model)

    ref_logits, ref_cache = ref_model.prefill(
        params, _batch(tokens, extra, S, False, dtype))
    logits, cache = prefill(tparams, _batch(tokens, extra, S, True, dtype))
    assert logits.shape == (B, model.cfg.padded_vocab)
    assert logits.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(logits), _f32(ref_logits), **tol)
    assert sorted(cache) == sorted(ref_cache) == [
        "cross_k", "cross_v", "k", "v"]
    for name in cache:
        assert tuple(cache[name].shape) == ref_cache[name].shape, name
        assert str(cache[name].dtype) == f"torch.{ref_cache[name].dtype}"
        np.testing.assert_allclose(_f32(cache[name]), _f32(ref_cache[name]),
                                   **tol, err_msg=name)

    ref_cache = _pad_self_kv(ref_cache, 4, port=False)
    cache = _pad_self_kv(cache, 4, port=True)
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


def test_decode_matches_prefill_one_token_longer(models):
    """The port's own decode (cross attention over the cached K/V at one
    query row) equals its prefill one token longer, float32."""
    _, model, params, tokens, extra = models
    tparams = convert.params_from_reference(_cast(params, "float32"),
                                            device="cpu")
    _, cache = model.prefill(tparams,
                             _batch(tokens, extra, S, True, "float32"))
    cache = _pad_self_kv(cache, 2, port=True)
    for t in range(S, S + 2):
        got, cache = model.decode_step(
            tparams, cache, torch.from_numpy(tokens[:, t:t + 1]).long(), t)
        want, _ = model.prefill(tparams,
                                _batch(tokens, extra, t + 1, True, "float32"))
        np.testing.assert_allclose(_f32(got), _f32(want), **TIGHT)


def test_cross_input_moves_the_logits(models):
    """The image embeddings or frames reach the logits, in prefill and in
    decode through the cross caches (with the vlm's gates non-zero; at
    their declared zero a vlm's logits do not depend on the image)."""
    _, model, params, tokens, (name, x) = models
    cfg = model.cfg
    for gate in ((GATE, 0.0) if cfg.family == "vlm" else (None,)):
        tparams = convert.params_from_reference(
            _cast(params if gate is None else _gated(params, gate),
                  "float32"), device="cpu")
        outs = []
        for scale in (1.0, -1.0):
            batch = _batch(tokens, (name, scale * x), S, True, "float32")
            logits, cache = model.prefill(tparams, batch)
            cache = _pad_self_kv(cache, 1, port=True)
            step, _ = model.decode_step(
                tparams, cache, torch.from_numpy(tokens[:, S:S + 1]).long(),
                S)
            outs.append((logits, step))
        (a, da), (b, db) = outs
        moved = min(float((a - b).abs().max()), float((da - db).abs().max()))
        if gate == 0.0:
            assert moved == 0.0
        else:
            assert moved > 1e-3, (cfg.name, gate, moved)


def test_per_row_cache_index_equals_scalar(models):
    _, model, params, tokens, extra = models
    tparams = convert.params_from_reference(_cast(params, "float32"),
                                            device="cpu")
    _, cache = model.prefill(tparams,
                             _batch(tokens, extra, S, True, "float32"))
    cache = _pad_self_kv(cache, 2, port=True)
    other = {k: v.clone() for k, v in cache.items()}
    tok = torch.from_numpy(tokens[:, S:S + 1]).long()
    a, _ = model.decode_step(tparams, cache, tok, S)
    b, _ = model.decode_step(tparams, other, tok, torch.full((B,), S))
    assert torch.equal(a, b)
    for name in cache:
        assert torch.equal(cache[name], other[name]), name


def test_decode_writes_self_kv_in_place_and_only_reads_cross(models):
    _, model, params, tokens, extra = models
    tparams = convert.params_from_reference(params, device="cpu")
    _, cache = model.prefill(tparams,
                             _batch(tokens, extra, S, True, "bfloat16"))
    cache = _pad_self_kv(cache, 2, port=True)
    before = {n: c.clone() for n, c in cache.items()}
    ptrs = {n: c.data_ptr() for n, c in cache.items()}
    _, out = model.decode_step(tparams, cache,
                               torch.from_numpy(tokens[:, S:S + 1]).long(), S)
    assert out is cache
    for n, c in cache.items():
        assert c.data_ptr() == ptrs[n]
        assert torch.equal(c, before[n]) == n.startswith("cross_"), n


def test_every_attention_takes_the_flash_route(models, monkeypatch):
    """Self, encoder and cross attention in prefill, and cross attention
    in decode (one query row), each one call of the flash kernel's
    wrapper; decode self attention is ``decode_attention``, as in the
    reference."""
    _, model, params, tokens, extra = models
    calls = collections.Counter()
    route = kops.flash_attention

    def counting(q, k, v, causal=True):
        calls[q.shape[2], k.shape[2], causal] += 1
        return route(q, k, v, causal=causal)

    monkeypatch.setattr(attention.kops, "flash_attention", counting)
    tparams = convert.params_from_reference(params, device="cpu")
    _, cache = model.prefill(tparams,
                             _batch(tokens, extra, S, True, "bfloat16"))
    per_prefill, per_step = FLASH_CALLS[model.cfg.family]
    assert calls == per_prefill
    calls.clear()
    model.decode_step(tparams, _pad_self_kv(cache, 1, port=True),
                      torch.from_numpy(tokens[:, S:S + 1]).long(), S)
    assert calls == per_step


def test_prefill_projects_the_cross_kv_once(models, monkeypatch):
    """The port's divergence: prefill projects the image embeddings (the
    encoder output) to the cross K/V once, for every cross layer at a
    time, and the layers read the caches it returns."""
    _, model, params, tokens, extra = models
    made = []
    stack = lm._cross_kv_from

    def counting(cfg, p_stack, src):
        made.append(stack(cfg, p_stack, src))
        return made[-1]

    monkeypatch.setattr(lm, "_cross_kv_from", counting)
    tparams = convert.params_from_reference(params, device="cpu")
    _, cache = model.prefill(tparams,
                             _batch(tokens, extra, S, True, "bfloat16"))
    assert len(made) == 1
    assert cache["cross_k"] is made[0][0] and cache["cross_v"] is made[0][1]


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_from_another_sequence(models, gated, dtype):
    """The reference's ``_cross_attention(kv_input=)`` (K/V projected in
    the layer, its prefill and training route) against the port's layer
    over the K/V that ``_cross_kv_from`` projects."""
    ref_model, model, params, tokens, (name, x) = models
    cfg = ref_model.cfg
    params = _cast(params, dtype)
    p = jax.tree.map(lambda a: a[0], params["cross"] if "cross" in params
                     else params["blocks"]["cross"])
    if gated and "gate" not in p:
        p = {**p, "gate": jnp.asarray(GATE, p["wq"].dtype)}
    rng = np.random.default_rng(3)
    h = jnp.asarray(rng.standard_normal((B, 5, cfg.d_model))).astype(dtype)
    src = jnp.asarray(x).astype(dtype)
    want = ref_lm._cross_attention(cfg, p, h, kv_input=src, gated=gated)
    tp = convert.params_from_reference(p, device="cpu")
    th, tsrc = (convert.tensor_from_reference(a, "cpu") for a in (h, src))
    ck, cv = lm._cross_kv_from(model.cfg, {k: v[None] for k, v in tp.items()
                                          if k in ("wk", "wv", "bk", "bv")},
                               tsrc)
    got = lm._cross_attention(model.cfg, tp, th, cached_kv=(ck[0], cv[0]),
                              gated=gated)
    tol = TIGHT if dtype == "float32" else BF16
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    assert float((got - th).abs().max()) > 1e-3     # it adds something


@pytest.mark.parametrize("head_dim", [16, 64])
def test_attention_over_kv_of_another_type(head_dim):
    """float32 queries over a bfloat16 cache (the serving engine's zero
    cross caches under float32 weights): the plain route (head dim 16)
    and the flash route (64) against the reference's two routes."""
    from repro.models import attention as ref_attention
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, 3, 4, head_dim)).astype(np.float32)
    k, v = (jnp.asarray(rng.standard_normal((B, 9, 2, head_dim)),
                        jnp.bfloat16) for _ in range(2))
    want = ref_attention.chunked_attention(jnp.asarray(q), k, v,
                                           causal=False, use_pallas=True)
    got = attention.chunked_attention(
        torch.from_numpy(q), *(convert.tensor_from_reference(a, "cpu")
                               for a in (k, v)), causal=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **TIGHT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_encoder_matches_the_reference(dtype):
    cfg = _config("whisper-base")
    ref_model = RefLM(cfg)
    params = _cast(ref_model.init_params(jax.random.PRNGKey(1)), dtype)
    rng = np.random.default_rng(4)
    frames = jnp.asarray(rng.standard_normal((B, cfg.num_frames,
                                              cfg.d_model))).astype(dtype)
    want = ref_model._encode(params, frames)
    model = LM(convert.model_config_from_reference(cfg))
    got = model._encode(convert.params_from_reference(params, device="cpu"),
                        convert.tensor_from_reference(frames, "cpu"))
    tol = TIGHT if dtype == "float32" else BF16
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_encdec_token_positions_are_clipped_into_the_table():
    cfg = get_config("whisper-base", reduced=True)
    model = LM(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    tokens = torch.tensor([[3, 3, 3]])
    h = model._embed(params, tokens, torch.tensor([[8191, 9000, -5]]))
    table = common.sinusoidal_positions(8192, cfg.d_model)
    base = params["embed"][3]
    for j, row in enumerate((8191, 8191, 0)):
        assert torch.equal(h[0, j], base + table[row].to(base.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(dtype):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 7, 96)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(96).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    jx, js, jb = (jnp.asarray(a).astype(dtype) for a in (x, scale, bias))
    got = common.layernorm(*(convert.tensor_from_reference(a, "cpu")
                             for a in (jx, js, jb)))
    want = ref_common.layernorm(jx, js, jb)
    assert str(got.dtype) == f"torch.{want.dtype}"
    tol = TIGHT if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
