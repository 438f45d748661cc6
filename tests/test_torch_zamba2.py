"""Zamba2-7B's block on the port (the ``zamba2`` family of
:class:`~repro_torch.configs.base.PublishedConfig`), at a smoke size on the
CPU:

* ``ssd_chunked`` and ``_causal_conv`` with segment ids restart at every
  document edge: equal to each document run alone and to ``ssd_naive``
  restarted there; without ids bit-equal to the code before ids existed
  (frozen below), and with one id a row bit-equal to no ids;
* the port's loss and every gradient against the benchmark's plain
  reference (``portbench/reference/zamba2.py``), packed and unpacked;
* the tied head against the untied one with ``lm_head = embed^T``;
* the plain reference against ``transformers``' ``Zamba2ForCausalLM``
  with the same weights (skipped where ``transformers`` is absent).

The JAX package has no such family, so nothing here compares with it.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import lm, lm_hybrid
from portbench.reference import zamba2 as ref
from repro_torch import obs
from repro_torch.configs import get_config, zamba2_7b
from repro_torch.configs.base import PublishedConfig
from repro_torch.models import ssm
from repro_torch.models.lm import LM
from repro_torch.trees import tree_leaves, tree_map, value_and_grad

ROOT = Path(__file__).resolve().parents[1]
BLOCKS = ["mamba", "hybrid", "mamba", "mamba", "hybrid", "mamba"]
SEED = 2**31 + 321


def smoke_config() -> dict:
    """The cell's configuration file at ``zamba2_7b.reduced()``'s sizes:
    six layers, two of them hybrid (one application of each shared
    block), ngroups 2, head dim 2 d / heads as published."""
    config = json.loads(
        (ROOT / "portbench/configs/zamba2-7b.json").read_text())
    config.update(
        hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
        attention_head_dim=32, attention_hidden_size=128,
        intermediate_size=96, ffn_hidden_size=96, vocab_size=512,
        mamba_d_state=16, mamba_headdim=16, n_mamba_heads=8, chunk_size=16,
        adapter_rank=8, num_hidden_layers=len(BLOCKS),
        layers_block_type=BLOCKS,
        hybrid_layer_ids=[i for i, b in enumerate(BLOCKS) if b == "hybrid"],
        run=dict(config["run"], attn_chunk=16, ce_chunk=32))
    return config


def packed_batch(config, rows=2, seq_len=64, mean=16) -> dict:
    feed = ref.batches(20240607, vocab=config["vocab_size"], seq_len=seq_len,
                       rows=rows, mean=mean, minimum=4)
    return {k: torch.as_tensor(v) for k, v in next(feed).items()}


def unpacked(batch: dict) -> dict:
    out = {k: v for k, v in batch.items() if k != "segment_ids"}
    rows, seq = out["tokens"].shape
    out["positions"] = torch.arange(seq).expand(rows, seq).contiguous()
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


# ---------------------------------------------------------------------------
# The scan and the conv with segment ids
# ---------------------------------------------------------------------------

def _frozen_segsum(x):
    cs = x.shape[-1]
    xc = torch.cumsum(x, x.dim() - 1)
    diff = xc[..., :, None] - xc[..., None, :]
    mask = torch.ones(cs, cs, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, float("-inf"))


def _frozen_ssd_chunked(x, dt, a_log, b, c, chunk,
                        initial_state: Optional[torch.Tensor] = None):
    """``ssd_chunked`` as it was before segment ids, for plain tensors."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk
    a = -torch.exp(a_log.float())

    def chunked(t, heads):
        t = t.unflatten(1, (nc, chunk))
        return t.unflatten(3, (g, hg)) if heads else t

    da = chunked(dt.float() * a, True)
    xf = chunked(x * dt[..., None], True).float()
    bc_ = chunked(b, False).float()
    cc_ = chunked(c, False).float()
    da_cum = torch.cumsum(da, 2)
    lmat = torch.exp(_frozen_segsum(da.permute(0, 1, 3, 4, 2)))
    scores = torch.einsum("bclgn,bcsgn->bcgls", cc_, bc_)
    y_diag = torch.einsum("bcgls,bcghls,bcsghp->bclghp", scores, lmat, xf)
    da_last = da_cum[:, :, -1:]
    decay_states = torch.exp(da_last - da_cum)
    states = torch.einsum("bclgn,bclgh,bclghp->bcghpn",
                          bc_, decay_states, xf)
    chunk_decay = torch.exp(da_last[:, :, 0])
    prev = (initial_state.float() if initial_state is not None
            else torch.zeros(bsz, g, hg, p, n, dtype=torch.float32))
    entering = []
    for ci in range(nc):
        entering.append(prev)
        prev = prev * chunk_decay[:, ci, ..., None, None] + states[:, ci]
    prev_states = torch.stack(entering, dim=1)
    state_decay = torch.exp(da_cum)
    y_off = torch.einsum("bclgn,bcghpn,bclgh->bclghp",
                         cc_, prev_states, state_decay)
    y = (y_diag + y_off).reshape(bsz, sp, h, p)[:, :s]
    return y.to(x.dtype), prev


def _frozen_causal_conv(u, w, bias):
    ksize = w.shape[0]
    out = u * w[-1]
    for i in range(1, ksize):
        j = min(i, u.shape[1])
        out = out + F.pad(u, (0, 0, j, -j)) * w[ksize - 1 - i]
    return out + bias


def _scan_inputs(bsz=2, s=50, h=4, p=8, g=2, n=6, dtype=torch.float32,
                 seed=0):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype)
    return (r(bsz, s, h, p), F.softplus(r(bsz, s, h)).to(dtype),
            r(h, scale=0.5), r(bsz, s, g, n, scale=0.5),
            r(bsz, s, g, n, scale=0.5))


# documents across and on chunk edges (chunk 16), a one-token document, a
# row with trailing padding and one id repeated after another id
IDS = torch.tensor([[1] * 16 + [2] * 9 + [3] + [4] * 14 + [0] * 10,
                    [5] * 7 + [6] * 20 + [5] * 23])


def _runs(row):
    ids = row.tolist()
    edges = [0] + [i for i in range(1, len(ids)) if ids[i] != ids[i - 1]]
    return list(zip(edges, edges[1:] + [len(ids)]))


def test_document_runs_rise_at_each_change_of_id():
    runs = ssm.document_runs(IDS)
    assert runs.dtype == torch.int32
    for r, row in enumerate(IDS):
        for k, (s0, s1) in enumerate(_runs(row)):
            assert (runs[r, s0:s1] == k).all()


@pytest.mark.parametrize("chunk", [16, 7])
def test_ssd_with_ids_is_each_document_alone(chunk):
    """fp32: the chunked scan restarted at each edge, against each
    stretch's scan run alone and the step-by-step recurrence restarted
    there (sum order only: 2e-5)."""
    x, dt, a_log, b, c = _scan_inputs()
    y, state = ssm.ssd_chunked(x, dt, a_log, b, c, chunk, segment_ids=IDS)
    for r, row in enumerate(IDS):
        for s0, s1 in _runs(row):
            part = (t[r:r + 1, s0:s1] for t in (x, dt, b, c))
            xs, dts, bs, cs = part
            alone, last = ssm.ssd_chunked(xs, dts, a_log, bs, cs, chunk)
            naive, _ = ssm.ssd_naive(xs, dts, a_log, bs, cs)
            torch.testing.assert_close(y[r:r + 1, s0:s1], alone,
                                       rtol=2e-5, atol=2e-5)
            torch.testing.assert_close(y[r:r + 1, s0:s1], naive,
                                       rtol=2e-5, atol=2e-5)
        # the final state is the last stretch's own
        torch.testing.assert_close(state[r:r + 1], last, rtol=2e-5,
                                   atol=2e-5)


def test_ssd_gradients_do_not_cross_a_document_edge():
    x, dt, a_log, b, c = (t.requires_grad_(True) for t in _scan_inputs())
    y, _ = ssm.ssd_chunked(x, dt, a_log, b, c, 16, segment_ids=IDS)
    y[0, 16:25].sum().backward()             # the second document's output
    for t in (x, dt, b, c):
        assert t.grad[0, :16].abs().max() == 0
        assert t.grad[0, 25:].abs().max() == 0
        assert t.grad[0, 16:25].abs().max() > 0
        assert t.grad[1].abs().max() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_without_ids_is_the_code_before_ids(dtype):
    x, dt, a_log, b, c = _scan_inputs(dtype=dtype)
    init = torch.randn(2, 2, 2, 8, 6,
                       generator=torch.Generator().manual_seed(3))
    for kwargs in ({}, {"initial_state": init}):
        want = _frozen_ssd_chunked(x, dt, a_log, b, c, 16, **kwargs)
        got = ssm.ssd_chunked(x, dt, a_log, b, c, 16, **kwargs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        one = ssm.ssd_chunked(x, dt, a_log, b, c, 16,
                              segment_ids=torch.ones(2, 50, dtype=torch.int32),
                              **kwargs)
        assert torch.equal(one[0], want[0]) and torch.equal(one[1], want[1])


def test_ssd_counts_the_calls_that_take_ids():
    before = ssm.ssd_chunked.segmented
    x, dt, a_log, b, c = _scan_inputs()
    ssm.ssd_chunked(x, dt, a_log, b, c, 16)
    assert ssm.ssd_chunked.segmented == before
    ssm.ssd_chunked(x, dt, a_log, b, c, 16, segment_ids=IDS)
    assert ssm.ssd_chunked.segmented == before + 1


def test_causal_conv_with_ids_is_each_document_alone():
    gen = torch.Generator().manual_seed(1)
    u = torch.randn(2, 50, 12, generator=gen)
    w, bias = torch.randn(4, 12, generator=gen), torch.randn(12, generator=gen)
    got = ssm._causal_conv(u, w, bias, IDS)
    for r, row in enumerate(IDS):
        for s0, s1 in _runs(row):
            alone = ssm._causal_conv(u[r:r + 1, s0:s1], w, bias)
            torch.testing.assert_close(got[r:r + 1, s0:s1], alone,
                                       rtol=0, atol=1e-6)
    assert torch.equal(ssm._causal_conv(u, w, bias),
                       _frozen_causal_conv(u, w, bias))
    assert torch.equal(
        ssm._causal_conv(u, w, bias, torch.zeros(2, 50, dtype=torch.int32)),
        _frozen_causal_conv(u, w, bias))


def test_gate_norm_normalises_each_group():
    gen = torch.Generator().manual_seed(2)
    y, scale = torch.randn(3, 5, 32, generator=gen), torch.randn(32)
    got = ssm._gate_norm(y, scale, 2, 1e-5)
    halves = [y[..., :16], y[..., 16:]]
    want = torch.cat([h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + 1e-5)
                      for h in halves], -1) * scale
    torch.testing.assert_close(got, want)
    assert torch.equal(ssm._gate_norm(y, scale, 1, 1e-5),
                       ssm.rmsnorm(y, scale, 1e-5))


# ---------------------------------------------------------------------------
# The model against the plain reference
# ---------------------------------------------------------------------------

def _widened(config):
    """The seed's bfloat16 weights in the port's tree, widened to float32."""
    weights = lm_hybrid.draw(config, SEED, torch.device("cpu"))
    return tree_map(lambda x: x.float(), lm.nest(weights))


def _port_and_reference(config, batch):
    """Loss and gradient of every leaf: the port in float32 (the seed's
    bfloat16 weights widened), the reference (float32 throughout)."""
    weights = lm_hybrid.draw(config, SEED, torch.device("cpu"))
    model = LM(lm_hybrid.model_config(config))
    params = tree_map(lambda x: x.float(), lm.nest(weights))
    (loss, _), grads = value_and_grad(model.loss, params, batch)
    w = {k: x.float().requires_grad_(True) for k, x in weights.items()}
    want = ref.Model(config).loss(w, batch)
    want_grads = dict(zip(w, torch.autograd.grad(want, list(w.values()))))
    return loss, _flat(grads), want, want_grads


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_loss_and_every_gradient_match_the_reference(packed):
    """Float32 on both sides; they differ in sum order only (chunked
    against quadratic SSD, chunked against whole attention and CE):
    measured under 5e-6 of a leaf's norm, held to 1e-4."""
    config = smoke_config()
    batch = packed_batch(config)
    if not packed:
        batch = unpacked(batch)
    loss, grads, want, want_grads = _port_and_reference(config, batch)
    assert sorted(grads) == sorted(want_grads)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    for k, g in want_grads.items():
        gap = float((grads[k] - g).norm() / g.norm())
        assert gap < 1e-4, (k, gap)


def test_packing_isolates_documents():
    """A packed row's loss is the loss of its documents run one by one:
    changing the first document's tokens leaves the others' positions'
    hidden states exactly where the reference puts them."""
    config = smoke_config()
    batch = packed_batch(config)
    model = LM(lm_hybrid.model_config(config))
    params = _widened(config)
    seg = batch["segment_ids"][0]
    first = int((seg == seg[0]).sum())
    other = dict(batch, tokens=batch["tokens"].clone())
    other["tokens"][0, :first] = (other["tokens"][0, :first] + 7) % 500 + 2
    with torch.no_grad():
        h1 = model._backbone(params, batch["tokens"], batch["positions"],
                             batch["segment_ids"], "train")[0]
        h2 = model._backbone(params, other["tokens"], other["positions"],
                             other["segment_ids"], "train")[0]
    assert not torch.allclose(h1[0, :first], h2[0, :first])
    torch.testing.assert_close(h1[0, first:], h2[0, first:], rtol=0, atol=0)
    torch.testing.assert_close(h1[1], h2[1], rtol=0, atol=0)


def test_param_tree_is_the_benchmark_s_layout():
    """``portbench.lm_hybrid`` lays the seed's draw out in the port's leaf
    order and shapes; ``param_count`` counts every leaf, the tied head
    once."""
    config = smoke_config()
    cfg = lm_hybrid.model_config(config)
    tree = LM(cfg).abstract_params()
    assert [(p, tuple(s.shape)) for p, s in tree_leaves(tree)] == \
        [(p, shape) for p, shape, _ in lm_hybrid.leaves(config)]
    assert "lm_head" not in tree
    assert cfg.param_count() == sum(int(np.prod(s.shape))
                                    for _, s in tree_leaves(tree))
    small = zamba2_7b.reduced()
    assert small.param_count() == sum(
        int(np.prod(s.shape)) for _, s in
        tree_leaves(LM(small).abstract_params()))
    cut = dataclasses.replace(zamba2_7b.CONFIG, num_layers=12,
                              hybrid_layer_ids=(6, 11))
    assert cut.param_count() == 1_757_853_120
    assert zamba2_7b.CONFIG.param_count() == 7_356_749_648


def test_zamba2_trains_only():
    cfg = zamba2_7b.reduced()
    model = LM(cfg)
    with pytest.raises(NotImplementedError):
        model.cache_defs(1, 8)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.ones(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError):
        model.prefill(params, {"tokens": tokens,
                               "positions": torch.arange(8)[None]})


def test_spans_and_counter_of_a_recorded_step():
    """A recorded training step opens ``model.ssd`` (forward, remat's
    recompute, backward) in every layer and ``model.shared`` (forward and
    a backward that holds the recompute) for every application, and every
    scan of a packed step takes the segment ids."""
    config = smoke_config()
    batch = packed_batch(config)
    model = LM(lm_hybrid.model_config(config))
    params = _widened(config)
    before = ssm.ssd_chunked.segmented
    obs.reset()
    with obs.enable(), obs.span("launch.train_step"):
        value_and_grad(model.loss, params, batch)
    rec = obs.snapshot()["launch.train_step"][0]
    obs.reset()
    layers, apps = config["num_hidden_layers"], len(config["hybrid_layer_ids"])
    assert rec["model.ssd"].count == layers
    assert rec["model.ssd.recompute"].count == layers
    assert rec["model.ssd.backward"].count == layers
    assert rec["model.shared"].count == apps
    assert rec["model.shared.backward"].count == apps
    assert "model.shared.recompute" not in rec
    assert ssm.ssd_chunked.segmented - before == 2 * layers


# ---------------------------------------------------------------------------
# The tied head
# ---------------------------------------------------------------------------

def _tied_pair(cfg: PublishedConfig):
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    params = LM(untied).init_params(torch.Generator().manual_seed(5), "cpu")
    params = tree_map(lambda x: x.float(), params)
    tied = {k: v for k, v in params.items() if k != "lm_head"}
    params = dict(params, lm_head=params["embed"].t().contiguous())
    return LM(cfg), tied, LM(untied), params


@pytest.mark.parametrize("base", ["qwen2-0.5b", "zamba2-7b"])
def test_tied_head_is_the_untied_one_with_the_embedding_transposed(base):
    """Equal loss (float32; the two heads differ only in their memory
    layout: 1e-6), and the tied embedding's gradient is the untied
    embedding's plus the untied head's, transposed."""
    if base == "zamba2-7b":
        cfg = zamba2_7b.reduced()
        batch = packed_batch(smoke_config(), mean=12)
    else:
        cfg = PublishedConfig(**dataclasses.asdict(
            get_config(base, reduced=True)), tie_embeddings=True)
        batch = unpacked(packed_batch(smoke_config()))
    tied_model, tied, untied_model, untied = _tied_pair(cfg)
    assert "lm_head" not in tied_model.abstract_params()
    assert cfg.param_count() == dataclasses.replace(
        cfg, tie_embeddings=False).param_count() - (
            cfg.padded_vocab * cfg.d_model)
    (loss_t, _), g_t = value_and_grad(tied_model.loss, tied, batch)
    (loss_u, _), g_u = value_and_grad(untied_model.loss, untied, batch)
    torch.testing.assert_close(loss_t, loss_u, rtol=1e-6, atol=0)
    torch.testing.assert_close(g_t["embed"], g_u["embed"] + g_u["lm_head"].t(),
                               rtol=1e-5, atol=1e-7)
    for k in set(_flat(g_t)) - {"embed"}:
        torch.testing.assert_close(_flat(g_t)[k], _flat(g_u)[k],
                                   rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# The reference against the published code
# ---------------------------------------------------------------------------

def _published_state(config, w) -> dict:
    """``Zamba2ForCausalLM``'s state dict from the port's layout."""
    s = lm_hybrid.sizes(config)
    apps = {layer: a for a, layer in enumerate(config["hybrid_layer_ids"])}
    sd = {"model.embed_tokens.weight": w["embed"][:config["vocab_size"]],
          "model.final_layernorm.weight": w["final_norm"]}
    for i in range(config["num_hidden_layers"]):
        pre = f"model.layers.{i}." + ("mamba_decoder." if i in apps else "")

        def b(name):
            return w["blocks/" + name][i]
        sd[pre + "input_layernorm.weight"] = b("in_norm")
        mix = pre + "mamba."
        sd[mix + "in_proj.weight"] = torch.cat(
            [b("w_zx"), b("w_bc"), b("w_dt")], 1).t()
        sd[mix + "conv1d.weight"] = b("conv_w").t()[:, None, :]
        sd[mix + "conv1d.bias"] = b("conv_b")
        sd[mix + "dt_bias"], sd[mix + "A_log"] = b("dt_bias"), b("a_log")
        sd[mix + "D"], sd[mix + "norm.weight"] = b("d_skip"), b("gate_norm")
        sd[mix + "out_proj.weight"] = b("w_out").t()
        if i in apps:
            a = apps[i]
            k, sh = a % s["nb"], f"model.layers.{i}.shared_transformer."
            sd[sh + "input_layernorm.weight"] = w["shared/attn/norm"][k]
            for n in "qkvo":
                sd[sh + f"self_attn.{n}_proj.weight"] = \
                    w[f"shared/attn/w{n}"][k].t()
            ff = sh + "feed_forward."
            sd[sh + "pre_ff_layernorm.weight"] = w["shared/mlp/norm"][k]
            sd[ff + "gate_up_proj.weight"] = w["shared/mlp/w_gu"][k].t()
            sd[ff + "down_proj.weight"] = w["shared/mlp/wo"][k].t()
            sd[ff + f"gate_up_proj_adapter_list.{a}.0.weight"] = \
                w["hybrid/adapter_a"][a].t()
            sd[ff + f"gate_up_proj_adapter_list.{a}.1.weight"] = \
                w["hybrid/adapter_b"][a].t()
            sd[f"model.layers.{i}.linear.weight"] = w["hybrid/linear"][a].t()
    return sd


def test_reference_matches_the_published_model(monkeypatch):
    """The plain reference's logits against ``Zamba2ForCausalLM``'s
    (``transformers``' eager torch path, float32) on one unpacked row,
    with the seed's weights and the norms, biases, A_log and D moved off
    their initial values so that every mapping is exercised.  The same
    operations in another order: 1e-5 (measured 3e-7 on logits of 0.6)."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "Zamba2ForCausalLM"):
        pytest.skip(f"transformers {transformers.__version__} has no Zamba2")
    config = smoke_config()
    hcfg = transformers.Zamba2Config(
        vocab_size=config["vocab_size"], hidden_size=config["hidden_size"],
        num_hidden_layers=config["num_hidden_layers"],
        layers_block_type=config["layers_block_type"],
        mamba_d_state=config["mamba_d_state"],
        mamba_d_conv=config["mamba_d_conv"],
        mamba_expand=config["mamba_expand"],
        mamba_ngroups=config["mamba_ngroups"],
        n_mamba_heads=config["n_mamba_heads"],
        intermediate_size=config["intermediate_size"],
        num_attention_heads=config["num_attention_heads"],
        num_key_value_heads=config["num_key_value_heads"],
        num_mem_blocks=config["num_mem_blocks"],
        adapter_rank=config["adapter_rank"], use_mem_rope=True,
        use_shared_attention_adapter=False, use_shared_mlp_adapter=True,
        rope_theta=config["rope_theta"], rms_norm_eps=config["rms_norm_eps"],
        chunk_size=config["chunk_size"], attn_implementation="eager")
    assert hcfg.attention_head_dim == config["attention_head_dim"]
    assert hcfg.hybrid_layer_ids == config["hybrid_layer_ids"]
    torch.manual_seed(0)
    published = transformers.Zamba2ForCausalLM(hcfg).eval()
    w = {k: v.float()
         for k, v in lm_hybrid.draw(config, SEED, torch.device("cpu")).items()}
    gen = torch.Generator().manual_seed(1)
    for k in w:
        if any(s in k for s in ("norm", "dt_bias", "conv_b", "a_log",
                                "d_skip")):
            w[k] = w[k] + 0.1 * torch.randn(w[k].shape, generator=gen)
    missing, unexpected = published.load_state_dict(
        _published_state(config, w), strict=False)
    assert missing == ["lm_head.weight"] and not unexpected
    assert published.lm_head.weight is published.model.embed_tokens.weight
    tokens = torch.randint(2, config["vocab_size"], (1, 48), generator=gen)
    model = ref.Model(config)
    with torch.no_grad():
        want = published(input_ids=tokens).logits
        got = model.hidden(w, {"tokens": tokens}) @ model.head(w)
    torch.testing.assert_close(got[..., :config["vocab_size"]], want,
                               rtol=0, atol=1e-5)
