"""The ``model`` mesh axis end to end: ``jitted_cell``'s train, prefill and
decode cells over a ``(data 2, model 2)`` mesh of 4 gloo ranks against the
unsharded steps (the port's ``(1, 1)``), for each of the six families at
reduced width (float32 parameters drawn from a seed):

* one training step: the loss, ce, aux, tokens and grad_norm within
  ``LOSS_RTOL``, every parameter after the step within ``PARAM_TOL``
  (qwen2 with fp32 and with int8 moments);
* prefill and 3 decode steps: the logits and the cache within ``1e-5``,
  the cache's placements after every step those it came with (the MoE
  serves 128 rows, so that each data rank's decode tokens hold whole
  groups of 64);
* the flash route's GQA mapping on a 4-way ``model`` axis at head dim 64
  (8 q over 2 kv heads: each rank's 2 q heads share one kv head; 12 over
  6: a rank's 3 q heads span two groups), train, prefill and decode; and
  on packed rows with their segment ids (each rank hands the kernel the
  whole ids);
* ``remat="dots"``: the selective-checkpoint policy still sees (and
  keeps) the matrix products, which are DTensors' ``aten.mm``;
* ``(pod 2, data 1, model 2)`` for qwen2 and whisper;
* a ``(data 1, model 1)`` mesh on one rank, which runs every ``constrain``
  site as ``DTensor`` redistributions that move nothing: the same bits as
  the unsharded steps (the card runs this path at full width), also on
  packed rows through the flash route with their ids.

Every process group lives in subprocesses with their own timeouts.
"""
import json

import numpy as np
import pytest

from _torch_dist import run_ranks

B, S = 4, 32
MOE_ROWS, MOE_SEQ = 128, 8
LOSS_RTOL, PARAM_TOL, LOGIT_TOL = 1e-5, 1e-5, 1e-5
DECODE_STEPS = 3
FAMILIES = ("qwen2-0.5b", "llama4-scout-17b-a16e", "mamba2-2.7b",
            "zamba2-2.7b", "llama-3.2-vision-11b", "whisper-base")
METRICS = ("loss", "ce", "aux", "tokens", "grad_norm")

_RANKS = """
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import DataConfig, make_train_batches
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (jitted_cell, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import LM
from repro_torch.trees import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.axes import gather, sharding_context

import repro_torch.models.lm as lm
from torch.utils.checkpoint import CheckpointPolicy

mesh = make_mesh(MESH)
out = {}
saved = []
_policy = lm._dots_policy


def counting_policy(ctx, op, *args, **kwargs):
    decision = _policy(ctx, op, *args, **kwargs)
    saved.append(decision == CheckpointPolicy.MUST_SAVE)
    return decision


lm._dots_policy = counting_policy


def extras(cfg, rows, gen):
    e = {}
    if cfg.family == "vlm":
        e["image_embeds"] = torch.randn(rows, cfg.num_image_tokens,
                                        cfg.d_model, generator=gen)
    if cfg.family == "encdec":
        e["frames"] = torch.randn(rows, cfg.num_frames, cfg.d_model,
                                  generator=gen)
    return e


def diff(got, want):
    return float((gather(got).float() - want.float()).abs().max())


for name, arch, over, fmts, *segments in CASES:
    segments = segments[0] if segments else SEGMENTS
    cfg = dataclasses.replace(get_config(arch, reduced=True), **over)
    model = LM(cfg)
    params = tree_map(lambda p: p.float(), model.init_params(
        torch.Generator().manual_seed(0), device="cpu"))
    batch = next(make_train_batches(DataConfig(
        cfg.vocab_size, S, B, seed=0, mean_doc_len=12, min_doc_len=4)))
    batch.pop("next_doc")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    batch.update(extras(cfg, B, torch.Generator().manual_seed(3)))
    if not segments:
        batch.pop("segment_ids")
    for fmt in fmts:
        opt = AdamWConfig(state_format=fmt)
        p1, _, want = make_train_step(model, opt)(
            params, adamw_init(params, fmt), batch)
        with sharding_context(mesh) as ctx:
            step, _ = jitted_cell(cfg, ShapeCell("t", S, B, "train"), ctx,
                                  opt)
        saved.clear()
        p2, _, got = step(params, adamw_init(params, fmt), batch)
        out[f"{name}/{fmt}/saved"] = sum(saved)
        for k in METRICS:
            out[f"{name}/{fmt}/{k}"] = [float(got[k]), float(want[k])]
        out[f"{name}/{fmt}/params"] = max(
            diff(a, b) for (_, a), (_, b) in zip(tree_leaves(p2),
                                                 tree_leaves(p1)))
    rows, seq = (MOE_ROWS, MOE_SEQ) if cfg.family == "moe" else (B, S)
    gen = torch.Generator().manual_seed(5)
    pre = {"tokens": torch.randint(0, cfg.vocab_size, (rows, seq),
                                   generator=gen),
           "positions": torch.arange(seq).repeat(rows, 1),
           **extras(cfg, rows, gen)}
    with sharding_context(mesh) as ctx:
        prefill, _ = jitted_cell(cfg, ShapeCell("p", seq, rows, "prefill"),
                                 ctx)
        decode, _ = jitted_cell(cfg, ShapeCell("d", seq, rows, "decode"),
                                ctx)
    logits, cache = make_prefill_step(model)(params, pre)
    d_logits, d_cache = prefill(params, pre)
    errs = [diff(d_logits, logits)]
    cache_errs = [max(diff(d_cache[k], v) for k, v in cache.items())]
    placed = {k: v.placements for k, v in d_cache.items()}
    kept = True
    for j in range(DECODE_STEPS):
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        index = torch.tensor(seq - DECODE_STEPS + j)
        logits, cache = make_decode_step(model)(params, cache, tok, index)
        d_logits, d_cache = decode(params, d_cache, tok, index)
        errs.append(diff(d_logits, logits))
        cache_errs.append(max(diff(d_cache[k], v) for k, v in cache.items()))
        kept &= {k: v.placements for k, v in d_cache.items()} == placed
    out[f"{name}/serve"] = errs
    out[f"{name}/cache"] = cache_errs
    out[f"{name}/kept"] = kept
    out[f"{name}/placements"] = sorted(
        (k, str(v)) for k, v in placed.items())
if RANK == 0:
    print(json.dumps(out))
"""


def _run(cases, mesh, world, segments=True):
    """Each case ``(name, arch, overrides, formats[, segments])`` on
    ``world`` ranks; a case's own ``segments`` overrides the run's."""
    outs = run_ranks(
        f"S, B = {S}, {B}\nMOE_ROWS, MOE_SEQ = {MOE_ROWS}, "
        f"{MOE_SEQ}\nDECODE_STEPS = {DECODE_STEPS}\nMETRICS = {METRICS!r}\n"
        f"MESH = {mesh!r}\nCASES = {cases!r}\nSEGMENTS = {segments!r}\n"
        + _RANKS, world, timeout=240)
    return json.loads(outs[0].strip().splitlines()[-1])


@pytest.fixture(scope="module")
def families():
    cases = [(a, a, {}, ["fp32", "int8"] if a == "qwen2-0.5b" else ["fp32"])
             for a in FAMILIES]
    cases.append(("qwen2-dots", "qwen2-0.5b", {"remat": "dots"}, ["fp32"]))
    return _run(cases, {"data": 2, "model": 2}, 4)


def _check_train(got, name, fmt):
    for k in METRICS:
        a, b = got[f"{name}/{fmt}/{k}"]
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=f"{name} {fmt} {k}")
    assert got[f"{name}/{fmt}/params"] <= PARAM_TOL, name


def _check_serve(got, name):
    assert len(got[f"{name}/serve"]) == DECODE_STEPS + 1
    assert max(got[f"{name}/serve"]) <= LOGIT_TOL, got[f"{name}/serve"]
    assert max(got[f"{name}/cache"]) <= LOGIT_TOL, got[f"{name}/cache"]
    assert got[f"{name}/kept"], got[f"{name}/placements"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_on_data_2_model_2_matches_one_device(families, arch):
    _check_train(families, arch, "fp32")
    if arch.startswith("llama4"):
        assert families[f"{arch}/fp32/aux"][0] > 0


def test_qwen2_int8_moments_on_data_2_model_2_match_one_device(families):
    _check_train(families, "qwen2-0.5b", "int8")


def test_remat_dots_keeps_the_products_of_dtensors(families):
    """``remat="dots"``: the selective-checkpoint policy sees the layers'
    matrix products as the DTensors' ``aten.mm`` (and keeps them), and the
    step is still the unsharded one's."""
    _check_train(families, "qwen2-dots", "fp32")
    assert families["qwen2-dots/fp32/saved"] > 0
    assert families["qwen2-0.5b/fp32/saved"] == 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_on_data_2_model_2_match_one_device(families,
                                                               arch):
    _check_serve(families, arch)
    # the KV caches split their sequence over model, the rows over data
    for key, placed in families[f"{arch}/placements"]:
        if key in ("k", "v", "shared_k", "shared_v", "cross_k", "cross_v"):
            assert placed == "(Shard(dim=1), Shard(dim=2))", (key, placed)


@pytest.fixture(scope="module")
def gqa():
    over = {"head_dim": 64, "num_heads": 8, "num_kv_heads": 2}
    cases = [("gqa8x2", "qwen2-72b", over, ["fp32"]),
             ("gqa12x6", "qwen2-72b", dict(over, num_heads=12,
                                          num_kv_heads=6), ["fp32"]),
             # packed rows: self attention takes the flash route with ids
             ("gqa8x2-ids", "qwen2-72b", over, ["fp32"], True)]
    # no segment ids: self attention takes the flash route
    return _run(cases, {"data": 1, "model": 4}, 4, segments=False)


@pytest.mark.parametrize("name", ["gqa8x2", "gqa12x6"])
def test_flash_route_on_local_heads_matches_one_device(gqa, name):
    _check_train(gqa, name, "fp32")
    _check_serve(gqa, name)


def test_flash_route_with_segment_ids_on_local_heads_matches_one_device(
        gqa):
    """The ids are per row: every rank hands them whole to the kernel with
    its own q heads."""
    _check_train(gqa, "gqa8x2-ids", "fp32")
    _check_serve(gqa, "gqa8x2-ids")


@pytest.fixture(scope="module")
def pod():
    cases = [(a, a, {}, ["fp32"]) for a in ("qwen2-0.5b", "whisper-base")]
    return _run(cases, {"pod": 2, "data": 1, "model": 2}, 4)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-base"])
def test_pod_data_model_mesh_matches_one_device(pod, arch):
    """``(pod 2, data 1, model 2)``: the rows split over ``pod``, the rest
    as on ``(data, model)``."""
    _check_train(pod, arch, "fp32")
    _check_serve(pod, arch)


@pytest.fixture(scope="module")
def one_rank():
    cases = [(a, a, {"head_dim": 64} if a == "whisper-base" else {},
              ["fp32"]) for a in ("qwen2-0.5b", "whisper-base")]
    # packed rows at head dim 64: the flash route with the ids
    cases.append(("qwen2-64", "qwen2-0.5b", {"head_dim": 64}, ["fp32"], True))
    return _run(cases, {"data": 1, "model": 1}, 1, segments=False)


def test_model_1_mesh_with_segment_ids_gives_the_unsharded_bits(one_rank):
    """qwen2 at head dim 64 on packed rows: the flash route with the ids
    on a (data 1, model 1) mesh, the same bits as the unsharded step."""
    for k in METRICS:
        a, b = one_rank[f"qwen2-64/fp32/{k}"]
        assert a == b, (k, a, b)
    assert one_rank["qwen2-64/fp32/params"] == 0.0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-base"])
def test_model_1_mesh_gives_the_unsharded_bits(one_rank, arch):
    for k in METRICS:
        a, b = one_rank[f"{arch}/fp32/{k}"]
        assert a == b, (k, a, b)
    assert one_rank[f"{arch}/fp32/params"] == 0.0
    assert max(one_rank[f"{arch}/serve"]) == 0.0
    assert max(one_rank[f"{arch}/cache"]) == 0.0
    assert one_rank[f"{arch}/kept"]
