"""MoE groups that span the batch's ranks.  The reference forms its MoE
groups over the whole batch's token list and lets GSPMD split them over
the data ranks; the port's ``models/moe.py`` forms the same groups, and a
rank whose tokens fill no whole group gathers the groups that hold them.

* ``group_span``: which global tokens a rank's rows are and which groups
  it routes, for whole, spanning and padded cases;
* reduced llama4-scout (top-1, a shared expert) and reduced arctic
  (top-2, a dense residual), both at ``moe_group_size`` 64, through
  ``jitted_cell`` on ``(data 2)`` (2 gloo ranks) and ``(data 2, model 2)``
  (4): decode at B = 8 (4 tokens a rank, one group of 8 over both ranks),
  prefill at B = 2, S = 48 (96 tokens: group 0 spans both ranks, group 1 is
  padded), and one training step at that shape (loss, aux, grad_norm, and
  the router's gradient, read from the first step's fp32 moment
  ``m = 0.1 * clip * g``).  Each is held within ``1e-5`` (relative; an
  array against its largest entry) of the port's unsharded step and within
  ``1e-4`` of the reference's ``jitted_cell`` on a ``(data 2)`` mesh of 2
  XLA host devices, both packages on the same NumPy inputs (the
  reference's parameters in float32) and configurations (``OVERRIDES``).

Every process group lives in subprocesses with their own timeouts; the
reference and the two port meshes run side by side.
"""
import concurrent.futures

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.data import DataConfig, make_train_batches

from repro_torch.models.moe import group_span
from repro_torch.trees import tree_leaves
from _torch_dist import run_ranks, run_reference
from _torch_train import reference_params

ARCHS = ("llama4-scout-17b-a16e", "arctic-480b")
MESHES = {"data2": ({"data": 2}, 2),
          "data2_model2": ({"data": 2, "model": 2}, 4)}
B, S = 2, 48                 # prefill and train: 48 tokens a rank
DECODE_B, CACHE_S = 8, 16    # decode: 4 tokens a rank
# in both packages: 48 positions in whole attention chunks (the reference's
# chunked attention fails on a ragged last chunk with segment ids, ROADMAP
# C11); a float32 KV cache (a bf16 one rounds each model rank's part of a
# decode step's attention sum on its own)
OVERRIDES = {"attn_chunk": 16, "kv_cache_dtype": "float32"}
PORT_RTOL, REF_RTOL = 1e-5, 1e-4
SCALARS = ("loss", "aux", "grad_norm")

# (local tokens, ranks, group size) -> per rank: (its global tokens, the
# groups it routes), the group size and the batch's group count
GEOMETRY = [
    # whole: 128 tokens a rank, two groups each
    ((128, 2, 64), [((0, 128), (0, 2)), ((128, 256), (2, 4))], 64, 4),
    # decode at B = 8 on 2 ranks: one group of 8 over both
    ((4, 2, 64), [((0, 4), (0, 1)), ((4, 8), (0, 1))], 8, 1),
    # prefill at 2 x 48: group 0 spans both ranks, group 1 is padded
    ((48, 2, 64), [((0, 48), (0, 1)), ((48, 96), (0, 2))], 64, 2),
    # 8 tokens on 16 ranks (decode_32k's rows on a data axis of 16)
    ((8, 16, 2048), [((8 * r, 8 * r + 8), (0, 1)) for r in range(16)],
     128, 1),
    # three ranks, groups of 4 over runs of 3: every rank's run crosses one
    ((3, 3, 4), [((0, 3), (0, 1)), ((3, 6), (0, 2)), ((6, 9), (1, 3))],
     4, 3),
    # one rank: its own groups, the last padded
    ((100, 1, 64), [((0, 100), (0, 2))], 64, 2),
]

_REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeCell
from repro.launch.mesh import make_mesh
from repro.launch.steps import jitted_cell
from repro.models import LM
from repro.optim import adamw_init
from repro.parallel.axes import sharding_context

ARCHS, B, S, DECODE_B, CACHE_S, OVERRIDES, DATA, OUT = eval(
    sys.argv[1])
out = {}
for arch in ARCHS:
    cfg = dataclasses.replace(get_config(arch, reduced=True), **OVERRIDES)
    data = np.load(DATA[arch])
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        LM(cfg).abstract_params())
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(data["p/" + "/".join(k.key for k in path)])
        for path, _ in flat])
    pick = lambda tag: {k[len(tag):]: jnp.asarray(v)
                        for k, v in data.items() if k.startswith(tag)}
    with sharding_context(make_mesh({"data": 2})) as ctx:
        train, _ = jitted_cell(cfg, ShapeCell("t", S, B, "train"), ctx)
        _, opt, m = train(jax.tree.map(jnp.copy, params), adamw_init(params),
                          pick("t/"))
        for k in ("loss", "aux", "grad_norm"):
            out[f"{arch}/{k}"] = np.float64(m[k])
        out[f"{arch}/router"] = np.asarray(
            opt["m"]["blocks"]["moe"]["router"])
        prefill, _ = jitted_cell(cfg, ShapeCell("p", S, B, "prefill"), ctx)
        logits, cache = prefill(params, pick("pre/"))
        out[f"{arch}/prefill_logits"] = np.asarray(logits, np.float32)
        out[f"{arch}/prefill_cache"] = np.stack(
            [np.asarray(cache[k], np.float32) for k in ("k", "v")])
        decode, _ = jitted_cell(cfg, ShapeCell("d", CACHE_S, DECODE_B,
                                               "decode"), ctx)
        logits, cache = decode(
            params, {k: jnp.asarray(data["d/" + k]) for k in ("k", "v")},
            jnp.asarray(data["d/tokens"]), jnp.int32(CACHE_S - 1))
        out[f"{arch}/decode_logits"] = np.asarray(logits, np.float32)
        out[f"{arch}/decode_cache"] = np.stack(
            [np.asarray(cache[k], np.float32) for k in ("k", "v")])
np.savez(OUT, **out)
"""

_PORT = """
import dataclasses
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (jitted_cell, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import LM
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.axes import gather, sharding_context
from repro_torch.trees import tree_unflatten

mesh = make_mesh(MESH)
out = {}


def record(tag, train, prefill, decode):
    _, opt, m = train
    for k in ("loss", "aux", "grad_norm"):
        out[f"{tag}/{k}"] = np.float64(m[k])
    out[f"{tag}/router"] = gather(opt["m"]["blocks"]["moe"]["router"]
                                  ).numpy()
    for kind, (logits, cache) in (("prefill", prefill), ("decode", decode)):
        out[f"{tag}/{kind}_logits"] = gather(logits).float().numpy()
        out[f"{tag}/{kind}_cache"] = torch.stack(
            [gather(cache[k]).float() for k in ("k", "v")]).numpy()


for arch in ARCHS:
    cfg = dataclasses.replace(get_config(arch, reduced=True), **OVERRIDES)
    model = LM(cfg)
    data = np.load(DATA[arch])
    params = tree_unflatten(model.abstract_params(), {
        k[2:]: torch.from_numpy(v) for k, v in data.items() if k[:2] == "p/"})
    pick = lambda tag: {k[len(tag):]: torch.from_numpy(v)
                        for k, v in data.items() if k.startswith(tag)}
    cache = {k: torch.from_numpy(data["d/" + k]) for k in ("k", "v")}
    tokens, index = torch.from_numpy(data["d/tokens"]), CACHE_S - 1
    with sharding_context(mesh) as ctx:
        train, _ = jitted_cell(cfg, ShapeCell("t", S, B, "train"), ctx)
        prefill, _ = jitted_cell(cfg, ShapeCell("p", S, B, "prefill"), ctx)
        decode, _ = jitted_cell(cfg, ShapeCell("d", CACHE_S, DECODE_B,
                                               "decode"), ctx)
    record(f"{arch}/mesh",
           train(params, adamw_init(params), pick("t/")),
           prefill(params, pick("pre/")),
           decode(params, {k: v.clone() for k, v in cache.items()}, tokens,
                  index))
    if RANK == 0:
        record(f"{arch}/one",
               make_train_step(model, AdamWConfig())(
                   params, adamw_init(params), pick("t/")),
               make_prefill_step(model)(params, pick("pre/")),
               make_decode_step(model)(params, cache, tokens, index))
if RANK == 0:
    np.savez(OUT, **out)
"""


def _inputs(arch: str, path: str) -> None:
    """The reference's float32 parameters, a packed training batch of its
    pipeline, prefill tokens and a decode step's tokens and cache, drawn
    from seeds, as one ``.npz``."""
    cfg = ref_get_config(arch, reduced=True)
    data = {f"p/{k}": np.asarray(v)
            for k, v in tree_leaves(reference_params(cfg))}
    batch = next(make_train_batches(DataConfig(
        cfg.vocab_size, S, B, seed=0, mean_doc_len=12, min_doc_len=4)))
    batch.pop("next_doc")
    data.update({f"t/{k}": v for k, v in batch.items()})
    rng = np.random.default_rng(1)
    data["pre/tokens"] = rng.integers(1, cfg.vocab_size, (B, S)
                                      ).astype(np.int32)
    data["pre/positions"] = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    data["d/tokens"] = rng.integers(1, cfg.vocab_size, (DECODE_B, 1)
                                    ).astype(np.int32)
    shape = (cfg.num_layers, DECODE_B, CACHE_S, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    for k in ("k", "v"):
        data[f"d/{k}"] = rng.standard_normal(shape).astype(np.float32)
    np.savez(path, **data)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_span")
    paths = {a: str(tmp / f"{a}.npz") for a in ARCHS}
    for arch, path in paths.items():
        _inputs(arch, path)
    outs = {name: str(tmp / f"{name}.npz") for name in ("ref", *MESHES)}
    with concurrent.futures.ThreadPoolExecutor(1 + len(MESHES)) as pool:
        jobs = [pool.submit(run_reference, _REFERENCE, 2, [repr(
            (ARCHS, B, S, DECODE_B, CACHE_S, OVERRIDES, paths,
             outs["ref"]))],
            timeout=300)]
        for name, (shape, world) in MESHES.items():
            jobs.append(pool.submit(run_ranks, (
                f"ARCHS, B, S = {ARCHS!r}, {B}, {S}\n"
                f"DECODE_B, CACHE_S = {DECODE_B}, {CACHE_S}\n"
                f"OVERRIDES = {OVERRIDES!r}\n"
                f"MESH, DATA = {shape!r}, {paths!r}\n"
                f"OUT = {outs[name]!r}\n") + _PORT, world, timeout=240))
        for job in jobs:
            job.result()
    return {name: dict(np.load(path)) for name, path in outs.items()}


def _close(got, want, rtol, what):
    if np.ndim(want) == 0:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7,
                                   err_msg=what)
    else:
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=rtol * np.abs(want).max(),
                                   err_msg=what)


@pytest.mark.parametrize("case", range(len(GEOMETRY)))
def test_group_span_geometry(case):
    (local, ranks, size), want, g, total = GEOMETRY[case]
    for rank, (tokens, groups) in enumerate(want):
        span = group_span(local, ranks, rank, size)
        assert (span.size, span.total, span.batch) == (g, total,
                                                       local * ranks)
        assert (span.tokens, span.groups) == (tokens, groups), rank
        # the groups hold the rank's tokens, and only the last is padded
        assert groups[0] * g <= tokens[0] < tokens[1] <= groups[1] * g
        assert groups[1] <= total
        assert span.whole == (ranks == 1 or local % g == 0)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_spanning_groups_match_the_port_on_one_device(runs, arch, mesh,
                                                      kind):
    got = runs[mesh]
    for k in (SCALARS + ("router",) if kind == "train"
              else (f"{kind}_logits", f"{kind}_cache")):
        _close(got[f"{arch}/mesh/{k}"], got[f"{arch}/one/{k}"], PORT_RTOL,
               f"{arch} {mesh} {k}")
    if kind == "train":
        assert got[f"{arch}/mesh/aux"] > 0
        assert np.abs(got[f"{arch}/mesh/router"]).max() > 0


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_spanning_groups_match_the_reference_mesh(runs, arch, mesh, kind):
    got, want = runs[mesh], runs["ref"]
    for k in (SCALARS + ("router",) if kind == "train"
              else (f"{kind}_logits", f"{kind}_cache")):
        _close(got[f"{arch}/mesh/{k}"], want[f"{arch}/{k}"], REF_RTOL,
               f"{arch} {mesh} {k}")
