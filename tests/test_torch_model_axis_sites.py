"""The ``model`` mesh axis, site by site: at every ``constrain`` site of the
reference's models, the port's activation carries the placements of the
reference's ``spec_for`` for the same logical names and shape.

The reference's sites are recorded in this process: ``constrain`` of
``repro.models.{lm,attention,moe,common}`` is replaced by a recorder, and
``jax.eval_shape`` traces each family's ``loss``, ``prefill`` and
``decode_step`` at reduced width.  The port runs the same cells through
``jitted_cell`` on a ``(data 2, model 4)`` mesh of the ``fake`` process
group (one process standing for rank 0 of 8; its collectives move nothing,
so only shapes and placements are read), with ``constrain`` of
``repro_torch.models.{lm,attention,moe,common}`` wrapped to record each
call's logical names, shape and result placements.  The port's shapes are
a rank's: the ``batch`` dim (and the leading group dim of the MoE's
expert activations) holds half the rows.

Two more cases: qwen2's 7 reduced heads do not split 4 ways (its ``act_heads``
falls back and the attention's ``seq`` takes the axis), and the flash
route's GQA mapping: at head dim 64 with 8 q and 2 kv heads on a 4-way
``model`` axis, the kernel takes each rank's 2 q heads with the one kv head
they use.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest

import repro.models.attention as ref_attention
import repro.models.common as ref_common
import repro.models.lm as ref_lm
import repro.models.moe as ref_moe
from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro.parallel.axes import DEFAULT_RULES, spec_for

from _torch_dist import run_script

MESH = {"data": 2, "model": 4}
B, S = 4, 32
MOE_DECODE_B = 128        # whole MoE groups of 64 tokens on each data rank
FAMILIES = ("qwen2-0.5b", "llama4-scout-17b-a16e", "mamba2-2.7b",
            "zamba2-2.7b", "llama-3.2-vision-11b", "whisper-base")
MODULES = (ref_lm, ref_attention, ref_moe, ref_common)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _decode_batch(cfg):
    return MOE_DECODE_B if cfg.family == "moe" else B


def _ref_batch(cfg, rows, seq):
    b = {"tokens": jax.ShapeDtypeStruct((rows, seq), jnp.int32),
         "positions": jax.ShapeDtypeStruct((rows, seq), jnp.int32)}
    if cfg.family == "vlm":
        b["image_embeds"] = jax.ShapeDtypeStruct(
            (rows, cfg.num_image_tokens, cfg.d_model), jnp.bfloat16)
    if cfg.family == "encdec":
        b["frames"] = jax.ShapeDtypeStruct(
            (rows, cfg.num_frames, cfg.d_model), jnp.bfloat16)
    return b


def reference_sites(cfg, monkeypatch):
    """``{(names, shape)}`` of every ``constrain`` call the reference's
    ``loss``, ``prefill`` and ``decode_step`` make."""
    seen = set()

    def record(x, *names):
        seen.add((tuple(names), tuple(int(n) for n in x.shape)))
        return x

    for mod in MODULES:
        monkeypatch.setattr(mod, "constrain", record)
    model = RefLM(cfg)
    params = model.abstract_params()
    train = {**_ref_batch(cfg, B, S),
             "targets": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "loss_mask": jax.ShapeDtypeStruct((B, S), jnp.bool_)}
    jax.eval_shape(model.loss, params, train)
    jax.eval_shape(model.prefill, params, _ref_batch(cfg, B, S))
    rows = _decode_batch(cfg)
    if rows != B:               # the port's decode starts from its prefill
        jax.eval_shape(model.prefill, params, _ref_batch(cfg, rows, S))
    cache = jax.tree.map(
        lambda d: jax.ShapeDtypeStruct(d.shape, jnp.dtype(d.dtype)
                                       if d.dtype != "bfloat16"
                                       else jnp.bfloat16),
        model.cache_defs(rows, S), is_leaf=lambda d: hasattr(d, "axes"))
    jax.eval_shape(model.decode_step, params, cache,
                   jax.ShapeDtypeStruct((rows, 1), jnp.int32),
                   jax.ShapeDtypeStruct((), jnp.int32))
    return seen


_PORT = """
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import DTensor, Shard
import repro_torch.kernels.ops as kops
import repro_torch.models.attention as attention
import repro_torch.models.common as common
import repro_torch.models.lm as lm
import repro_torch.models.moe as moe
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import jitted_cell
from repro_torch.models import LM
from repro_torch.trees import tree_map
from repro_torch.optim import adamw_init
from repro_torch.parallel import axes
from repro_torch.parallel.axes import sharding_context

ARCHS, B, S, MOE_B, HEAD_DIM, HEADS = json.loads(sys.argv[1])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh({"data": 2, "model": 4})
real = axes.constrain
out = {}


def placement(y):
    if not isinstance(y, DTensor):
        return "plain"
    (p,) = y.placements
    return p.dim if isinstance(p, Shard) else None


def record(x, *names):
    y = real(x, *names)
    sites.append([list(names), list(x.shape), placement(y)])
    return y


for mod in (lm, attention, moe, common):
    mod.constrain = record
flash = []
_flash = kops.flash_attention


def counting(q, k, v, causal=True):
    assert not any(isinstance(t, DTensor) for t in (q, k, v))
    flash.append([q.shape[1], k.shape[1]])
    return _flash(q, k, v, causal=causal)


kops.flash_attention = counting
for arch in ARCHS:
    sites = []
    cfg = get_config(arch, reduced=True)
    if HEAD_DIM:
        cfg = dataclasses.replace(cfg, head_dim=HEAD_DIM, num_heads=HEADS[0],
                                  num_kv_heads=HEADS[1])
    model = LM(cfg)
    params = tree_map(lambda p: p.float(), model.init_params(
        torch.Generator().manual_seed(0), device="cpu"))
    gen = torch.Generator().manual_seed(1)

    def batch(rows):
        b = {"tokens": torch.randint(0, cfg.vocab_size, (rows, S),
                                     generator=gen),
             "positions": torch.arange(S).repeat(rows, 1)}
        if cfg.family == "vlm":
            b["image_embeds"] = torch.randn(rows, cfg.num_image_tokens,
                                            cfg.d_model)
        if cfg.family == "encdec":
            b["frames"] = torch.randn(rows, cfg.num_frames, cfg.d_model)
        return b

    with sharding_context(mesh) as ctx:
        train, _ = jitted_cell(cfg, ShapeCell("t", S, B, "train"), ctx)
        rows = MOE_B if cfg.family == "moe" else B
        prefill, _ = jitted_cell(cfg, ShapeCell("p", S, B, "prefill"), ctx)
        pre_rows, _ = jitted_cell(cfg, ShapeCell("p", S, rows, "prefill"),
                                  ctx)
        decode, _ = jitted_cell(cfg, ShapeCell("d", S, rows, "decode"), ctx)
    tb = batch(B)
    tb.update(targets=tb["tokens"], loss_mask=torch.ones(B, S, dtype=bool))
    train(params, adamw_init(params), tb)
    prefill(params, batch(B))
    _, cache = pre_rows(params, batch(rows))
    decode(params, cache, torch.zeros(rows, 1, dtype=torch.int32),
           torch.tensor(S - 1))
    out[arch] = sites
out["flash"] = flash
print(json.dumps(out))
dist.destroy_process_group()
"""


def port_sites(archs, head_dim=0, heads=(0, 0)):
    got = run_script("import dataclasses\n" + _PORT, [json.dumps(
        [list(archs), B, S, MOE_DECODE_B, head_dim, list(heads)])],
        timeout=240)
    return json.loads(got.strip().splitlines()[-1])


def _global(names, shape):
    """A rank's shape at a site as the whole batch's."""
    shape = list(shape)
    for d, n in enumerate(names):
        if n == "batch":
            shape[d] *= MESH["data"]
    if tuple(names) == (None, "act_expert", None, None):
        shape[0] *= MESH["data"]          # the MoE groups of the rows
    return tuple(shape)


def _model_dim(spec):
    for d, part in enumerate(spec):
        if part == "model" or (isinstance(part, tuple) and "model" in part):
            return d
    return None


@pytest.fixture(scope="module")
def port():
    return port_sites(FAMILIES)


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_site_carries_the_reference_placement(port, arch,
                                                    monkeypatch):
    cfg = ref_get_config(arch, reduced=True)
    want = reference_sites(cfg, monkeypatch)
    got = {}
    for names, shape, placed in port[arch]:
        key = (tuple(names), _global(names, shape))
        got.setdefault(key, set()).add(placed)
    assert set(got) == want, (sorted(set(got) - want, key=str),
                              sorted(want - set(got), key=str))
    mesh = FakeMesh(MESH)
    for (names, shape), placed in got.items():
        spec = spec_for(names, shape, mesh, DEFAULT_RULES)
        assert placed == {_model_dim(spec)}, (names, shape, spec, placed)
        if "batch" in names:            # the rows split over data
            assert spec[names.index("batch")] == "data", (names, spec)


def test_heads_that_do_not_split_fall_back_to_the_sequence(port):
    """qwen2's reduced 7 heads on 4 ranks: q stays whole on the model axis,
    the chunk's logits are split along their query rows (``seq``)."""
    placed = {(tuple(n), tuple(s)): p for n, s, p in port["qwen2-0.5b"]}
    q = [p for (n, s), p in placed.items()
         if n == ("batch", None, "act_heads", None) and s[2] == 7]
    logits = [p for (n, s), p in placed.items()
              if n == ("batch", "act_heads", "seq", None)]
    assert q and set(q) == {None}
    assert logits and set(logits) == {2}


def test_flash_route_takes_each_rank_heads_and_their_kv_head():
    """8 q heads over 2 kv heads at head dim 64, 4 ranks: no constrain
    site inside the flash route (as the reference's ``use_pallas``
    route), and every kernel call gets plain tensors: 2 local q heads with
    the one kv head they use (the kernel's GQA then serves both from
    it)."""
    got = port_sites(["qwen2-72b"], head_dim=64, heads=(8, 2))
    assert got["flash"] and {tuple(c) for c in got["flash"]} == {(2, 1)}
    names = {tuple(n) for n, _, _ in got["qwen2-72b"]}
    assert ("batch", "act_heads", "seq", None) not in names
    assert ("batch", None, "act_heads", None) in names
    ref = dataclasses.replace(ref_get_config("qwen2-72b", reduced=True),
                              head_dim=64, num_heads=8, num_kv_heads=2,
                              use_pallas=True)
    with pytest.MonkeyPatch.context() as mp:
        assert not any(n == ("batch", "act_heads", "seq", None)
                       for n, _ in reference_sites(ref, mp))
