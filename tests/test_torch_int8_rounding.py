"""The port's int8 scales against the reference's *compiled* steps, bit for
bit.  The reference trains under ``jax.jit`` (``jitted_cell`` ->
``make_train_step``, and ``make_dp_train_step``'s ``jax.jit(step)``), and
XLA divides by a constant as a product with the constant's reciprocal
rounded to float32: ``amax / 127.0`` is ``amax * float32(1/127)`` there,
which a division rounded once misses in about one scale in 25, and
``psum(1) / n`` folds ``n`` to a constant.  The port multiplies by the
reciprocal too.

XLA's CPU code generator also contracts an add of a product into one
fused multiply-add where the host has FMA, in vectorised loop bodies but
not in their scalar remainders, so which entries of a moment or a
residual it rounds once depends on the shape and the host's vector width.
The port rounds each operation as the compiled program states it, so the
checks of the moments and residuals run the reference in a subprocess
with ``--xla_cpu_max_isa=AVX`` (no FMA instructions: one rounding per
operation, the division rule kept); the in-process checks, under the
default flags, hold what contraction cannot reach.

* ``_quantize_moment`` on 4096 x 256 rows, in process: ``s`` and ``q``;
* ``compress_with_feedback`` over 96 leaves: the float32 dequantized
  payloads in process, payloads and residuals (float32 and bfloat16) in
  the subprocess;
* one ``adamw_update`` in ``int8`` format from moments of two jitted
  reference steps and the reference's own gradient norm: the new moments'
  ``q`` and ``s`` (the parameters within ``test_torch_train_optim.py``'s
  fp32 tolerance), and the clip's scale over 64 gradient norms;
* ``compressed_allreduce_mean`` and ``make_dp_train_step`` on 3 gloo ranks
  against the jitted ``shard_map`` on 3 XLA host devices (1/3, unlike
  1/4, is not exact).  The trainer's model is linear in its parameters
  with small-integer data, so every gradient is an exact sum in any order
  and what is held is how each package rounds ``/ n``, the scale and the
  residual.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.parallel import compression as ref_compression

from repro_torch import convert
from repro_torch.trees import tree_leaves
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.parallel import compression
from _torch_dist import run_ranks, run_script

RANKS, D, K, ROWS, STEPS = 3, 16, 4, 6, 3
CLIP_NORMS = (1.0, 0.3)
DTYPES = ("float32", "bfloat16")


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _rows(rng, shape):
    """Normal values with a row scale spread over four decades, so the
    scales land on many float32 binades."""
    scale = 10.0 ** rng.uniform(-3, 1, shape[:-1] + (1,))
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _feedback_inputs():
    """96 leaves of 1-8 rows of 1-64 values, and their residuals."""
    rng = np.random.default_rng(1)
    shapes = [(int(rng.integers(1, 9)), int(rng.integers(1, 65)))
              for _ in range(96)]
    g = {f"g{i}": _rows(rng, s) for i, s in enumerate(shapes)}
    r = {f"g{i}": (_rows(rng, s) * 1e-2).astype(np.float32)
         for i, s in enumerate(shapes)}
    return g, r


def _adamw_trees():
    """Parameters, two steps' gradients and the step's gradients: a
    matrix, a stacked 3-D leaf, a vector and a scalar."""
    rng = np.random.default_rng(2)

    def tree():
        return {"w": _rows(rng, (512, 256)),
                "blocks": {"k": _rows(rng, (2, 64, 128)),
                           "b": _rows(rng, (256,))},
                "gate": np.asarray(rng.standard_normal(), np.float32)}
    return [tree() for _ in range(4)]


def _port_feedback(g, r, dtype):
    tdt = getattr(torch, dtype)
    return compression.compress_with_feedback(
        {k: torch.from_numpy(v).to(tdt) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in r.items()})


@pytest.mark.parametrize("signed", [True, False])
def test_quantize_moment_matches_the_jitted_reference(signed):
    rng = np.random.default_rng(0)
    x = _rows(rng, (4096, 256))
    if not signed:
        x = np.abs(x)
    want = jax.jit(lambda a: ref_adamw._quantize_moment(a, signed))(
        jnp.asarray(x))
    got = adamw._quantize_moment(torch.from_numpy(x), signed)
    assert np.array_equal(_bits(got["s"].numpy()), _bits(want["s"]))
    assert np.array_equal(got["q"].numpy(), np.asarray(want["q"]))


def test_compressed_payload_matches_the_jitted_reference():
    """Under the default flags: each leaf's dequantized payload (its int8
    image times its scale) bit for bit.  (In bfloat16 the payload's
    rounding hides a scale one step off.)"""
    g, r = _feedback_inputs()
    want, _ = jax.jit(ref_compression.compress_with_feedback)(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in r.items()})
    got, _ = _port_feedback(g, r, "float32")
    for k in g:
        assert np.array_equal(_bits(got[k].numpy()), _bits(want[k])), k


_REF_SIDE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.optim import AdamWConfig
from repro.optim.adamw import adamw_init, adamw_update
from repro.parallel.compression import (compress_with_feedback,
                                        compressed_allreduce_mean,
                                        make_dp_train_step,
                                        zeros_like_residual)
from test_torch_int8_rounding import (CLIP_NORMS, DTYPES, RANKS, STEPS,
                                      _adamw_trees, _feedback_inputs)
import inspect
try:
    shard_map = jax.shard_map
except AttributeError:
    from jax.experimental.shard_map import shard_map
sig = inspect.signature(shard_map).parameters
kw = {k: False for k in ("check_vma", "check_rep") if k in sig}
out = {}


def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(p.key) for p in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)


g, r = _feedback_inputs()
for dtype in DTYPES:
    new_g, new_r = jax.jit(compress_with_feedback)(
        {k: jnp.asarray(v, dtype) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in r.items()})
    save(f"cwf_{dtype}_g", jax.tree.map(lambda x: x.astype(jnp.float32),
                                        new_g))
    save(f"cwf_{dtype}_r", new_r)

for clip in CLIP_NORMS:
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                      state_format="int8", clip_norm=clip)
    step = jax.jit(lambda p, g, s: adamw_update(cfg, p, g, s))
    trees = [jax.tree.map(jnp.asarray, t) for t in _adamw_trees()]
    p, s = trees[0], adamw_init(trees[0], "int8")
    for t in range(3):      # two steps to moments that are not zero
        if t == 2:
            save(f"adamw_{clip}_in", {"p": p, "m": s["m"], "v": s["v"]})
            out[f"adamw_{clip}_step"] = np.asarray(s["step"])
        p, s, metrics = step(p, trees[t + 1], s)
    out[f"adamw_{clip}_norm"] = np.asarray(metrics["grad_norm"])
    save(f"adamw_{clip}_out", {"p": p, "m": s["m"], "v": s["v"]})

data = dict(np.load(sys.argv[1]))
mesh = make_mesh({"data": RANKS})
f = jax.jit(shard_map(lambda v: compressed_allreduce_mean(v[0], "data"),
                      mesh=mesh, in_specs=P("data"), out_specs=P(), **kw))
out["mean"] = np.asarray(f(jnp.asarray(data["x"])))

def loss_fn(p, b):
    return jnp.sum(b["x"] @ p["w"]) + jnp.sum(b["y"] * p["b"])

def update(p, g, s):
    return jax.tree.map(lambda a, b: a - b, p, g), s

for compress in (False, True):
    step = make_dp_train_step(loss_fn, update, mesh, compress=compress)
    p = {"w": jnp.asarray(data["w"]), "b": jnp.asarray(data["b"])}
    s, r = {}, zeros_like_residual(p)
    for t in range(STEPS):
        batch = {"x": jnp.asarray(data[f"x{t}"]),
                 "y": jnp.asarray(data[f"y{t}"])}
        p, s, r, loss = step(p, s, r, batch)
        out[f"{compress}_loss{t}"] = np.asarray(loss)
        for k in p:
            out[f"{compress}_{k}{t}"] = np.asarray(p[k])
            out[f"{compress}_r_{k}{t}"] = np.asarray(r[k])
np.savez(sys.argv[2], **out)
"""

_PORT_SIDE = """
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.compression import (compressed_allreduce_mean,
                                              make_dp_train_step,
                                              zeros_like_residual)
from repro_torch.trees import tree_map
data = {k: torch.from_numpy(v) for k, v in np.load(DATA).items()}
mesh = make_mesh({"data": RANKS})
out = {"mean": compressed_allreduce_mean(data["x"][RANK],
                                         mesh.get_group("data")).numpy()}

def loss_fn(p, b):
    return torch.sum(b["x"] @ p["w"]) + torch.sum(b["y"] * p["b"])

def update(p, g, s):
    return tree_map(lambda a, b: a - b, p, g), s

for compress in (False, True):
    step = make_dp_train_step(loss_fn, update, mesh, compress=compress)
    p = {"w": data["w"], "b": data["b"]}
    s, r = {}, zeros_like_residual(p)
    for t in range(STEPS):
        batch = {"x": data[f"x{t}"], "y": data[f"y{t}"]}
        p, s, r, loss = step(p, s, r, batch)
        out[f"{compress}_loss{t}"] = loss.numpy()
        for k in p:
            out[f"{compress}_{k}{t}"] = p[k].numpy()
            out[f"{compress}_r_{k}{t}"] = r[k].numpy()
np.savez(f"{OUT}{RANK}.npz", **out)
"""


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """The reference's jitted functions in one subprocess on 3 XLA host
    devices without FMA instructions, and the port's collective side on 3
    gloo ranks."""
    tmp = tmp_path_factory.mktemp("int8_rounding")
    rng = np.random.default_rng(3)

    def ints(shape):
        return rng.integers(-8, 9, shape).astype(np.float32)

    data = {"x": _rows(rng, (RANKS, 256)), "w": ints((D, K)),
            "b": ints((K,))}
    for t in range(STEPS):
        data[f"x{t}"], data[f"y{t}"] = ints((ROWS, D)), ints((ROWS, K))
    np.savez(tmp / "data.npz", **data)
    run_script(_REF_SIDE, (tmp / "data.npz", tmp / "ref.npz"), timeout=240,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={RANKS}"
               " --xla_cpu_max_isa=AVX")
    run_ranks(f"RANKS, STEPS = {RANKS}, {STEPS}\n"
              f"DATA, OUT = {str(tmp / 'data.npz')!r}, "
              f"{str(tmp / 'port')!r}\n" + _PORT_SIDE, RANKS, timeout=120)
    port = [dict(np.load(tmp / f"port{r}.npz")) for r in range(RANKS)]
    return dict(np.load(tmp / "ref.npz")), port


def _subtree(flat, prefix):
    """The nested dict of tensors saved under ``prefix/``."""
    out = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(value)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_compress_with_feedback_matches_the_jitted_reference(compiled,
                                                             dtype):
    want, _ = compiled
    g, r = _feedback_inputs()
    got_g, got_r = _port_feedback(g, r, dtype)
    want_g = _subtree(want, f"cwf_{dtype}_g")
    want_r = _subtree(want, f"cwf_{dtype}_r")
    for k in g:
        assert np.array_equal(_bits(got_g[k].float().numpy()),
                              _bits(want_g[k].numpy())), k
        assert np.array_equal(_bits(got_r[k].numpy()),
                              _bits(want_r[k].numpy())), k


@pytest.mark.parametrize("clip_norm", CLIP_NORMS)
def test_int8_adamw_moments_match_the_jitted_reference(compiled, clip_norm):
    """From the reference's state after two steps and its own gradient
    norm (the two frameworks sum the squares in other orders); the clip
    acts (the norm is above ``clip_norm``)."""
    want, _ = compiled
    pre = f"adamw_{clip_norm}"
    before = _subtree(want, f"{pre}_in")
    after = _subtree(want, f"{pre}_out")
    norm = want[f"{pre}_norm"]
    assert float(norm) > clip_norm
    state = {"m": before["m"], "v": before["v"],
             "step": torch.from_numpy(want[f"{pre}_step"])}
    got_p, got_s, _ = adamw.adamw_update(
        AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                    state_format="int8", clip_norm=clip_norm),
        before["p"], convert.params_from_reference(_adamw_trees()[3], "cpu"),
        state, grad_norm=torch.from_numpy(norm))
    for name in ("m", "v"):
        w = dict(tree_leaves(after[name]))
        for path, x in tree_leaves(got_s[name]):
            assert x.dtype == w[path].dtype, path
            assert torch.equal(x, w[path]) and np.array_equal(
                x.numpy().view(np.uint8), w[path].numpy().view(np.uint8)), \
                path
    w = dict(tree_leaves(after["p"]))
    for path, x in tree_leaves(got_p):
        ref = w[path].double().numpy()
        np.testing.assert_allclose(x.double().numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=path)


def test_compressed_allreduce_mean_on_3_ranks_matches_the_jitted_reference(
        compiled):
    want, port = compiled
    for got in port:
        assert np.array_equal(_bits(got["mean"]), _bits(want["mean"]))


@pytest.mark.parametrize("compress", [False, True])
def test_dp_train_step_on_3_ranks_matches_the_jitted_reference(
        compiled, compress):
    """``pmean`` of the gradients (``psum / n``, ``n`` folded), or their
    compressed mean and error feedback: the parameters and residuals after
    each step bit for bit, and the first step's mean loss (an exact sum of
    integers; later losses sum non-integers in each framework's order)."""
    want, port = compiled
    keys = [f"{compress}_loss0"] + [
        f"{compress}_{k}{t}" for t in range(STEPS)
        for k in ("w", "b", "r_w", "r_b")]
    for got in port:
        for key in keys:
            assert np.array_equal(_bits(got[key]), _bits(want[key])), key


def test_clip_scale_matches_the_jitted_reference():
    """``min(1, clip_norm / norm)`` is one division in the reference; the
    port's ``number / tensor`` would be the tensor's reciprocal times the
    number, one step off for about a quarter of the norms.  A one-value
    gradient is its own norm; the first moment of the first step is
    ``(1 - b1) * g * scale``, bit for bit, over 64 gradients."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=0.3)
    step = jax.jit(lambda p, g, s: ref_adamw.adamw_update(
        ref_adamw.AdamWConfig(**kw), p, g, s))
    cfg = AdamWConfig(**kw)
    grads = np.random.default_rng(5).uniform(1, 1000, 64).astype(np.float32)
    for g in grads:
        p = {"w": np.float32(0.5)}
        _, want, _ = step(jax.tree.map(jnp.asarray, p),
                          {"w": jnp.asarray(g)},
                          ref_adamw.adamw_init(p, "fp32"))
        t = {"w": torch.tensor(0.5)}
        _, got, _ = adamw.adamw_update(cfg, t, {"w": torch.tensor(g)},
                                       adamw.adamw_init(t, "fp32"))
        assert _bits(got["m"]["w"].numpy()) == _bits(want["m"]["w"]), g
