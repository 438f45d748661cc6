"""``repro_torch.parallel.compression`` vs ``repro.parallel.compression``:
``quantize_int8`` and ``compress_with_feedback`` bit for bit in process;
``compressed_allreduce_mean`` on 4 gloo ranks over the reference test's
4 x 64 input (the reference's error bound, and bit-equal to the
reference's ``shard_map`` over 4 XLA host devices); ``make_dp_train_step``
on a linear model, 4 ranks, 3 steps, against the reference's trainer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as ref

from repro_torch.parallel import compression
from _torch_dist import run_ranks, run_reference

# the linear model of the data-parallel check
D, K, ROWS, STEPS, LR = 16, 4, 8, 3, 0.1
DP_TOL = 1e-6


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("seed", range(3))
def test_quantize_int8_is_bit_equal(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * 50).astype(np.float32)
    # exact halves round to even in both packages; +-200 clips to +-127
    x[:8] = [0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 200.0, -200.0]
    for scale in (np.float32(1.0), np.float32(np.abs(x).max() / 127)):
        want = ref.quantize_int8(jnp.asarray(x), jnp.asarray(scale))
        got = compression.quantize_int8(torch.from_numpy(x),
                                        torch.tensor(scale))
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_with_feedback_is_bit_equal(dtype):
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((8, 16)).astype(np.float32),
         "b": {"c": (rng.standard_normal(5) * 1e-3).astype(np.float32)}}
    r = {"a": (rng.standard_normal((8, 16)) * 1e-2).astype(np.float32),
         "b": {"c": np.zeros(5, np.float32)}}
    jg = {"a": jnp.asarray(g["a"], dtype), "b": {"c": jnp.asarray(
        g["b"]["c"], dtype)}}
    want_g, want_r = ref.compress_with_feedback(
        jg, {"a": jnp.asarray(r["a"]), "b": {"c": jnp.asarray(r["b"]["c"])}})
    tdt = getattr(torch, dtype)
    got_g, got_r = compression.compress_with_feedback(
        {"a": torch.from_numpy(g["a"]).to(tdt),
         "b": {"c": torch.from_numpy(g["b"]["c"]).to(tdt)}},
        {"a": torch.from_numpy(r["a"]), "b": {"c": torch.from_numpy(
            r["b"]["c"])}})
    for got, want in ((got_g["a"], want_g["a"]),
                      (got_g["b"]["c"], want_g["b"]["c"]),
                      (got_r["a"], want_r["a"]),
                      (got_r["b"]["c"], want_r["b"]["c"])):
        assert str(got.dtype).endswith(str(want.dtype))
        assert np.array_equal(_bits(got.float().numpy()),
                              _bits(np.asarray(want, np.float32)))
    zeros = compression.zeros_like_residual(got_g)
    assert zeros["a"].dtype == torch.float32 and not zeros["a"].any()


_REF_SIDE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.parallel.compression import (compressed_allreduce_mean,
                                        make_dp_train_step,
                                        zeros_like_residual)
import inspect
try:
    shard_map = jax.shard_map
except AttributeError:
    from jax.experimental.shard_map import shard_map
sig = inspect.signature(shard_map).parameters
kw = {k: False for k in ("check_vma", "check_rep") if k in sig}
data = dict(np.load(sys.argv[1]))
mesh = make_mesh({"data": 4})
f = shard_map(lambda v: compressed_allreduce_mean(v[0], "data"),
              mesh=mesh, in_specs=P("data"), out_specs=P(), **kw)
out = {"mean": np.asarray(f(jnp.asarray(data["x"])))}

def loss_fn(p, b):
    return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

def update(p, g, s):
    return (jax.tree.map(lambda a, b: a - LR * b, p, g),
            {"n": s["n"] + 1})

for compress in (False, True):
    step = make_dp_train_step(loss_fn, update, mesh, compress=compress)
    p = {"w": jnp.asarray(data["w"]), "b": jnp.asarray(data["b"])}
    s, r = {"n": jnp.zeros((), jnp.int32)}, zeros_like_residual(p)
    for t in range(STEPS):
        batch = {"x": jnp.asarray(data[f"x{t}"]),
                 "y": jnp.asarray(data[f"y{t}"])}
        p, s, r, loss = step(p, s, r, batch)
        out[f"{compress}_loss{t}"] = np.asarray(loss)
    for k in p:
        out[f"{compress}_{k}"] = np.asarray(p[k])
        out[f"{compress}_r_{k}"] = np.asarray(r[k])
    out[f"{compress}_n"] = np.asarray(s["n"])
np.savez(sys.argv[2], **out)
"""

_PORT_SIDE = """
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.compression import (compressed_allreduce_mean,
                                              make_dp_train_step,
                                              zeros_like_residual)
from repro_torch.trees import tree_map
data = {k: torch.from_numpy(v) for k, v in np.load(DATA).items()}
mesh = make_mesh({"data": 4})
out = {"mean": compressed_allreduce_mean(data["x"][RANK],
                                         mesh.get_group("data")).numpy()}

def loss_fn(p, b):
    return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

def update(p, g, s):
    return tree_map(lambda a, b: a - LR * b, p, g), {"n": s["n"] + 1}

for compress in (False, True):
    step = make_dp_train_step(loss_fn, update, mesh, compress=compress)
    p = {"w": data["w"], "b": data["b"]}
    s, r = {"n": torch.zeros((), dtype=torch.int32)}, zeros_like_residual(p)
    for t in range(STEPS):
        batch = {"x": data[f"x{t}"], "y": data[f"y{t}"]}
        p, s, r, loss = step(p, s, r, batch)
        out[f"{compress}_loss{t}"] = loss.numpy()
    for k in p:
        out[f"{compress}_{k}"] = p[k].numpy()
        out[f"{compress}_r_{k}"] = r[k].numpy()
    out[f"{compress}_n"] = s["n"].numpy()
np.savez(f"{OUT}{RANK}.npz", **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on the same inputs: the reference on 4 XLA host
    devices, the port on 4 gloo ranks (each rank's results)."""
    tmp = tmp_path_factory.mktemp("compression")
    rng = np.random.default_rng(0)
    data = {"x": rng.standard_normal((4, 64)).astype(np.float32),
            "w": (rng.standard_normal((D, K)) * 0.3).astype(np.float32),
            "b": np.zeros(K, np.float32)}
    true_w = rng.standard_normal((D, K)).astype(np.float32)
    for t in range(STEPS):
        x = rng.standard_normal((ROWS, D)).astype(np.float32)
        data[f"x{t}"], data[f"y{t}"] = x, x @ true_w
    np.savez(tmp / "data.npz", **data)
    consts = f"STEPS, LR = {STEPS}, {LR}\n"
    run_reference(consts + _REF_SIDE, 4, (tmp / "data.npz", tmp / "ref.npz"),
                  timeout=120)
    run_ranks(consts + f"DATA, OUT = {str(tmp / 'data.npz')!r}, "
              f"{str(tmp / 'port')!r}\n" + _PORT_SIDE, 4, timeout=120)
    port = [dict(np.load(tmp / f"port{r}.npz")) for r in range(4)]
    return data, dict(np.load(tmp / "ref.npz")), port


def test_compressed_allreduce_mean_on_4_ranks(runs):
    data, want, port = runs
    x = data["x"]
    bound = np.abs(x).max() / 127.0 * 2
    for got in port:                 # every rank holds the mean
        assert np.abs(got["mean"] - x.mean(axis=0)).max() <= bound + 1e-6
        assert np.array_equal(_bits(got["mean"]), _bits(want["mean"]))


@pytest.mark.parametrize("compress", [False, True])
def test_make_dp_train_step_on_4_ranks(runs, compress):
    _, want, port = runs
    for got in port:
        assert int(got[f"{compress}_n"]) == int(want[f"{compress}_n"]) == 3
        for t in range(STEPS):
            np.testing.assert_allclose(got[f"{compress}_loss{t}"],
                                       want[f"{compress}_loss{t}"],
                                       rtol=DP_TOL)
        for k in ("w", "b"):
            # without compression a float32 sum-order tolerance; with it,
            # one quantization step (the residual is at most half of one)
            # times the learning rate, per element
            tol = DP_TOL if not compress else \
                LR * np.abs(want[f"{compress}_r_{k}"]).max() * 2 + DP_TOL
            np.testing.assert_allclose(got[f"{compress}_{k}"],
                                       want[f"{compress}_{k}"], rtol=0,
                                       atol=tol, err_msg=k)
            np.testing.assert_array_equal(got[f"{compress}_{k}"],
                                          port[0][f"{compress}_{k}"])
