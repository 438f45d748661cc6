"""``repro_torch.parallel.pipeline`` vs ``repro.parallel.pipeline``: the
reference test's GPipe run (S = 4 stages, M = 8 microbatches of MB = 2
rows, D = 16, stage ``tanh(h @ w)``) on 4 gloo ranks, each holding its own
stage's weight: the output and every stage's weight gradient against the
sequential composition at the reference test's tolerances (forward
``rtol = atol = 1e-5``; gradient ``rtol 1e-4``, ``atol 1e-5``), and against
the reference's own pipeline on 4 XLA host devices; ``bubble_fraction``."""
import numpy as np
import pytest
import torch

from repro.parallel.pipeline import bubble_fraction as ref_bubble

from repro_torch.parallel.pipeline import bubble_fraction
from _torch_dist import run_ranks, run_reference

S, M, MB, D = 4, 8, 2, 16

_REF_SIDE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.parallel.pipeline import pipeline_apply
data = dict(np.load(sys.argv[1]))
mesh = make_mesh({"stage": S})
apply = pipeline_apply(lambda ws, h: jnp.tanh(h @ ws["w"]), mesh, S)

def pp_loss(params, xs):
    y = apply(params, xs)
    return jnp.mean(y ** 2), y

(loss, y), g = jax.value_and_grad(pp_loss, has_aux=True)(
    {"w": jnp.asarray(data["w"])}, jnp.asarray(data["x"]))
np.savez(sys.argv[2], loss=np.asarray(loss), y=np.asarray(y),
         g=np.asarray(g["w"]))
"""

_PORT_SIDE = """
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.pipeline import pipeline_apply
data = np.load(DATA)
mesh = make_mesh({"stage": S})
apply = pipeline_apply(lambda ws, h: torch.tanh(h @ ws["w"]), mesh, S)
w = torch.from_numpy(data["w"][RANK]).requires_grad_(True)
y = apply({"w": w}, torch.from_numpy(data["x"]))
loss = torch.mean(y ** 2)
loss.backward()
np.savez(f"{OUT}{RANK}.npz", loss=loss.detach().numpy(),
         y=y.detach().numpy(), g=w.grad.numpy())
"""


def _sequential(w, x):
    """The reference test's ``seq_loss`` in torch: loss, output, grads."""
    w = torch.from_numpy(w).requires_grad_(True)
    h = torch.from_numpy(x).reshape(M * MB, D)
    for s in range(S):
        h = torch.tanh(h @ w[s])
    loss = torch.mean(h ** 2)
    loss.backward()
    return (float(loss.detach()), h.detach().reshape(M, MB, D).numpy(),
            w.grad.numpy())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    data = {"w": (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32),
            "x": rng.standard_normal((M, MB, D)).astype(np.float32)}
    np.savez(tmp / "data.npz", **data)
    consts = f"S = {S}\n"
    run_reference(consts + _REF_SIDE, S, (tmp / "data.npz", tmp / "ref.npz"),
                  timeout=120)
    run_ranks(consts + f"DATA, OUT = {str(tmp / 'data.npz')!r}, "
              f"{str(tmp / 'port')!r}\n" + _PORT_SIDE, S, timeout=120)
    port = [dict(np.load(tmp / f"port{r}.npz")) for r in range(S)]
    return data, dict(np.load(tmp / "ref.npz")), port


def test_pipeline_matches_the_sequential_composition(runs):
    data, _, port = runs
    want_loss, want_y, want_g = _sequential(data["w"], data["x"])
    for stage, got in enumerate(port):        # every rank holds the output
        np.testing.assert_allclose(got["y"], want_y, rtol=1e-5, atol=1e-5)
        assert abs(float(got["loss"]) - want_loss) < 1e-6
        # the stage's own weight gradient, counted once (not S times)
        np.testing.assert_allclose(got["g"], want_g[stage], rtol=1e-4,
                                   atol=1e-5)


def test_pipeline_matches_the_reference_pipeline(runs):
    _, want, port = runs
    for stage, got in enumerate(port):
        np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["g"], want["g"][stage], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("stages, micro", [(4, 8), (1, 1), (2, 16), (8, 3)])
def test_bubble_fraction(stages, micro):
    assert bubble_fraction(stages, micro) == ref_bubble(stages, micro)
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9
