"""Training over a data mesh: ``repro_torch.launch.steps.jitted_cell`` on
gloo ranks against the unsharded step.

* reduced qwen2 (the reference's parameters, float32) at ``(data 4)`` and
  ``(pod 2, data 2)``, fp32 and int8 moments, one step: the loss within
  ``1e-5`` relative of the port's ``(1, 1)`` step and of the reference's
  ``jitted_cell`` on a ``(1, 1)`` mesh, every parameter within ``1e-5``,
  every moment within ``1e-5`` of its leaf's largest entry (int8: the
  per-row scales so, from the absmax of rows split over ranks, and ``q``
  within one step);
* each of the six families' reduced configs at ``(data 2)``: the loss and
  the MoE aux against ``(1, 1)``; prefill and decode through the same
  placement against the unsharded steps;
* ``python -m repro_torch.launch.train --data 2 --device cpu`` under
  ``python -m torch.distributed.run``, its checkpoint resumed on
  ``--data 1``, and a ``--data 1`` checkpoint resumed on ``--data 2``;
* ``make_production_mesh`` refusing 8 ranks.

Every process group lives in subprocesses with their own timeouts.
"""
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeCell as RefShapeCell
from repro.configs import get_config as ref_get_config
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.launch.steps import jitted_cell as ref_jitted_cell
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.parallel.axes import sharding_context as ref_sharding_context

from repro_torch.configs import get_config
from repro_torch.launch import train as train_mod
from repro_torch.models import LM
from repro_torch.trees import tree_leaves
from _torch_dist import ROOT, run_ranks, run_script
from _torch_train import reference_params

B, S = 8, 32
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-5
MOMENT_TOL = 0.03        # of a leaf's largest entry, bf16 gradients
MOMENT_ATOL = 1e-5       # of a leaf's largest entry, float32 (one step)
MOVED_TOL = 0.25         # of how far the straight run moved a bf16 leaf
FAMILIES = ("qwen2-0.5b", "llama4-scout-17b-a16e", "mamba2-2.7b",
            "zamba2-2.7b", "llama-3.2-vision-11b", "whisper-base")


def _batch(vocab, rows=B, seed=0):
    """A packed batch of the reference's pipeline, as NumPy."""
    from repro.data import DataConfig, make_train_batches
    batch = next(make_train_batches(DataConfig(
        vocab, S, rows, seed=seed, mean_doc_len=12, min_doc_len=4)))
    batch.pop("next_doc")
    return batch


_QWEN2_RANKS = """
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import jitted_cell, make_train_step
from repro_torch.models import LM
from repro_torch.trees import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.axes import gather, sharding_context

cfg = get_config("qwen2-0.5b", reduced=True)
model = LM(cfg)
data = np.load(DATA)
params = tree_unflatten(model.abstract_params(), {
    k[2:]: torch.from_numpy(v) for k, v in data.items() if k[:2] == "p/"})
batch = {k[2:]: torch.from_numpy(v) for k, v in data.items()
         if k[:2] == "b/"}
cell = ShapeCell("t", S, B, "train")
out = {}
for fmt in ("fp32", "int8"):
    opt = AdamWConfig(state_format=fmt)

    def record(name, p, o, m):
        out[f"{fmt}/{name}/loss"] = m["loss"].numpy()
        for part, tree in (("p", p), ("m", o["m"]), ("v", o["v"])):
            out.update({f"{fmt}/{name}/{part}/{k}": v.numpy()
                        for k, v in tree_leaves(tree)})

    if RANK == 0:
        record("1x1", *make_train_step(model, opt)(
            params, adamw_init(params, fmt), batch))
    for name, shape in (("data4", {"data": 4}),
                        ("pod2data2", {"pod": 2, "data": 2})):
        with sharding_context(make_mesh(shape)) as ctx:
            step, _ = jitted_cell(cfg, cell, ctx, opt)
        p, o, m = step(params, adamw_init(params, fmt), batch)
        p, o = tree_map(gather, p), tree_map(gather, o)
        if RANK == 0:
            record(name, p, o, m)
if RANK == 0:
    np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def qwen2(tmp_path_factory):
    """The port at (1,1), (data 4) and (pod 2, data 2) on 4 gloo ranks, and
    the reference's (1,1) loss, from the reference's float32 parameters."""
    tmp = tmp_path_factory.mktemp("mesh_qwen2")
    cfg = ref_get_config("qwen2-0.5b", reduced=True)
    params = reference_params(cfg)
    batch = _batch(cfg.vocab_size)
    data = {f"p/{k}": np.asarray(v) for k, v in tree_leaves(params)}
    data.update({f"b/{k}": v for k, v in batch.items()})
    np.savez(tmp / "data.npz", **data)
    run_ranks(f"S, B = {S}, {B}\nDATA, OUT = {str(tmp / 'data.npz')!r}, "
              f"{str(tmp / 'out.npz')!r}\n" + _QWEN2_RANKS, 4, timeout=180)
    ref_losses = {}
    for fmt in ("fp32", "int8"):
        with ref_sharding_context(ref_make_mesh({"data": 1, "model": 1})) \
                as ctx:
            step, _ = ref_jitted_cell(cfg, RefShapeCell("t", S, B, "train"),
                                      ctx, RefAdamWConfig(state_format=fmt))
            _, _, m = step(jax.tree.map(jnp.copy, params),
                           ref_adamw_init(params, fmt),
                           {k: jnp.asarray(v) for k, v in batch.items()})
        ref_losses[fmt] = float(m["loss"])
    return dict(np.load(tmp / "out.npz")), ref_losses


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
@pytest.mark.parametrize("mesh", ["data4", "pod2data2"])
def test_qwen2_step_on_a_data_mesh_matches_one_device(qwen2, mesh, fmt):
    got, ref_losses = qwen2
    loss = float(got[f"{fmt}/{mesh}/loss"])
    np.testing.assert_allclose(loss, float(got[f"{fmt}/1x1/loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, ref_losses[fmt], rtol=LOSS_RTOL)
    prefix = f"{fmt}/{mesh}/"
    keys = [k for k in got if k.startswith(prefix) and "/loss" not in k]
    assert len(keys) == len([k for k in got if k.startswith(f"{fmt}/1x1/")
                             and "/loss" not in k])
    for k in keys:
        want = got[f"{fmt}/1x1/" + k[len(prefix):]]
        if k.startswith(prefix + "p/"):
            np.testing.assert_allclose(got[k], want, rtol=0, atol=PARAM_TOL,
                                       err_msg=k)
        elif k.endswith("/q"):          # int8 moments: one quantization step
            assert np.abs(got[k].astype(int) - want).max() <= 1, k
        else:   # fp32 moments and int8 scales, whole-row absmax on a mesh
            np.testing.assert_allclose(got[k], want, rtol=0, atol=MOMENT_ATOL
                                       * np.abs(want).max(), err_msg=k)


_FAMILY_RANKS = """
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

mesh = make_mesh({"data": 2})
out = {}
for arch in FAMILIES:
    cfg = get_config(arch, reduced=True)
    model = LM(cfg)
    params = tree_map(lambda p: p.float(), model.init_params(
        torch.Generator().manual_seed(0), device="cpu"))
    batch = next(make_train_batches(DataConfig(
        cfg.vocab_size, S, B, seed=0, mean_doc_len=12, min_doc_len=4)))
    batch.pop("next_doc")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(3)
    extra = {}
    if cfg.family == "vlm":
        extra["image_embeds"] = torch.randn(B, cfg.num_image_tokens,
                                            cfg.d_model, generator=gen)
    if cfg.family == "encdec":
        extra["frames"] = torch.randn(B, cfg.num_frames, cfg.d_model,
                                      generator=gen)
    opt = AdamWConfig()
    _, _, want = make_train_step(model, opt)(params, adamw_init(params),
                                             {**batch, **extra})
    with sharding_context(mesh) as ctx:
        step, _ = jitted_cell(cfg, ShapeCell("t", S, B, "train"), ctx, opt)
        _, _, got = step(params, adamw_init(params), {**batch, **extra})
        for k in ("loss", "ce", "aux", "tokens", "grad_norm"):
            out[f"{arch}/{k}"] = np.array([float(got[k]), float(want[k])])
        pre = {"tokens": batch["tokens"], "positions": batch["positions"],
               **extra}
        logits, cache = make_prefill_step(model)(params, pre)
        prefill, _ = jitted_cell(cfg, ShapeCell("p", S, B, "prefill"), ctx)
        d_logits, d_cache = prefill(params, pre)
        out[f"{arch}/prefill"] = np.array(float(
            (gather(d_logits) - logits).abs().max()))
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        want_l, _ = make_decode_step(model)(
            params, tree_map(torch.clone, cache), tok, torch.tensor(S - 1))
        decode, _ = jitted_cell(cfg, ShapeCell("d", S, B, "decode"), ctx)
        got_l, got_cache = decode(params, d_cache, tok, torch.tensor(S - 1))
        out[f"{arch}/decode"] = np.array(float(
            (gather(got_l) - want_l).abs().max()))
if RANK == 0:
    np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_families")
    run_ranks(f"S, B = {S}, 4\nFAMILIES = {FAMILIES!r}\n"
              f"OUT = {str(tmp / 'out.npz')!r}\n" + _FAMILY_RANKS, 2,
              timeout=180)
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("arch", FAMILIES)
def test_each_family_on_data_2_matches_one_device(families, arch):
    for k in ("loss", "ce", "aux", "tokens", "grad_norm"):
        got, want = families[f"{arch}/{k}"]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    if arch.startswith("llama4"):
        assert families[f"{arch}/aux"][0] > 0
    # prefill and decode: the rows' own logits, no reduction between ranks
    # (the MoE decode's one group of 4 tokens spans both ranks: each routes
    # it whole, as one device does), so the same bits
    assert float(families[f"{arch}/prefill"]) == 0.0
    assert float(families[f"{arch}/decode"]) == 0.0


_OTHER_THREAD_RANKS = """
import threading
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import DataConfig, make_train_batches
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import jitted_cell, make_train_step
from repro_torch.models import LM
from repro_torch.trees import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.axes import gather, sharding_context

_grad = torch.autograd.grad


def grad_on_another_thread(*args, **kwargs):
    # as autograd runs a CUDA graph's backward, and so the recompute of a
    # checkpointed layer: on a thread of its own
    box = {}
    worker = threading.Thread(
        target=lambda: box.setdefault("g", _grad(*args, **kwargs)))
    worker.start()
    worker.join()
    return box["g"]


torch.autograd.grad = grad_on_another_thread
cfg = get_config("llama4-scout-17b-a16e", reduced=True)
assert cfg.remat == "full"
model = LM(cfg)
params = tree_map(lambda p: p.float(), model.init_params(
    torch.Generator().manual_seed(0), device="cpu"))
batch = next(make_train_batches(DataConfig(
    cfg.vocab_size, S, B, seed=0, mean_doc_len=12, min_doc_len=4)))
batch = {k: torch.from_numpy(v) for k, v in batch.items() if k != "next_doc"}
opt = AdamWConfig()
one = make_train_step(model, opt)(params, adamw_init(params), batch)
with sharding_context(make_mesh({"data": 2})) as ctx:
    step, _ = jitted_cell(cfg, ShapeCell("t", S, B, "train"), ctx, opt)
two = step(params, adamw_init(params), batch)
out = {}
for name, (_, o, m) in (("1x1", one), ("data2", two)):
    out[f"{name}/grad_norm"] = m["grad_norm"].numpy()
    out.update({f"{name}/m/{k}": gather(v).numpy()
                for k, v in tree_leaves(o["m"])})
if RANK == 0:
    np.savez(OUT, **out)
"""


def test_moe_backward_on_another_thread_reduces_as_its_forward(tmp_path):
    """llama4's reduced step at (data 2) with every backward pass run on a
    thread of its own, as autograd runs a CUDA graph's: the recomputed
    MoE layers (remat "full") take the router statistics over both ranks
    again, so the gradient (AdamW's first moment after one step, and its
    norm) is that of (1,1)."""
    run_ranks(f"S, B = {S}, 4\nOUT = {str(tmp_path / 'out.npz')!r}\n"
              + _OTHER_THREAD_RANKS, 2, timeout=180)
    got = dict(np.load(tmp_path / "out.npz"))
    np.testing.assert_allclose(got["data2/grad_norm"], got["1x1/grad_norm"],
                               rtol=LOSS_RTOL)
    keys = [k[len("1x1/m/"):] for k in got if k.startswith("1x1/m/")]
    assert keys and len(got) == 2 * len(keys) + 2
    for k in keys:
        want = got["1x1/m/" + k]
        np.testing.assert_allclose(got["data2/m/" + k], want, rtol=0,
                                   atol=MOMENT_ATOL * np.abs(want).max(),
                                   err_msg=k)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(argv, model=1):
    """The entry point on ``2 * model`` gloo ranks (``--data 2 --model
    model``) under ``torch.distributed.run`` at a free port; returns the
    ranks' stdout."""
    launch = [sys.executable, "-m", "torch.distributed.run",
              "--nproc-per-node", str(2 * model), "--master-addr",
              "127.0.0.1", "--master-port", str(_free_port()),
              "-m", "repro_torch.launch.train", "--data", "2",
              "--model", str(model)] + argv
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(launch, capture_output=True, text=True,
                         timeout=180, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _state(ckpt, step):
    path = ckpt / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    return manifest["metadata"], {e["key"]: np.load(path / e["file"])
                                  for e in manifest["leaves"]}


def test_entry_point_under_torchrun_resumes_across_mesh_sizes(tmp_path,
                                                              capsys):
    """--data 2 for 4 steps, resumed to 6 on --data 1; --data 1 for 2
    steps, resumed to 4 on --data 2, and the same step 2 resumed to 4 on
    --data 2 --model 2: every step's data position and state are those of
    a straight --data 1 run (sum-order tolerance)."""
    straight, a, b = tmp_path / "straight", tmp_path / "a", tmp_path / "b"
    c = tmp_path / "c"
    base = ["--reduced", "--batch", "4", "--seq", "32", "--device", "cpu",
            "--ckpt-every", "2"]
    train_mod.main(base + ["--steps", "6", "--ckpt-dir", str(straight)])
    out = _torchrun(base + ["--steps", "4", "--ckpt-dir", str(a)])
    assert "restored" not in out and "'final_step': 4.0" in out
    train_mod.main(base + ["--steps", "6", "--ckpt-dir", str(a)])
    train_mod.main(base + ["--steps", "2", "--ckpt-dir", str(b)])
    shutil.copytree(b, c)
    out = _torchrun(base + ["--steps", "4", "--ckpt-dir", str(b)])
    assert "[train] restored step 2" in out and "'final_step': 4.0" in out
    out = _torchrun(base + ["--steps", "4", "--ckpt-dir", str(c)], model=2)
    assert "[train] restored step 2" in out and "'final_step': 4.0" in out
    printed = capsys.readouterr().out
    assert "[train] restored step 4" in printed
    model = LM(get_config("qwen2-0.5b", reduced=True))
    initial = {"params/" + k: v.float().numpy() for k, v in tree_leaves(
        model.init_params(torch.Generator().manual_seed(0), device="cpu"))}
    for ckpt, step in ((a, 4), (a, 6), (b, 4), (c, 4)):
        meta, leaves = _state(ckpt, step)
        want_meta, want = _state(straight, step)
        assert meta == want_meta and sorted(leaves) == sorted(want)
        # the gradients are bf16, as the parameters: each rank's part of the
        # batch sum is rounded before the ranks' parts are added, so the
        # moments differ from the straight run's by up to 1.1 % of a leaf's
        # largest entry (measured on the CPU at steps 4 and 6), and each
        # parameter by half a bf16 step plus what that moves AdamW's update
        # (at most the learning rates summed so far; the key bias, whose
        # exact gradient is 0, steps on rounding noise alone).  That bound
        # is as large as the updates themselves, so each leaf's summed gap
        # is held to a quarter of how far the straight run moved it from
        # its initial value (measured: at most 5.9 %, the key bias; a run
        # that skipped or misdirected its updates gives 100 % or more).
        lr_sum = sum(3e-4 * t / 100 for t in range(1, step + 1))
        for k, v in leaves.items():
            w = want[k]
            if v.dtype == np.uint16:
                v, w = ((x.astype(np.uint32) << 16).view(np.float32)
                        for x in (v, w))
                assert np.all(np.abs(v - w) <= 2 ** -8 * np.abs(w) + lr_sum
                              ), k
                moved = np.abs(w - initial[k]).sum()
                assert np.abs(v - w).sum() <= MOVED_TOL * moved, k
            elif v.dtype == np.float32:
                np.testing.assert_allclose(v, w, rtol=0, atol=MOMENT_TOL *
                                           np.abs(w).max(), err_msg=k)
            else:
                np.testing.assert_array_equal(v, w, err_msg=k)


_MESH_SIZES = """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_mesh, make_production_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
for multi_pod, need in ((False, 256), (True, 512)):
    try:
        make_production_mesh(multi_pod=multi_pod)
    except RuntimeError as e:
        assert f"need {need} ranks" in str(e) and "has 8" in str(e), e
    else:
        raise AssertionError("8 ranks made a production mesh")
try:
    make_mesh({"data": 4, "model": 4})
except RuntimeError as e:
    assert "need 16 devices, have 8" in str(e), e
else:
    raise AssertionError("8 ranks made a 16-rank mesh")
mesh = make_mesh({"data": 4, "model": 2})
assert mesh.mesh_dim_names == ("data", "model") and mesh.device_type == "cpu"
dist.destroy_process_group()
print("OK")
"""


def test_make_production_mesh_refuses_8_ranks():
    assert run_script(_MESH_SIZES, timeout=120).strip().endswith("OK")
