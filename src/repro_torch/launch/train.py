"""Training driver: data pipeline -> train loop -> checkpoints, on one
device (``cuda`` unless the caller passes ``device="cpu"``) or over a data
mesh of ranks.

Production behaviors, as the reference's (``repro/launch/train.py``):
  * restart-from-latest-checkpoint (exact data-position resume),
  * async checkpointing every ``ckpt_every`` steps with retention,
  * SIGTERM/SIGINT emergency checkpoint (preemption handling),
  * heartbeat + straggler runtime hooks (single-host here; the monitors
    are the same objects a multi-host coordinator would drive).

Parallelism: under ``torchrun`` (``WORLD_SIZE`` set, ``--data D --model
M`` on ``D * M`` ranks) every rank runs the loop over a ``(data, model)``
mesh through :func:`~repro_torch.launch.steps.jitted_cell`: FSDP and data
parallelism over ``data``, tensor, sequence and expert parallelism over
``model``.  The int8-compressed gradient sync is
:mod:`repro_torch.parallel.compression`'s data-parallel trainer.

CPU-scale usage (``examples/train_tiny_torch.py`` wraps this)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --reduced --steps 4 --batch 4 --seq 32 --data 2 --model 2 \\
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .. import obs
from ..checkpoint import CheckpointManager, latest_step, load_checkpoint
from ..configs import ARCH_IDS, get_config
from ..configs.base import ShapeCell
from ..core.machine import resolve_device
from ..data import DataConfig, make_train_batches
from ..models.common import ShapeDtype
from ..models.lm import LM
from ..optim import AdamWConfig, adamw_init
from ..optim.adamw import _scale_shape
from ..parallel.axes import place, sharding_context
from ..runtime import HeartbeatMonitor, StragglerDetector
from ..trees import tree_map
from .mesh import make_mesh
from .steps import jitted_cell, make_train_step, state_shardings


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    host: str = "host0"


def state_template(model: LM, state_format: str) -> Dict:
    """The shapes of a checkpointed ``{"params", "opt"}`` tree (what
    :func:`~repro_torch.checkpoint.load_checkpoint` restores into)."""
    params = model.abstract_params()

    def moment(leaf):
        if state_format == "int8":
            return {"q": ShapeDtype(leaf.shape, torch.int8),
                    "s": ShapeDtype(_scale_shape(leaf.shape),
                                    torch.float32)}
        return ShapeDtype(leaf.shape, torch.float32)

    return {"params": params,
            "opt": {"m": tree_map(moment, params),
                    "v": tree_map(moment, params),
                    "step": ShapeDtype((), torch.int32)}}


def _batch_to(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    with obs.span("launch.batch_to"):
        return {k: torch.from_numpy(x).to(device) for k, x in batch.items()}


def train_loop(cfg, cell: ShapeCell, loop: TrainLoopConfig,
               opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
               device=None, mesh=None) -> Dict[str, float]:
    """Runs the loop on ``device`` (default ``cuda``); returns the final
    step's metrics as floats, with ``step_time_s`` and ``final_step``.
    Restartable: with a checkpoint in ``loop.ckpt_dir`` it resumes from the
    latest one, at its data position.  Parameters are drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.

    With a ``mesh`` (of ``device``'s type) every rank of it runs the loop:
    the step is :func:`~repro_torch.launch.steps.jitted_cell`'s, the state
    lives as DTensors on :func:`~repro_torch.launch.steps.state_shardings`,
    every rank reads the whole batch and steps on its rows, and rank 0
    writes the checkpoints, whole, in the single-device format (so either
    run resumes the other's).  Without one (the default) nothing is
    distributed: the reference's ``(1, 1)`` mesh, in values."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=loop.steps)
    model = LM(cfg)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=cell.seq_len,
                          global_batch=cell.global_batch, seed=seed)
    heart = HeartbeatMonitor([loop.host])
    straggler = StragglerDetector()
    shardings = None
    if mesh is None:
        step_fn = make_train_step(model, opt_cfg)
    else:
        if mesh.device_type != dev.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                             f"{dev}")
        with sharding_context(mesh) as ctx:
            step_fn, _ = jitted_cell(cfg, cell, ctx, opt_cfg=opt_cfg)
            shardings = state_shardings(model, opt_cfg, ctx)
    writer = mesh is None or dist.get_rank() == 0
    manager = (CheckpointManager(loop.ckpt_dir, writer=writer)
               if loop.ckpt_dir else None)

    start_step, start_doc = 0, 0
    if loop.ckpt_dir and latest_step(loop.ckpt_dir) is not None:
        state, meta = load_checkpoint(
            loop.ckpt_dir, state_template(model, opt_cfg.state_format),
            device=dev, shardings=shardings)
        params, opt_state = state["params"], state["opt"]
        if opt_cfg.state_format == "fp32":
            for name in ("m", "v"):
                opt_state[name] = tree_map(lambda x: x.to(torch.float32),
                                           opt_state[name])
        start_step = int(meta["step"])
        start_doc = int(meta.get("next_doc", 0))
        print(f"[train] restored step {start_step} "
              f"(doc {start_doc}) from {loop.ckpt_dir}", flush=True)
    else:
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(seed), device=dev)
        opt_state = adamw_init(params, opt_cfg.state_format)
        if shardings is not None:
            params = tree_map(place, params, shardings["params"])
            opt_state = tree_map(place, opt_state, shardings["opt"])

    batches = make_train_batches(data_cfg, start_doc=start_doc)
    interrupted = {"flag": False}

    def on_signal(signum, frame):
        interrupted["flag"] = True

    def stop() -> bool:
        """The flag, agreed by every rank (a save is a collective)."""
        if mesh is None:
            return interrupted["flag"]
        flag = torch.tensor(float(interrupted["flag"]), device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag)

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:          # not the main thread (tests)
            pass

    metrics: Dict[str, float] = {}
    step = start_step
    try:
        for step in range(start_step, loop.steps):
            t0 = time.time()
            batch = next(batches)
            next_doc = int(batch.pop("next_doc"))
            params, opt_state, m = step_fn(params, opt_state,
                                           _batch_to(batch, dev))
            metrics = {k: float(v) for k, v in m.items()}   # waits
            dt = time.time() - t0
            heart.beat(loop.host)
            straggler.record(loop.host, dt)
            metrics["step_time_s"] = dt
            if (step + 1) % loop.log_every == 0:
                print(f"[train] step {step + 1} "
                      f"loss={metrics['loss']:.4f} "
                      f"lr={metrics['lr']:.2e} {dt * 1e3:.0f}ms", flush=True)
            state = {"params": params, "opt": opt_state}
            meta = {"step": step + 1, "next_doc": next_doc}
            if manager and (step + 1) % loop.ckpt_every == 0:
                manager.save_async(step + 1, state, meta)
            if stop():
                if manager:
                    manager.save_emergency(step + 1, state, meta)
                    print(f"[train] emergency checkpoint at "
                          f"step {step + 1}", flush=True)
                break
    finally:
        if manager:
            manager.wait()
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
    metrics["final_step"] = float(
        min(loop.steps, step + 1) if loop.steps else 0)
    return metrics


def _train_on_mesh(args, cfg, cell: ShapeCell, loop: TrainLoopConfig,
                   world: int) -> Dict[str, float]:
    """One rank of a ``torchrun`` job: a ``(data, model)`` mesh over the
    job's ranks (NCCL on ``cuda:LOCAL_RANK``, or gloo on the CPU under
    ``--device cpu``); the process group is started here unless the caller
    started one."""
    if args.device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        torch.cuda.set_device(dev)
        backend = "nccl"
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=world)
    try:
        mesh = make_mesh({"data": args.data, "model": args.model})
        return train_loop(cfg, cell, loop, device=dev, mesh=mesh)
    finally:
        if own:
            dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel mesh extent (ranks from torchrun)")
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel mesh extent (tensor, sequence and "
                    "expert parallelism; ranks from torchrun)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu: gloo ranks)")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world != args.data * args.model:
        raise RuntimeError(
            f"--data {args.data} --model {args.model} needs "
            f"{args.data * args.model} ranks and WORLD_SIZE is {world}: "
            f"start them with torchrun --nproc-per-node "
            f"{args.data * args.model} -m repro_torch.launch.train ...")

    cfg = get_config(args.arch, reduced=args.reduced)
    cell = ShapeCell("custom", args.seq, args.batch, "train")
    loop = TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every)
    if "WORLD_SIZE" in os.environ:
        metrics = _train_on_mesh(args, cfg, cell, loop, world)
    else:
        metrics = train_loop(cfg, cell, loop, device=args.device)
    print(f"[train] done: {metrics}")


if __name__ == "__main__":
    main()
