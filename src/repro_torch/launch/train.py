"""Training driver: data pipeline -> train loop -> checkpoints, on one
device (``cuda`` unless the caller passes ``device="cpu"``).

Production behaviors, as the reference's (``repro/launch/train.py``):
  * restart-from-latest-checkpoint (exact data-position resume),
  * async checkpointing every ``ckpt_every`` steps with retention,
  * SIGTERM/SIGINT emergency checkpoint (preemption handling),
  * heartbeat + straggler runtime hooks (single-host here; the monitors
    are the same objects a multi-host coordinator would drive).

The mesh (``--data`` / ``--model`` above 1) and the int8-compressed
gradient sync come with the mesh slice of the port (ROADMAP.md, queue A
item 10).

CPU-scale usage (``examples/train_tiny_torch.py`` wraps this)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time
from typing import Dict, Optional

import torch

from ..checkpoint import CheckpointManager, latest_step, load_checkpoint
from ..configs import ARCH_IDS, get_config
from ..configs.base import ShapeCell
from ..core.machine import resolve_device
from ..data import DataConfig, make_train_batches
from ..models.common import ShapeDtype, tree_map
from ..models.lm import LM
from ..optim import AdamWConfig, adamw_init
from ..optim.adamw import _scale_shape
from ..runtime import HeartbeatMonitor, StragglerDetector
from .steps import make_train_step

MESH_NOT_PORTED = ("a data or model mesh above 1 is not ported yet "
                   "(ROADMAP.md, queue A item 10: the mesh modules)")


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
    return {k: torch.from_numpy(x).to(device) for k, x in batch.items()}


def train_loop(cfg, cell: ShapeCell, loop: TrainLoopConfig,
               opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
               device=None) -> Dict[str, float]:
    """Runs the loop on ``device`` (default ``cuda``); returns the final
    step's metrics as floats, with ``step_time_s`` and ``final_step``.
    Restartable: with a checkpoint in ``loop.ckpt_dir`` it resumes from the
    latest one, at its data position.  Parameters are drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=loop.steps)
    model = LM(cfg)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=cell.seq_len,
                          global_batch=cell.global_batch, seed=seed)
    heart = HeartbeatMonitor([loop.host])
    straggler = StragglerDetector()
    manager = CheckpointManager(loop.ckpt_dir) if loop.ckpt_dir else None
    step_fn = make_train_step(model, opt_cfg)

    start_step, start_doc = 0, 0
    if loop.ckpt_dir and latest_step(loop.ckpt_dir) is not None:
        state, meta = load_checkpoint(
            loop.ckpt_dir, state_template(model, opt_cfg.state_format),
            device=dev)
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

    batches = make_train_batches(data_cfg, start_doc=start_doc)
    interrupted = {"flag": False}

    def on_signal(signum, frame):
        interrupted["flag"] = True

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
            if interrupted["flag"]:
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
                    help="data-parallel mesh extent (1: the mesh is not "
                         "ported yet)")
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel mesh extent (1: the mesh is not "
                         "ported yet)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.data != 1 or args.model != 1:
        raise NotImplementedError(MESH_NOT_PORTED)

    cfg = get_config(args.arch, reduced=args.reduced)
    cell = ShapeCell("custom", args.seq, args.batch, "train")
    loop = TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every)
    metrics = train_loop(cfg, cell, loop, device=args.device)
    print(f"[train] done: {metrics}")


if __name__ == "__main__":
    main()
