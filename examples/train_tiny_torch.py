"""Train a small LM end-to-end on the PyTorch/CUDA port with its
production driver (``repro_torch.launch.train``): the packed data
pipeline, AdamW, async checkpoints, restart.  The twin of
``examples/train_tiny.py``.

    PYTHONPATH=src python examples/train_tiny_torch.py              # cuda
    PYTHONPATH=src python examples/train_tiny_torch.py --device cpu

Use --arch to pick any of the 10 assigned architectures (reduced size);
--full-shapes runs a larger variant (~15M params) for a real loss curve.
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.train import TrainLoopConfig, train_loop
from repro_torch.optim import AdamWConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-shapes", action="store_true",
                    help="~15M params instead of the smoke config")
    ap.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch, reduced=True)
    if args.full_shapes:
        cfg = dataclasses.replace(cfg, d_model=256, num_layers=4,
                                  d_ff=1024, vocab_size=8192)
    cell = ShapeCell("tiny", args.seq, args.batch, "train")
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps)

    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt:
        print(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M "
              f"device={args.device} ckpts -> {ckpt}")
        loop = TrainLoopConfig(steps=args.steps, ckpt_dir=ckpt,
                               ckpt_every=50, log_every=10)
        metrics = train_loop(cfg, cell, loop, opt_cfg=opt,
                             device=args.device)
        print(f"done: loss={metrics['loss']:.4f} "
              f"({metrics['step_time_s'] * 1e3:.0f} ms/step)")
        print("restart demo: rerunning resumes from the checkpoint")
        metrics2 = train_loop(cfg, cell, loop, opt_cfg=opt,
                              device=args.device)
        print(f"resumed run final loss: {metrics2['loss']:.4f}")


if __name__ == "__main__":
    main()
