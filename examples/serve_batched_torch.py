"""End-to-end serving on the PyTorch/CUDA port (the twin of
``examples/serve_batched.py``).

One prefill of a batch of prompts through ``make_prefill_step`` (its
attention is the hand-written flash kernel on ``cuda``, the plain PyTorch
version on ``cpu``), then a stream of requests through the
continuous-batching engine whose slot management is the MVE
dimension-level mask (one mask bit per request, Section III-E).  The
weights are random, drawn from a seeded ``torch.Generator``; the port has
no training loop yet, so the reference example's training pass is left out.

    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
    PYTHONPATH=src python examples/serve_batched_torch.py           # cuda
    PYTHONPATH=src python examples/serve_batched_torch.py --full    # 0.5B

``--full`` serves qwen2-0.5b at its published width (on a card); the
default is the reduced config made 2 layers deep with a head dim of 64,
so prefill takes the flash route there too.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.machine import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import ContinuousBatchingEngine, Request
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import LM


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="qwen2-0.5b at full width instead of the reduced "
                         "config")
    args = ap.parse_args()
    device = resolve_device(args.device)      # raises without a card
    cfg = get_config("qwen2-0.5b", reduced=not args.full)
    if not args.full:
        cfg = dataclasses.replace(cfg, num_layers=2, num_heads=2,
                                  num_kv_heads=1, head_dim=64)
    model = LM(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen, device=device)

    print(f"== prefill ({cfg.name}, {cfg.num_layers} layers) ==")
    b, s = 2, 64
    tokens = torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                           device=device)
    positions = torch.arange(s, dtype=torch.int32,
                             device=device).expand(b, s)
    launches = flash_attention.launches
    logits, cache = make_prefill_step(model)(
        params, {"tokens": tokens, "positions": positions})
    print(f"logits {tuple(logits.shape)}, cache k {tuple(cache['k'].shape)}, "
          f"flash kernel launches {flash_attention.launches - launches}")

    print("\n== continuous batching ==")
    engine = ContinuousBatchingEngine(cfg, params, batch_slots=4,
                                      max_seq=48, device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(10):
        ln = int(rng.integers(2, 8))
        engine.submit(Request(
            rid=i, prompt=rng.integers(1, cfg.vocab_size, ln)
            .astype(np.int32), max_new_tokens=int(rng.integers(2, 6))))
    done = engine.run_until_drained()
    dt = time.time() - t0

    n_tokens = sum(len(r.output) for r in done.values())
    print(f"completed {len(done)} requests, {n_tokens} tokens "
          f"in {dt:.1f}s ({engine.steps} batched decode steps on "
          f"{engine.device})")
    for rid in sorted(done):
        r = done[rid]
        ttft = (r.first_token_at - r.submitted_at)
        print(f"  req {rid}: prompt={len(r.prompt)} out={r.output} "
              f"ttft={ttft*1e3:.0f}ms")
    print(f"peak slot occupancy used the MVE mask CR: "
          f"{engine.grid.top} slots")


if __name__ == "__main__":
    main()
