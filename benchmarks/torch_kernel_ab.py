"""Two trees of the PyTorch/CUDA port, kernel against kernel, on one card.

Times ``mdscatter_`` at the store walks of its three routes (the
``transpose`` pattern's contiguous store, its transposing walk, whole rows
colliding; fp32, 8192 lanes, image 50176, 1 and 1024 images, all lanes
active), ``mdgather`` at three load walks (the transposing walk, a
contiguous run, gemm's replicating row walk), ``int8_matmul`` /
``bitplane_matmul`` (8 and 4 planes) at qwen2-0.5b's MLP shape (x 4096x896
@ w 896x4864), each beside its PyTorch library call (the gather and the
scatter also with their device time alone: calls queued behind a sleeping
kernel), ``flash_attention`` at qwen2-0.5b's prefill and
``chip_smoke.py``'s family shapes and ``flash_attention_bwd`` at its
training shapes (bf16 and fp32, device time), and the host cost of the
flash route
(:func:`measure_flash_route`), for every source tree given, in the order
given.  Each tree runs in a process of its own
(both are the package ``repro_torch``) and builds its kernels into its own
``build/``.  Needs a CUDA device.

    python -m benchmarks.torch_kernel_ab --src OLD/src src src OLD/src \\
        --out chiprun_out/ab.json

Run the trees in turns (old, new, new, old) so that a drift of the card
shows as a difference between the two runs of one tree.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BATCH, LANES, IMAGE = 1024, 8192, 50176
SCATTER_WALKS = {"contiguous": ((512, 16), (1, 512), 0),
                 "distinct": ((512, 16), (49, 1), 0),
                 "colliding": ((64, 128), (1, 0), 0)}
GATHER_WALKS = {"transposing": ((512, 16), (49, 1), 0),
                "contiguous": ((8192,), (1,), 0),
                "replicating": ((64, 128), (0, 16), 0)}
MLP_SHAPE = (4096, 896, 4864)
# chip_smoke.py::TRAIN_SHAPES, (B, H, Hkv, Sq, Sk, D, causal)
FLASH_BWD_SHAPES = {"whisper_encoder": (4, 8, 8, 1500, 1500, 64, False),
                    "whisper_cross": (4, 8, 8, 384, 1500, 64, False),
                    "vision_cross": (4, 32, 8, 1024, 1024, 128, False),
                    "qwen2_causal": (4, 14, 2, 1024, 1024, 64, True)}
# the flash forward's device time in bf16 and fp32: qwen2-0.5b's prefill
# and chip_smoke.py::FAMILY_SHAPES, (B, H, Hkv, Sq, Sk, D, causal)
FLASH_FWD_TIMED = {"qwen2_prefill": (4, 14, 2, 1024, 1024, 64, True),
                   "vision_self": (4, 32, 8, 1024, 1024, 128, True),
                   "vision_cross": (4, 32, 8, 1024, 1024, 128, False),
                   "whisper_encoder": (4, 8, 8, 1500, 1500, 64, False),
                   "whisper_self": (4, 8, 8, 384, 384, 64, True),
                   "whisper_cross": (4, 8, 8, 384, 1500, 64, False),
                   "vision_decode_cross": (4, 32, 8, 1, 1024, 128, False),
                   "whisper_decode_cross": (4, 8, 8, 1, 1500, 64, False)}
# qwen2-0.5b's flash forward at one query row (a decode step's) and at its
# prefill; whisper-base's steps at chip_smoke.py's training cell
FLASH_FWD_SHAPES = {"qwen2_decode": (4, 14, 2, 1, 1024, 64),
                    "qwen2_prefill": (4, 14, 2, 1024, 1024, 64)}
STEP_BATCH, WHISPER_TEXT = 4, 384


def time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device time per call with the host out of the way: the calls are
    queued behind a sleeping kernel, so the device runs them back to back
    (``time_ms`` times what a caller sees, host overhead included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)          # ~0.1 s, longer than the queueing
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure_flash_fwd() -> dict:
    """The flash forward's device time at ``FLASH_FWD_TIMED``, bf16 and
    fp32."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for name, (b, h, hk, sq, sk, d, causal) in FLASH_FWD_TIMED.items():
        for dtype, label in ((torch.bfloat16, "bf16"),
                             (torch.float32, "fp32")):
            q = torch.randn(b, h, sq, d, generator=gen, device="cuda"
                            ).to(dtype)
            k, v = (torch.randn(b, hk, sk, d, generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            out[f"flash_attention {name} {label} device"] = device_ms(
                lambda: flash_attention(q, k, v, causal=causal), 20)
    return out


def measure_flash_bwd() -> dict:
    """The flash backward's device time at ``FLASH_BWD_SHAPES``, bf16 and
    fp32, on o and lse from the forward kernel."""
    import torch

    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention_bwd)

    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for name, (b, h, hk, sq, sk, d, causal) in FLASH_BWD_SHAPES.items():
        for dtype, label in ((torch.bfloat16, "bf16"),
                             (torch.float32, "fp32")):
            q, do = (torch.randn(b, h, sq, d, generator=gen, device="cuda")
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, hk, sk, d, generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            o, lse = _forward(q, k, v, causal, 1.0 / d ** 0.5, with_lse=True)
            out[f"flash_attention_bwd {name} {label} device"] = device_ms(
                lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal), 10)
    return out


def wall_ms(fn, iters: int) -> float:
    """The least wall time of ``iters`` calls of ``fn``, the card
    synchronised after each: what a caller waits for one call, host and
    device, with as little of the other tenants' load on the host as the
    run saw."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def host_us(fn, iters: int) -> float:
    """The host's µs a call of ``fn``: ``iters`` calls queued behind a
    sleeping kernel, so that the device never makes the host wait; the
    least of 5 rounds."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        torch.cuda._sleep(50_000_000)       # ~30 ms, longer than the calls
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / iters * 1e6


def measure_flash_route() -> dict:
    """What the flash route costs a caller, host time included: the bf16
    forward at ``FLASH_FWD_SHAPES`` called back to back (``time_ms``;
    at one query row the host's work a call sets the pace) beside its
    device time, and the host's µs a call of ``flash_attention`` beside
    those of the bare launch ``_forward`` (the difference: what the route
    adds to the launch on the host); whisper-base as published, bf16
    weights from a seed: one
    decode step (4 rows, cache of 384 text tokens and 1500 frames) and one
    training step (4 x 384 text tokens over 4 x 1500 frames, AdamW), each
    ``wall_ms``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_train_batches
    from repro_torch.kernels.flash_attention import _forward, flash_attention
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, adamw_init

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for name, (b, h, hk, sq, sk, d) in FLASH_FWD_SHAPES.items():
        q = torch.randn(b, h, sq, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, hk, sk, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        call = (lambda: flash_attention(q, k, v, causal=True))
        out[f"flash_attention {name} bf16"] = time_ms(call, 200)
        out[f"flash_attention {name} bf16 device"] = device_ms(call, 200)
        out[f"flash_attention {name} bf16 host_us"] = host_us(call, 100)
        out[f"_forward {name} bf16 host_us"] = host_us(
            lambda: _forward(q, k, v, True, d ** -0.5, False), 100)
    cfg = get_config("whisper-base")
    model = LM(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    frames = torch.randn(STEP_BATCH, cfg.num_frames, cfg.d_model,
                         generator=gen, device="cuda").bfloat16()
    batch = next(make_train_batches(DataConfig(cfg.vocab_size, WHISPER_TEXT,
                                               STEP_BATCH, seed=0)))
    batch = {**{k: torch.from_numpy(x).cuda() for k, x in batch.items()
                if k != "next_doc"}, "frames": frames}
    with torch.no_grad():
        logits, cache = make_prefill_step(model)(params, {
            "tokens": batch["tokens"], "positions": batch["positions"],
            "frames": frames})
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        decode = make_decode_step(model)
        out["whisper-base decode step"] = wall_ms(
            lambda: decode(params, cache, tok, WHISPER_TEXT - 1), 50)
    train = make_train_step(model, AdamWConfig())
    state = adamw_init(params)
    out["whisper-base train step"] = wall_ms(
        lambda: train(params, state, batch), 20)
    return out


def measure() -> dict:
    """Every time, from the ``repro_torch`` first on ``sys.path``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    return {**measure_mve(gen), **measure_gemm(gen), **measure_flash_fwd(),
            **measure_flash_bwd(), **measure_flash_route()}


def measure_mve(gen) -> dict:
    """``mdscatter_`` and ``mdgather`` at their walks, 1024 and 1 image,
    beside ``index_copy_`` / ``index_select``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.mdgather import mdgather
    from repro_torch.kernels.mdscatter import mdscatter_

    mask = torch.ones(LANES, dtype=torch.bool, device="cuda")
    out = {}
    for batch, iters in ((BATCH, 50), (1, 500)):
        shape = (batch, IMAGE) if batch > 1 else (IMAGE,)
        dst = torch.randn(shape, generator=gen, device="cuda")
        vals = torch.randn(shape[:-1] + (LANES,), generator=gen,
                           device="cuda")
        for route, (dims, strides, base) in SCATTER_WALKS.items():
            addr = ref.mdv_lane_addresses(dims, strides, base, LANES,
                                          "cuda")
            call = (lambda: mdscatter_(dst, vals, dims, strides, base,
                                       mask))
            lib = (lambda: dst.index_copy_(-1, addr, vals))
            out[f"mdscatter {route} B={batch}"] = time_ms(call, iters)
            out[f"index_copy_ {route} B={batch}"] = time_ms(lib, iters)
            out[f"mdscatter {route} B={batch} device"] = device_ms(call, 100)
            out[f"index_copy_ {route} B={batch} device"] = device_ms(lib,
                                                                     100)
        for name, (dims, strides, base) in GATHER_WALKS.items():
            addr = ref.mdv_lane_addresses(dims, strides, base, LANES,
                                          "cuda")
            call = (lambda: mdgather(dst, dims, strides, base, lanes=LANES))
            if not torch.equal(call(), ref.mdgather_ref(dst, dims, strides,
                                                        base, LANES)):
                raise AssertionError(f"mdgather != its plain version: {name}")
            lib = (lambda: torch.index_select(dst, -1, addr))
            out[f"mdgather {name} B={batch}"] = time_ms(call, iters)
            out[f"index_select {name} B={batch}"] = time_ms(lib, iters)
            out[f"mdgather {name} B={batch} device"] = device_ms(call, 100)
            out[f"index_select {name} B={batch} device"] = device_ms(lib,
                                                                     100)
    return out


def measure_gemm(gen) -> dict:
    """``int8_matmul`` and ``bitplane_matmul`` at ``MLP_SHAPE`` beside
    ``torch._int_mm``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bitplane_gemm import (bitplane_matmul,
                                                   int8_matmul)

    out = {}
    m, k, n = MLP_SHAPE
    x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int16).to(torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int16).to(torch.int8)
    if not torch.equal(int8_matmul(x, w), ref.int8_matmul_ref(x, w)):
        raise AssertionError("int8_matmul != its plain version")
    out["int8_matmul"] = time_ms(lambda: int8_matmul(x, w), 50)
    out["bitplane_matmul 8"] = time_ms(lambda: bitplane_matmul(x, w), 50)
    out["bitplane_matmul 4"] = time_ms(lambda: bitplane_matmul(x, w, 4), 50)
    out["torch._int_mm"] = time_ms(lambda: torch._int_mm(x, w), 50)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", nargs="+", default=["src"],
                    help="the trees' src directories, in the order to run")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.one:
        sys.path.insert(0, str(Path(args.src[0]).resolve()))
        print(json.dumps(measure()), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    rows = [{"card": card, "torch": torch.__version__}]
    print(json.dumps(rows[0]), flush=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for src in args.src:
        proc = subprocess.run(
            [sys.executable, "-m", "benchmarks.torch_kernel_ab", "--one",
             "--src", src], check=True, capture_output=True, text=True,
            env=env, cwd=Path(__file__).resolve().parents[1], timeout=900)
        rows.append({"src": src, **json.loads(proc.stdout.splitlines()[-1])})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
