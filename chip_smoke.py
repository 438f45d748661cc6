#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU, ``nvcc``
and PyTorch built for CUDA::

    python3 chip_smoke.py

It needs no arguments, no network and no file beyond the checkout.  It
drives the port's main paths on the card, each held against its reference
there or on the CPU; the kernels themselves are held against their plain
versions by the ``card`` tests (``python -m pytest -m card
tests/test_torch_<module>_card.py``: the build, ``mdv``, ``float_ops``,
``gemm``, ``flash``, ``flash_segments``, ``ssd_chunk``), which it runs
first, and timed by ``python -m benchmarks.torch_kernel_ab --src src``.  Phases, each printing
one JSON line; any failure raises and the exit code is non-zero:

1. ``device``  — ``torch.cuda`` must be available; the card's name and
   power limit as ``nvidia-smi`` gives them.
2. ``card``    — the ``card`` tests above, all of them, run in this
   process by ``pytest.main``: every kernel the drives below launch is
   first held against its plain version; a failure or a skip raises.
4. ``path``    — the MVE main path at the Table IV geometry
   (``MVEConfig()``, 8192 lanes): every one of the 14 Section-IV patterns
   at its default size through ``compile_program(..., mode="fused").run``
   on ``cuda``,
   checked against the pattern's NumPy reference, fused == stepwise bit for
   bit (both on the card), trace priced by the cost model; then
   ``run_pattern_batch`` over 1024 seeds for every pattern whose program
   does not depend on the seed, equal to per-image runs on a sample.
5. ``lm``      — the LM serving path at qwen2-0.5b's full published width
   (24 layers, d_model 896, 14/2 heads, head_dim 64, d_ff 4864, vocab
   151936), random bf16 weights from a seeded ``torch.Generator`` on the
   card: ``make_prefill_step`` on 4 x 1024 tokens (24 flash launches),
   2 ``decode_step``s held against prefill one token longer (1e-3, on
   the weights cast to float32 in place; the bf16 difference is
   recorded), a ``(B,)`` cache index bit-equal to the scalar one, 16
   greedy decode steps, and a ``ContinuousBatchingEngine`` of 4 slots
   answering 8 requests, each checked against a one-slot engine
   (``drive_family``, shared with 5b); a float8 KV cache written through
   ``update_cache`` on the card (the overflow edges, ROADMAP C12), its
   bytes equal to the same writes on the CPU.
6. ``quantized`` — ``quantized_matmul`` at the MLP shape, both
   ``bitserial`` values, equal to the plain product and close to the float
   one.
4b. ``vm``     — the same path through the program-as-data VM
   (``compile_program(..., mode="vm")`` on ``cuda``: the reference's
   lowering and signature, run by the fused datapath): the 14 patterns,
   each checked against its NumPy reference and equal bit for bit to fused
   and stepwise on the card (traces equal), all on the one default
   signature; a ``run_batch`` of ``VM_BATCH`` (1024) images of every
   pattern whose program does not depend on the seed, equal to the fused
   batch; nine trap programs (NaN and ±inf into integer loads and
   ``vcvt``, shifts by 0, 31, 32, past and negative, ``vroti``, float16
   arithmetic, and x86's NaN and denormal bits: NaN in one operand or
   both, ``inf - inf``, ``0 * inf``, signalling payloads, float16 round
   trips and memory, denormals through every float operation) equal to
   fused and stepwise on the card and to the VM on the CPU, bit for bit,
   NaN payloads included; a CUDA tensor reaching a plain version of
   ``mdgather``/``mdscatter`` or of the float ops fails.  Prints
   the VM's and fused's ``run`` ms (one image) and ``run_batch`` ms (1024),
   the mean of back-to-back calls (``time_ms``) and device time.
4c. ``targets`` — each of the 13 registered targets compiles and runs the
   14 patterns on ``cuda``, memory bit-equal to fused; the modeled cycles
   per target and pattern.
4g. ``claims`` (right after 4c) — the paper's results through the
   benchmark twins (``benchmarks/torch_paper_claims.py``, ``torch_run``'s
   sections): the nine paper sections (Table II, Figs. 7-13, Table V) at
   full size on ``cuda`` — fig9's gemm up to 1024 x 128, fig12b's gemm
   and spmm at 2048-16384 lanes, fig13's unregistered ``rvv-1d@<scheme>``
   targets — then the quick ``engine``, ``frontend``, ``targets``,
   ``timing``, ``opt``, ``kernels`` (the int8 and bit-plane GEMMs at 256^3,
   fp32 causal flash at 2 x 4 x 256 x 64, beside their plain versions),
   ``silicon`` and ``resilience`` sections and
   ``examples/mve_patterns_torch.py``, no CUDA tensor reaching a plain
   version in a wrapper.  Every paper row equal to the same section run on
   the CPU in this process (name, value, derived string), ``table2`` and
   ``fig7`` equal to ``tests/data/golden_traces.json`` (read only), the
   priced ``targets`` and ``timing`` rows equal to the CPU's, every memory
   image the target API returns on ``cuda``, the example's table equal to
   the CPU's.  Prints each section's seconds, the paper's averages,
   ``fig9/crossover``, ``fig13/*``, ``tableV/total|neon`` and the
   ``kernels`` rows.
4d. ``opt``    — the 14 patterns compiled at ``opt_level=None`` and at each
   level up to ``MAX_OPT_LEVEL``, one image and (seed-independent
   programs) a batch of 1024 images on ``cuda``: memory, registers and
   Tag bit-equal to ``opt_level=None``; device ms and launches per batch
   (5 batches in one profiled window) per level and pattern.
4e. ``serve``  — the 64-request Table III stream
   (``benchmarks/torch_serving_bench.request_stream``) through
   ``MVEProgramServer`` on ``cuda``: per-request ``run`` in sequence, a
   cold scheduler, a warmed server (best of 3 replays) and one profiled
   replay; every ticket resolves bit-equal to the port's stepwise run on
   the CPU, no demotion, no CUDA tensor reaching a plain version; then the
   seeded 10 % ``FaultPlan`` (``seed=2026``, ``sticky_rids=(11,)``, the
   cross audit on every request): the firing log equal to the CPU run's,
   request 11 quarantined, every other request bit-exact.  Prints
   requests/s (sequential, cold, steady), p50/p95 latency, the device's
   busy share, host-blocking calls per drain cycle, chaos wall time over
   clean.
4f. ``nn``     — the ``repro_torch.nn`` model-block zoo on the MVE path:
   ``model_blocks("qwen2-0.5b", seq_len=128)`` at full size (qwen2's KV,
   attention and GEMM tiles, mamba2's SSM state, llama4-scout's routing)
   and the six ``BLOCK_KERNELS`` at their defaults, each under
   ``mode="fused"`` and ``mode="vm"`` on ``cuda``, one image and 1024:
   held against the block's oracle on the card (bit for bit; ``attn_tile``
   within ``ATTN_RTOL``) and bit-equal to the CPU run; priced on
   ``mve-bs`` and ``rvv-1d`` equal to the CPU; device ms, launches and
   busy share per batch and per image.  Then the ``serving_lm`` block
   stream (``benchmarks/torch_serving_bench.lm_block_stream``, 26
   requests) through ``MVEScheduler`` on ``cuda``, every ticket bit-equal
   to the CPU stepwise run and passing its block's check.
5b. ``lm_families`` — LM serving for the ``ssm``, ``hybrid``, ``moe``,
   ``vlm`` and ``encdec`` families at their published widths, random bf16
   weights drawn on the card: mamba2-2.7b (32 of 64 layers), zamba2-2.7b
   (24 of 54; its head_dim of 80 takes the plain attention route, no
   flash), llama4-scout-17b-a16e (4 of 48 layers: the whole model is 215
   GB in bf16), llama-3.2-vision-11b (all 40 layers and 8 gated cross
   layers, the gates set to ``VLM_GATE``: declared zero, they would add
   nothing) and whisper-base (6 + 6 layers).  Each as 5: a 4 x 1024
   prefill (whisper: 384 tokens; the vision model's 4 x 1024 image
   embeddings and whisper's 4 x 1500 frames drawn at the shapes
   ``models/specs.py`` declares), the flash launches per prefill and per
   decode step exact (llama4 4 and 0, vision 48 and 8, whisper 18 and 6:
   every cross attention, in decode at one query row, takes the kernel),
   the declared cache shapes (``cross_k``/``cross_v`` too), decode
   against prefill one token longer in float32 within 1e-3 (llama4 with
   capacity for every token: capacity_factor = num_experts, so neither
   drops one), 16 greedy decode steps at B = 4, and the 4-slot engine,
   its 8 requests each held against a one-slot engine; right after each
   admission the slot's recurrent state (``ssm``, ``conv``) must be all
   zero, and a reused slot must have held its last request's state just
   before (ROADMAP C9); the engine's cross caches stay zero, as the
   reference's (ROADMAP C10).  In 5 and 5b a CUDA tensor reaching the
   plain flash version fails the run.
5c. ``train`` — training at full width, random bf16 weights from a
   seeded ``torch.Generator`` on the card.  qwen2-0.5b as published
   through ``train_loop`` (8 x 1024 tokens from ``make_train_batches``,
   fp32 moments, 6 steps, a checkpoint every 3), then 3 steps in a fresh
   directory and a new ``train_loop`` call restarting from its checkpoint
   to step 6: the final loss equal to the straight run's (bit for bit, or
   within 5e-3: which is printed); finite loss, grad norm > 0, every
   self attention through the segmented flash kernels (packed batches
   carry segment ids: each forward launch segmented, 2 forward launches a
   backward one under remat "full", no plain chunk); one more step profiled
   (busy share, launches), peak memory, the checkpoint's save and restore
   timed.  whisper-base (6 + 6 layers) through ``make_train_step``: 4
   steps of 4 x 384 text tokens over 4 x 1500 frames, flash launches per
   step exact (30 forward: 18 + the 12 of remat's recompute; 18
   backward); one step profiled; a float32 copy of the first step at
   batch 1 on the card against the same step on the CPU (loss within
   1e-4, grad norm within 1e-3 relative; the worst gradient leaf
   printed).  qwen2-0.5b's options (remat and int8 moments), one 8 x 1024
   batch without segment ids: the loss and every gradient leaf under
   remat "dots" and "none" bit-equal to "full" (and "full" to itself),
   48 / 24, 48 / 24 and 24 / 24 flash launches a step; AdamW with int8
   moments from those gradients, its second update (dequantized and
   quantized moments) held against the same update on the CPU from the
   same inputs: ``q`` and ``s`` bit-equal.  A CUDA tensor reaching a
   plain flash version fails the run.
5d. ``mesh`` — a 1-rank process group (``cpu:gloo,cuda:nccl``) and a
   ``(data 1, model 1)`` mesh on the card, whose ``model`` axis runs every
   ``constrain`` site of the models as a ``DTensor`` redistribution and
   the flash route on the rank's own heads: whisper-base through
   ``jitted_cell``'s train cell bit-equal to ``make_train_step`` for 3
   steps (30 / 18 flash launches a step); each family's prefill and
   decode through ``jitted_cell``'s cells bit-equal to ``LM.prefill`` /
   ``LM.decode_step`` (``MODEL_AXIS``: qwen2-0.5b as published, 4 x 1024
   and 16 steps; the others at published widths and a few layers, 2
   steps), the flash launches of ``lm_families``' rule, one decode step
   profiled on each path; the int8-compressed sync over qwen2-0.5b's
   whole gradient bit-equal to the CPU's; ``make_dp_train_step``; a
   one-stage pipeline; ``train.main`` resumed bit for bit.
5e. ``dryrun`` — the dry run held against the card: whisper-base's train
   cell (5d's 4 x 384 text tokens over 4 x 1500 frames) and qwen2-0.5b's
   prefill (4 x 1024) through ``jitted_cell`` on a ``(data 1, model 1)``
   NCCL mesh under ``launch/hlo_analysis.CostCounter``, seeded random bf16
   weights, beside the same cells counted on ``meta`` (a ``fake`` group
   of one rank, in a subprocess): the flops equal and above 0, the flash
   launches 5d's and 5's (30 / 18 a train step, 24 a prefill), the
   results finite; printed: the predicted peak beside
   ``max_memory_allocated``, ``Roofline.bound_s`` beside the busy time of
   a profiled call, the share of the bf16 peak, the bytes counted on the
   card over those on ``meta``.  Meanwhile ``python -m
   repro_torch.launch.dryrun`` runs qwen2-0.5b's ``train_4k`` on 256
   ``fake`` ranks with the roofline analysis and on 512 without, and
   llama4-scout's ``decode_32k`` on 256 (its one MoE group spans the 16
   data ranks), each in a subprocess with no card: each record ``ok``,
   flops, bytes, collective bytes and peak above 0; in two more
   (``benchmarks/torch_model_axis_cells.py``, a mesh each), every
   architecture's reduced train, prefill and decode cells at ``(data 2,
   model 4)`` and ``(data 1, model 4)``, and a MoE decode whose group
   spans the data ranks, on ``fake`` ranks must run under this host's
   torch (ROADMAP C14, C15); in another (``benchmarks/torch_moe_span_bytes.py``), the
   collective bytes that llama4-scout's gather of its group adds to one
   layer must be the prediction, 128 tokens x 5120 x 2 bytes.
7. the card line, the ``{"kernels": [...]}`` line (each kernel's source,
   the TPU kernel it replaces and its launches over the phases), and the
   final ``{"ok": true, "device": {...}}`` line.

Phases 4, 4b, 4d, 4e, 4f, 4g, 5, 5b, 5c, 5d, 5e and 6 are the main
paths: the launch counters of the kernels each runs are set to 0 just
before it and read just after (4b: around the VM's runs alone, before they
are compared; 4e: around the fault-free serving, not the chaos replays; 4f
and 4g: around the card runs, after the CPU references); a kernel never
launched there fails the run.  The kernels line's ``launches`` adds 4, 4b,
4d, 4e, 4f and 4g for the MVE kernels, 5, 5b, 5c, 5d, 5e and 4g for flash
attention, 5c, 5d and 5e for its backward, 6 and 4g for the int8 and
bit-plane GEMMs.  Without a CUDA device, or
without the rest of the checkout beside it, the script exits non-zero and
prints no result line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from benchmarks.torch_kernel_ab import (  # noqa: E402
    BATCH, HBM_BYTES_PER_S, HEAD_DIM, KV_HEADS, LANES, LM_BATCH, LM_SEQ,
    MLP_SHAPE, Q_HEADS, device_ms, device_profile, time_ms)

KERNELS = {                    # name: (CUDA source, the TPU kernel replaced)
    "mdgather": ("mdgather", "src/repro/kernels/mdgather.py:33"),
    "mdscatter": ("mdscatter", "src/repro/kernels/mdscatter.py:24"),
    "flash_attention": ("flash_attention",
                        "src/repro/kernels/flash_attention.py:25"),
    # no Pallas kernel stands behind the backward either: the line is the
    # reference's checkpointed attention chunk, whose gradient JAX derives
    "flash_attention_bwd": ("flash_attention_bwd",
                            "src/repro/models/attention.py:105"),
    "int8_matmul": ("bitplane_gemm", "src/repro/kernels/bitplane_gemm.py:35"),
    "bitplane_matmul": ("bitplane_gemm",
                        "src/repro/kernels/bitplane_gemm.py:43"),
    # no Pallas kernel stands behind these two: the line is the reference's
    # XLA float add (and a load's conversion) whose bits they give
    "float_binary": ("float_ops", "src/repro/core/interp.py:214"),
    "float_convert": ("float_ops", "src/repro/core/interp.py:156"),
}
SAMPLE = (0, BATCH // 2, BATCH - 1)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bits(x: torch.Tensor) -> torch.Tensor:
    """Integer view of a tensor, for bit-for-bit comparison."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.contiguous().view(view[x.element_size()])


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def states_equal(a, b) -> bool:
    return (torch.equal(bits(a.memory), bits(b.memory))
            and set(a.regs) == set(b.regs)
            and all(a.regs[r].dtype == b.regs[r].dtype
                    and torch.equal(bits(a.regs[r]), bits(b.regs[r]))
                    for r in a.regs)
            and torch.equal(a.tag, b.tag))


def drive_main_path():
    from repro_torch.core import MVEConfig, compile_program, cost
    from repro_torch.core.interp import MVEInterpreter
    from repro_torch.core.machine import to_numpy
    from repro_torch.core.patterns import PATTERNS, run_pattern_batch

    cfg = MVEConfig()
    assert cfg.lanes == LANES
    oracle = MVEInterpreter(cfg, compiled=False)      # device: cuda
    rows = {}
    t0 = time.perf_counter()
    for name in sorted(PATTERNS):
        run = PATTERNS[name]()
        cp = compile_program(run.program, cfg, mode="fused")   # cuda
        mem, state = cp.run(run.memory)
        if mem.device.type != "cuda":
            raise AssertionError(f"{name}: ran on {mem.device}")
        run.check(to_numpy(mem), state)
        if not torch.isfinite(mem).all():
            raise AssertionError(f"{name}: non-finite memory")
        _, step_state = oracle.run_stepwise(run.program, run.memory)
        if not states_equal(state, step_state):
            raise AssertionError(f"{name}: fused != stepwise on the card")
        if len(state.trace) != len(step_state.trace) or not all(
                a.same_as(b) for a, b in zip(state.trace, step_state.trace)):
            raise AssertionError(f"{name}: traces differ")
        tl = cost.simulate(state.trace, cfg)
        energy = cost.mve_energy(tl, cfg, cost.data_bytes(state.trace))
        rows[name] = {"instructions": len(run.program),
                      "cycles": tl.total_cycles,
                      "energy_pj": energy.total_pj}
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    batched = []
    seeds = list(range(BATCH))
    for name in sorted(PATTERNS):
        probe = [PATTERNS[name](seed=s) for s in (0, 1)]
        if probe[0].program != probe[1].program:
            continue                      # data-dependent program (fir, spmm)
        runs, mems = run_pattern_batch(name, seeds, cfg, mode="fused")
        if mems.shape != (BATCH,) + runs[0].memory.shape:
            raise AssertionError(f"{name}: batch came back ragged")
        cp = compile_program(runs[0].program, cfg, mode="fused")
        for s in SAMPLE:
            one, _ = cp.run(runs[s].memory)
            if not np.array_equal(to_numpy(one).view(np.int32),
                                  mems[s].view(np.int32)):
                raise AssertionError(f"{name}: batch != run for seed {s}")
            runs[s].check(mems[s], None)
        batched.append(name)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    if len(batched) < 10:
        raise AssertionError(f"only {batched} ran batched")
    return rows, batched, single_s, batch_s


# ---------------------------------------------------------------------------
# phase 4b: the program-as-data VM (mode="vm") on the same path
# ---------------------------------------------------------------------------

VM_BATCH = 1024
VM_ITERS = 5
_SPECIAL = [float("nan"), float("inf"), float("-inf"), 3e9, -3e9, 1e10,
            -1.5, 300.7, 70000.0, -70000.0, 255.5, -0.0, 65504.0, 65520.0,
            1e-8, 2.0 ** 31]


def _special_image() -> np.ndarray:
    mem = np.zeros(4096)
    mem[:len(_SPECIAL)] = _SPECIAL
    rng = np.random.default_rng(3)
    mem[64:128] = rng.integers(-2 ** 31, 2 ** 31, 64)
    mem[128:192] = [0, 31, 32, -1, -5, 40, 1, 16] * 8
    mem[256:320] = rng.standard_normal(64) * 1000
    mem[320:384] = rng.standard_normal(64) / 1000
    return mem


def vm_trap_programs() -> dict:
    """``{name: (program, image)}``, one program per place where CUDA torch
    differs from XLA (the same programs ``tests/test_torch_vm_programs.py``
    and ``tests/test_torch_float_ops.py`` hold against the reference on the
    CPU): NaN, ±inf and out-of-range floats into integer loads and
    ``vcvt``; ``vshi`` by 0, 31, 32 and past, and ``vshr`` by register
    amounts 0, 31, 32, -1, -5, 40; ``vroti``; float16 add/sub/mul; and
    x86's NaN and denormal bits (ROADMAP C7): NaN in ``a`` only, in ``b``
    only, in both with other payloads and signs, ``inf - inf``,
    ``0 * inf``, signalling payloads, float16 round trips, a float16
    image, float32 denormals through every float operation."""
    from repro_torch.core import isa as I
    from repro_torch.core.isa import DType, Op
    n = len(_SPECIAL)
    nonfinite = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, n),
                 I.vsld(DType.F, 0, 0, 1)]
    for k, dt in enumerate([DType.B, DType.W, DType.DW, DType.QW]):
        nonfinite += [I.vsld(dt, 1, 0, 1), I.vsst(dt, 1, 1024 + 32 * k, 1),
                      I.vcvt(dt, 2, 0), I.vsst(dt, 2, 2048 + 32 * k, 1)]
    nonfinite += [I.vsld(DType.HF, 3, 0, 1), I.vcvt(DType.B, 4, 3),
                  I.vsst(DType.DW, 4, 3072, 1)]
    head = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, 64),
            I.vsld(DType.DW, 0, 64, 1)]
    shifts, k = head + [I.vsld(DType.DW, 1, 128, 1)], 0
    for dt in (DType.B, DType.W, DType.DW):
        for amt in (0, 1, 7, 8, 15, 16, 31, 32, 33, -1, -7, -8, -31, -32,
                    -33):
            shifts += [I.vshi(dt, 2, 0, amt),
                       I.vsst(dt, 2, 1024 + 64 * k, 1)]
            k += 1
        shifts += [I.vshr_reg(dt, 3, 0, 1), I.vsst(dt, 3, 1024 + 64 * k, 1)]
        k += 1
    rotates, k = list(head), 0
    for dt in (DType.B, DType.W, DType.DW, DType.QW):
        for amt in (0, 1, 7, 8, 9, 15, 16, 31, 32, 33, 63, 64, -1):
            rotates += [I.Instr(Op.ROTI, dtype=dt, vd=1, vs1=0, imm=amt),
                        I.vsst(dt, 1, 1024 + 64 * k, 1)]
            k += 1
    half = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, 64),
            I.vsld(DType.HF, 0, 256, 1), I.vsld(DType.HF, 1, 320, 1),
            I.vsld(DType.F, 2, 256, 1)]
    for k, f in enumerate([I.vadd, I.vsub, I.vmul]):
        half += [f(DType.HF, 3, 0, 1), I.vsst(DType.HF, 3, 1024 + 64 * k, 1),
                 f(DType.HF, 4, 2, 0), I.vsst(DType.HF, 4, 2048 + 64 * k, 1),
                 f(DType.HF, 5, 3, 4)]
    half += [I.vsld(DType.HF, 6, 0, 1), I.vadd(DType.HF, 7, 6, 6),
             I.vsst(DType.HF, 7, 3072, 1)]
    image = _special_image()
    traps = {"nonfinite_to_int": nonfinite, "shifts": shifts,
             "rotates": rotates, "half_rounding": half}
    traps = {name: (prog, image) for name, prog in traps.items()}
    head = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, 64)]

    def arith(dt):
        p = head + [I.vsld(dt, 0, 0, 1), I.vsld(dt, 1, 64, 1)]
        for k, f in enumerate([I.vadd, I.vsub, I.vmul]):
            p += [f(dt, 2 + k, 0, 1), I.vsst(dt, 2 + k, 1024 + 64 * k, 1),
                  f(dt, 5 + k, 1, 0)]
        return p + [I.vadd(dt, 8, 2, 3), I.vmul(dt, 9, 8, 1),
                    I.vsst(dt, 9, 2048, 1)]

    conversions = head + [
        I.vsld(DType.F, 0, 0, 1), I.vcvt(DType.HF, 1, 0),
        I.vcvt(DType.F, 2, 1), I.vsst(DType.F, 2, 1024, 1),
        I.vsld(DType.HF, 3, 64, 1), I.vsst(DType.HF, 3, 2048, 1),
        I.vsld(DType.F, 4, 2048, 1), I.vcvt(DType.HF, 5, 4),
        I.vadd(DType.HF, 6, 1, 3), I.vsst(DType.HF, 6, 3072, 1)]
    denormals = head + [I.vsld(DType.F, 0, 0, 1), I.vsld(DType.F, 1, 64, 1)]
    for k, f in enumerate([I.vadd, I.vsub, I.vmul, I.vmin, I.vmax]):
        denormals += [f(DType.F, 2 + k, 0, 1),
                      I.vsst(DType.F, 2 + k, 1024 + 64 * k, 1)]
    for k, op in enumerate([Op.GT, Op.GTE, Op.LT, Op.LTE, Op.EQ, Op.NEQ]):
        denormals += [I.vcmp(op, DType.F, 0, 1),
                      I.vadd(DType.F, 8, 0, 1, predicated=True),
                      I.vsst(DType.F, 8, 2048 + 64 * k, 1)]
    half_memory = arith(DType.HF) + [
        I.vcvt(DType.F, 10, 0), I.vcvt(DType.F, 11, 1),
        I.vadd(DType.F, 12, 10, 11), I.vsst(DType.F, 12, 3072, 1),
        I.vcvt(DType.HF, 13, 12)]
    nan_image = _pair_image(NAN_PAIRS)
    traps.update({
        "nan_arith_f": (arith(DType.F), nan_image),
        "nan_arith_hf": (arith(DType.HF), nan_image),
        "conversions": (conversions, nan_image),
        "half_memory": (half_memory, _half_image()),
        "denormals": (denormals, _pair_image(DENORMAL_PAIRS))})
    return traps


# x86's NaN and denormal cases as float32 bit patterns (a, b): quiet and
# signalling NaNs with payloads and both signs in a, in b, in both;
# infinities for inf - inf and 0 * inf; denormals against zeros, normals
# and each other, and products either side of the least normal float32.
_QA, _QB, _SA, _SB, _PA = (0x7FC12345, 0xFFC54321, 0x7F812345, 0xFF854321,
                           0x7FE00000)
_ONE, _TWO, _INF, _NINF = 0x3F800000, 0x40000000, 0x7F800000, 0xFF800000
NAN_PAIRS = [(_QA, _ONE), (_ONE, _QB), (_QA, _QB), (_QB, _QA), (_SA, _TWO),
             (_TWO, _SB), (_SA, _SB), (_SB, _QA), (_QA, _SB), (_INF, _INF),
             (0, _INF), (_INF, 0), (_NINF, _NINF), (_INF, _NINF),
             (_PA, _ONE), (_ONE, _PA), (_PA, _SB), (0x80000000, _INF),
             (_NINF, 0x80000000)]
DENORMAL_PAIRS = [(0x0054B477, 0), (0x80000001, 0), (0x00800000, 0x80000000),
                  (0x00400000, 0x00000001), (_ONE, 0x00000001),
                  (0x891FDE68, 0x0054B477), (0x00800001, 0x80800000),
                  (0x20506A6A, 0x93BB0106), (0x00FFFFFF, 0x3F000000),
                  (0x807FFFFF, 0x00000001), (0x00000001, 0x80000001),
                  (0x3F3C9172, 0x00ADC5D1), (0xBF60A954, 0x0091DAE3)]


def _pair_image(pairs) -> np.ndarray:
    mem = np.zeros(4096, np.uint32)
    a, b = zip(*pairs)
    mem[:len(a)], mem[64:64 + len(b)] = a, b
    return mem.view(np.float32)


def _half_image() -> np.ndarray:
    """A float16 image: signalling and quiet NaNs with payloads, both
    signs, infinities, subnormals and the extremes."""
    h = np.zeros(4096, np.uint16)
    h[:16] = [0x7C01, 0xFC01, 0x7D55, 0xFE2A, 0x7E00, 0x7C00, 0xFC00,
              0x0001, 0x8001, 0x03FF, 0x7BFF, 0xFBFF, 0x3C00, 0x0000,
              0x8000, 0x7FFF]
    h[64:80] = [0x3C00, 0x7C01, 0xFD00, 0x7C00, 0xFC00, 0x0001, 0x8000,
                0x7E01, 0x0400, 0x7BFF, 0x7BFF, 0x3C00, 0xFC01, 0x7C00,
                0x0000, 0x0001]
    return h.view(np.float16)


# traps the VM hosts (the others fall back to fused, as in the reference)
VM_HOSTED_TRAPS = ("nonfinite_to_int", "shifts", "rotates", "half_rounding",
                   "conversions", "denormals")


def _no_plain_version_on_cuda():
    """Wrap the plain versions of ``mdgather``/``mdscatter_``, of the
    float ops and of flash attention (forward, with ``lse``, backward)
    where their wrappers call them, so
    that a CUDA tensor reaching one raises; returns the restore
    function."""
    from repro_torch.kernels import flash_attention as a, float_ops as f, \
        mdgather as g, mdscatter as s
    names = ((g, "mdgather_ref"), (s, "mdscatter_ref"),
             (f, "float_binary_ref"), (f, "float_convert_ref"),
             (a, "flash_attention_ref"), (a, "flash_attention_lse_ref"),
             (a, "flash_attention_bwd_ref"))
    saved = [getattr(mod, name) for mod, name in names]

    def guard(fn):
        def wrapped(*args, **kw):
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in args):
                raise AssertionError(f"{fn.__name__} reached with a CUDA "
                                     "tensor")
            return fn(*args, **kw)
        return wrapped

    for (mod, name), fn in zip(names, saved):
        setattr(mod, name, guard(fn))

    def restore():
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)
    return restore


def drive_vm():
    """The VM path alone (the launch counters see only it): the 14 patterns
    through ``compile_program(..., mode="vm").run`` on ``cuda``, a
    ``run_batch`` of ``VM_BATCH`` images of every pattern whose program
    does not depend on the seed, and the trap programs.  Returns the
    results for :func:`check_vm`."""
    from repro_torch.core import MVEConfig, compile_program
    from repro_torch.core.machine import as_memory
    from repro_torch.core.patterns import PATTERNS

    cfg = MVEConfig()
    out = {"single": {}, "batch": {}, "traps": {}}
    restore = _no_plain_version_on_cuda()
    try:
        for name in sorted(PATTERNS):
            run = PATTERNS[name]()
            cp = compile_program(run.program, cfg, mode="vm")  # cuda
            if cp.mode != "vm":
                raise AssertionError(f"{name}: fell back to {cp.mode}")
            out["single"][name] = (run, cp, cp.run(run.memory))
            probe = [PATTERNS[name](seed=s) for s in (0, 1)]
            if probe[0].program != probe[1].program:
                continue
            runs = [PATTERNS[name](seed=s) for s in range(VM_BATCH)]
            images = as_memory(np.stack([r.memory for r in runs]), "cuda")
            out["batch"][name] = (runs, images, cp.run_batch(images))
        for name, (prog, image) in vm_trap_programs().items():
            cp = compile_program(prog, cfg, mode="vm")
            if cp.mode != "vm" and name in VM_HOSTED_TRAPS:
                raise AssertionError(f"trap {name}: fell back")
            out["traps"][name] = (prog, image, cp.run(image))
        torch.cuda.synchronize()
    finally:
        restore()
    return out


def _batch_equal(a, b) -> bool:
    (ma, ra, ta), (mb, rb, tb) = a, b
    return (torch.equal(bits(ma), bits(mb)) and set(ra) == set(rb)
            and all(ra[k].dtype == rb[k].dtype
                    and torch.equal(bits(ra[k]), bits(rb[k])) for k in ra)
            and torch.equal(ta, tb))


def check_vm(out):
    """The VM's results against fused and stepwise on the card (bit for
    bit, traces equal), its batches against the fused batches, the
    traps also against the VM on the CPU; then the VM's and fused's times
    per pattern (host clock per call, and device ms with the calls queued
    back to back)."""
    from repro_torch.core import MVEConfig, compile_program, vm
    from repro_torch.core.interp import MVEInterpreter
    from repro_torch.core.machine import as_memory, to_numpy

    cfg = MVEConfig()
    oracle = MVEInterpreter(cfg, compiled=False)
    sigs, rows = set(), {}
    for name, (run, cp, (mem, state)) in out["single"].items():
        run.check(to_numpy(mem), state)
        fused = compile_program(run.program, cfg, mode="fused")
        _, f_state = fused.run(run.memory)
        _, s_state = oracle.run_stepwise(run.program, run.memory)
        for what, other in (("fused", f_state), ("stepwise", s_state)):
            if not states_equal(state, other):
                raise AssertionError(f"{name}: vm != {what} on the card")
            if len(state.trace) != len(other.trace) or not all(
                    a.same_as(b) for a, b in zip(state.trace, other.trace)):
                raise AssertionError(f"{name}: vm trace != {what}")
        sigs.add(cp._vm._signature(run.memory.shape[0]))
        image = as_memory(run.memory, "cuda")
        row = {}
        for mode, c in (("vm", cp), ("fused", fused)):
            row[f"{mode}_run_ms"] = time_ms(lambda: c.run(image), VM_ITERS)
            row[f"{mode}_run_device_ms"] = device_ms(
                lambda: c.run_async(image), VM_ITERS)
        rows[name] = row
    if sigs != {vm.default_signature(cfg)}:
        raise AssertionError(f"the 14 programs map to {sigs}, not the one "
                             "default signature")
    for name, (runs, images, got) in out["batch"].items():
        fused = compile_program(runs[0].program, cfg, mode="fused")
        if not _batch_equal(got, fused.run_batch(images)):
            raise AssertionError(f"{name}: vm batch != fused batch")
        for s in SAMPLE:
            runs[s].check(to_numpy(got[0][s]), None)
        cp = out["single"][name][1]
        row = rows[name]
        for mode, c in (("vm", cp), ("fused", fused)):
            row[f"{mode}_batch_ms"] = time_ms(lambda: c.run_batch(images), 3)
            row[f"{mode}_batch_device_ms"] = device_ms(
                lambda: c.run_batch_async(images), 3)
    traps = {}
    for name, (prog, image, (mem, state)) in out["traps"].items():
        for what, other in (
                ("fused", compile_program(prog, cfg, mode="fused")),
                ("stepwise", None)):
            other = oracle.run_stepwise(prog, image)[1] if other is None \
                else other.run(image)[1]
            if not states_equal(state, other):
                raise AssertionError(f"trap {name}: vm != {what}")
        # the CPU run is the one the tests hold bit for bit against the
        # reference: equal here too, NaN payloads and signs included
        cpu = compile_program(prog, cfg, mode="vm", device="cpu").run(image)
        if not states_equal(state, _to_cuda_state(cpu[1])):
            raise AssertionError(f"trap {name}: vm on the card != vm on "
                                 "the cpu")
        nans = sum(int(torch.isnan(v).sum()) for v in
                   [state.memory] + list(state.regs.values())
                   if v.is_floating_point())
        traps[name] = {"instructions": len(prog), "nan_lanes_equal": nans}
    return {"patterns": rows, "batched": sorted(out["batch"]),
            "batch": VM_BATCH, "traps": traps,
            "signature": list(vm.default_signature(cfg))}


def _to_cuda_state(state):
    import copy
    st = copy.copy(state)
    st.memory = state.memory.cuda()
    st.regs = {k: v.cuda() for k, v in state.regs.items()}
    st.tag = state.tag.cuda()
    return st


# ---------------------------------------------------------------------------
# phase 4d: the optimizer (opt_level=) on the card
# ---------------------------------------------------------------------------

OPT_SEEDS = 16               # distinct images, tiled to the 1024-image batch
OPT_ITERS = 5                # batches per profiled window (one window drops
                             # or repeats a few events now and then)


def drive_opt():
    """The 14 patterns compiled at ``opt_level=None`` and at every level up
    to ``MAX_OPT_LEVEL``, run on one image and (where the program does not
    depend on the seed) on a batch of 1024 images on ``cuda``.  Returns
    the results for :func:`check_opt`."""
    from repro_torch import opt
    from repro_torch.core import MVEConfig, compile_program
    from repro_torch.core.machine import as_memory
    from repro_torch.core.patterns import PATTERNS

    cfg = MVEConfig()
    levels = [None] + list(range(opt.MAX_OPT_LEVEL + 1))
    out = {}
    for name in sorted(PATTERNS):
        run = PATTERNS[name]()
        probe = [PATTERNS[name](seed=s) for s in (0, 1)]
        images = None
        if probe[0].program == probe[1].program:
            seeds = [PATTERNS[name](seed=s).memory for s in range(OPT_SEEDS)]
            images = as_memory(np.stack(seeds * (BATCH // OPT_SEEDS)),
                               "cuda")
        rows = {}
        for level in levels:
            cp = compile_program(run.program, cfg, mode="fused",
                                 opt_level=level)
            rows[level] = (cp, cp.run(run.memory)[1],
                           None if images is None else cp.run_batch(images))
        out[name] = (images, rows)
    torch.cuda.synchronize()
    return out


def check_opt(out):
    """Every level bit-equal to ``opt_level=None`` (memory, registers,
    Tag; one image and the batch); device ms and launches per 1024-image
    batch at each level (``OPT_ITERS`` batches in one profiled window)."""
    per_level, per_pattern = {}, {}
    for name, (images, rows) in out.items():
        _, base, base_batch = rows[None]
        for level, (cp, state, batch) in rows.items():
            if not states_equal(state, base):
                raise AssertionError(f"{name}: opt_level={level} != None")
            if batch is not None and not _batch_equal(batch, base_batch):
                raise AssertionError(f"{name}: opt_level={level} batch "
                                     "!= None")
            row = {"instructions": len(cp.program)}
            agg = per_level.setdefault(str(level), {
                "instructions": 0, "batch_device_ms": 0.0,
                "batch_launches": 0})
            agg["instructions"] += row["instructions"]
            if images is not None:
                prof = device_profile(lambda: [cp.run_batch_async(images)
                                               for _ in range(OPT_ITERS)])
                row.update(batch_device_ms=prof["device_busy_ms"]
                           / OPT_ITERS,
                           batch_launches=prof["device_launches"]
                           / OPT_ITERS)
                agg["batch_device_ms"] += row["batch_device_ms"]
                agg["batch_launches"] += row["batch_launches"]
            per_pattern.setdefault(name, {})[str(level)] = row
    return {"levels": per_level, "patterns": per_pattern,
            "batched": sorted(n for n, (im, _) in out.items()
                              if im is not None), "batch": BATCH}


# ---------------------------------------------------------------------------
# phase 4e: MVE program serving (MVEProgramServer / MVEScheduler)
# ---------------------------------------------------------------------------

SERVE_REPLAYS = 3            # measured steady replays (the best is kept)


def _host_state_equal(result, want) -> bool:
    mem, regs, tag = want
    return (np.array_equal(result.memory.view(np.uint8), mem.view(np.uint8))
            and set(result.regs) == set(regs)
            and all(np.array_equal(np.asarray(result.regs[r]).view(np.uint8),
                                   regs[r].view(np.uint8)) for r in regs)
            and np.array_equal(np.asarray(result.tag), tag))


def serve_reference(stream) -> list:
    """Each request's stepwise run on the CPU, as host arrays."""
    from repro_torch.core.interp import MVEInterpreter
    from repro_torch.core.machine import to_numpy
    oracle = MVEInterpreter(compiled=False, device="cpu")
    out = []
    for _, r in stream:
        mem, st = oracle.run_stepwise(r.program, r.memory)
        out.append((to_numpy(mem), {k: to_numpy(v) for k, v in
                                    st.regs.items()}, to_numpy(st.tag)))
    return out


def drive_serve(stream):
    """The 64-request Table III stream through ``MVEProgramServer`` on
    ``cuda``: per-request ``run`` in sequence, a cold scheduler (VM tier,
    program cache cleared), a warmed server (``promote_after=2``), one
    replay of it under the profiler.  A CUDA tensor reaching a plain
    version fails."""
    from benchmarks.torch_serving_bench import replay, sequential_run
    from repro_torch.core import MVEConfig
    from repro_torch.core.engine import clear_cache
    from repro_torch.launch.serve import MVEProgramServer
    from repro_torch.runtime.scheduler import MVEScheduler

    cfg, n = MVEConfig(), len(stream)
    restore = _no_plain_version_on_cuda()
    try:
        seq_s = sequential_run(cfg, stream, "cuda", 1)
        clear_cache()
        cold = MVEScheduler(cfg, promote_after=None)
        cold_s, cold_tickets = replay(cold, stream)
        server = MVEProgramServer(cfg=cfg, promote_after=2, max_batch=16)
        sched = server.scheduler

        def serve():
            reqs = [server.submit(r.program, r.memory) for _, r in stream]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.run_until_drained()
            return time.perf_counter() - t0, reqs

        for _ in range(2):
            serve()
        best = None
        for _ in range(SERVE_REPLAYS):
            syncs, drains = sched.host_syncs, sched.stats.drains
            wall, reqs = serve()
            cycles = sched.stats.drains - drains
            if best is None or wall < best[0]:
                best = (wall, reqs, (sched.host_syncs - syncs) / cycles)
        wall, reqs, syncs_per_cycle = best
        lat = np.array([q.latency for q in reqs])
        reqs2 = [server.submit(r.program, r.memory) for _, r in stream]
        prof = device_profile(server.run_until_drained)
        idle = device_profile(lambda: None)   # the profiler's own calls
        sched.close()
    finally:
        restore()
    return {"requests": n, "sequential_s": seq_s, "cold_s": cold_s,
            "steady_s": wall, "cold_tickets": cold_tickets,
            "steady": reqs, "profiled": reqs2, "latency": lat,
            "syncs_per_cycle": syncs_per_cycle, "profile": prof,
            "idle_profile": idle,
            "stats": sched.stats, "health": server.health()}


def chaos_replays(stream, device):
    """The reference's chaos acceptance (``tests/test_resilience.py``) on
    ``device``: the seeded 10 % plan with one sticky request, the cross
    audit on every request; warm clean, warm chaos, then a measured clean
    and a measured chaos replay.  Returns ``(clean s, chaos s, chaos
    tickets, injector, stats)``."""
    from benchmarks.torch_serving_bench import replay
    from repro_torch.core import MVEConfig
    from repro_torch.resilience import FaultInjector, FaultPlan
    from repro_torch.runtime.scheduler import MVEScheduler

    plan = FaultPlan.random(seed=2026, n_requests=len(stream), rate=0.10,
                            sticky_rids=(11,))

    def run(injector=None):
        sched = MVEScheduler(MVEConfig(), promote_after=2,
                             injector=injector, audit_rate=1.0,
                             audit_method="cross", device=device)
        wall, tickets = replay(sched, stream)
        sched.close()
        return wall, tickets, sched

    if torch.device(device).type == "cpu":      # the firing log only
        inj = FaultInjector(plan, sleep=lambda s: None)
        _, tickets, sched = run(inj)
        return None, None, tickets, inj, sched.stats
    run()
    run(FaultInjector(plan))
    clean_s, clean_tickets, _ = run()
    if not all(t.done() and t.error() is None for t in clean_tickets):
        raise AssertionError("the clean replay did not serve every request")
    inj = FaultInjector(plan)
    chaos_s, tickets, sched = run(inj)
    return clean_s, chaos_s, tickets, inj, sched.stats


def check_serve(out, chaos, chaos_cpu, want):
    """Every ticket resolved and bit-equal to the CPU stepwise run, no
    demotion without faults; under the plan, the CPU run's firing log, the
    sticky request quarantined, the rest bit-exact."""
    from repro_torch.resilience import QuarantinedError
    for what, tickets in (("cold", out["cold_tickets"]),
                          ("steady", [q.ticket for q in out["steady"]]),
                          ("profiled", [q.ticket for q in out["profiled"]])):
        for t, w in zip(tickets, want):
            if not t.done() or t.error() is not None:
                raise AssertionError(f"{what}: request {t.rid} not served: "
                                     f"{t.error()!r}")
            if not _host_state_equal(t.result(), w):
                raise AssertionError(f"{what}: request {t.rid} != the CPU "
                                     "stepwise run")
    st = out["stats"]
    if st.demotions or out["health"]["counters"]["demotions"]:
        raise AssertionError(f"{st.demotions} demotions without a fault")
    clean_s, chaos_s, tickets, inj, cstats = chaos
    fired = [(f["site"], f["kind"], f["rid"], f["tier"]) for f in inj.fired]
    cpu_fired = [(f["site"], f["kind"], f["rid"], f["tier"])
                 for f in chaos_cpu[3].fired]
    if fired != cpu_fired:
        raise AssertionError(f"chaos firing log {fired} != the CPU run's "
                             f"{cpu_fired}")
    for t, w in zip(tickets, want):
        if not t.done():
            raise AssertionError(f"chaos: request {t.rid} never resolved")
        if t.rid == 11:
            if not isinstance(t.error(), QuarantinedError):
                raise AssertionError(f"the sticky request resolved "
                                     f"{t.error()!r}")
        elif t.error() is not None or not _host_state_equal(t.result(), w):
            raise AssertionError(f"chaos: request {t.rid} not bit-exact "
                                 f"({t.error()!r})")
    n, prof = out["requests"], out["profile"]
    lat = out["latency"]
    idle = out["idle_profile"]["host_blocking_by_call"]
    blocking = {k: v - idle.get(k, 0)
                for k, v in prof["host_blocking_by_call"].items()
                if v - idle.get(k, 0)}
    return {
        "requests": n,
        "req_per_s": {"sequential_run": n / out["sequential_s"],
                      "scheduler_cold": n / out["cold_s"],
                      "scheduler_steady": n / out["steady_s"]},
        "latency_ms": {"p50": float(np.percentile(lat, 50)) * 1e3,
                       "p95": float(np.percentile(lat, 95)) * 1e3},
        "device_busy_share": prof["device_busy_share"],
        "profiled_drain": {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_launches",
            "host_blocking_calls", "host_blocking_by_call")},
        # less the calls a profiled window of nothing makes
        "host_blocking_calls_per_drain_cycle": sum(blocking.values()),
        "host_blocking_by_call_per_drain_cycle": blocking,
        "host_syncs_per_drain_cycle": out["syncs_per_cycle"],
        "stats": dataclasses.asdict(st),
        "chaos": {"clean_s": clean_s, "chaos_s": chaos_s,
                  "chaos_over_clean": chaos_s / clean_s,
                  "fired": len(fired), "stats": dataclasses.asdict(cstats),
                  "firing_log_equals_cpu": True}}


# ---------------------------------------------------------------------------
# phase 4c: the 13 registered targets
# ---------------------------------------------------------------------------

def drive_targets():
    """Every registered target compiles and runs every pattern on
    ``cuda``: memory bit-equal across targets and to fused; the modeled
    cycles of each (host arithmetic over the run's trace)."""
    from repro_torch import targets
    from repro_torch.core import MVEConfig, compile_program
    from repro_torch.core.patterns import PATTERNS

    cfg = MVEConfig()
    names = targets.list_targets()
    if len(names) != 13:
        raise AssertionError(f"{len(names)} targets registered: {names}")
    cycles = {t: {} for t in names}
    for pattern in sorted(PATTERNS):
        run = PATTERNS[pattern]()
        want, _ = compile_program(run.program, cfg, mode="fused").run(
            run.memory)
        for t in names:
            art = targets.compile(run.program, target=t)       # cuda
            mem, state = art.run(run.memory)
            if mem.device.type != "cuda":
                raise AssertionError(f"{t}: ran on {mem.device}")
            if not torch.equal(bits(mem), bits(want)):
                raise AssertionError(f"{t} != fused on {pattern}")
            cycles[t][pattern] = art.timeline(state).total_cycles
    return {"targets": list(names), "cycles": cycles}


# ---------------------------------------------------------------------------
# phase 4g: the paper's results and the benchmark twins on the card
# ---------------------------------------------------------------------------

CLAIMS_QUICK = ("engine", "frontend", "targets", "timing", "opt", "kernels",
                "silicon", "resilience")
CLAIMS_PRICED = ("targets", "timing")        # rows priced from the trace
CLAIMS_SHOWN = re.compile(r".*/average|fig9/crossover|fig13/.*|"
                          r"tableV/(total|neon)")
GOLDEN = ROOT / "tests" / "data" / "golden_traces.json"


def _mve_patterns_example():
    """``examples/mve_patterns_torch.py`` as a module (examples is not a
    package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "mve_patterns_torch", ROOT / "examples" / "mve_patterns_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_example(device) -> list:
    """The example's printed lines on ``device``."""
    import contextlib
    import io
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _mve_patterns_example().main(device)
    return printed.getvalue().splitlines()


def claims_reference() -> dict:
    """The nine paper sections, the priced quick sections and the example
    on the CPU, in this process: what the card's rows must equal."""
    from benchmarks import torch_paper_claims as claims
    from benchmarks import torch_run
    return {"paper": {name: fn(device="cpu")
                      for name, fn in claims.SECTIONS.items()},
            "priced": {name: torch_run.QUICK_SECTIONS[name]("cpu")
                       for name in CLAIMS_PRICED},
            "example": run_example("cpu")}


def drive_claims() -> dict:
    """The nine paper sections at full size, the eight quick sections and
    the example, all on ``cuda`` with no CUDA tensor reaching a plain
    version in a wrapper; the device of every memory image the target API
    returns is recorded."""
    from benchmarks import torch_paper_claims as claims
    from benchmarks import torch_run
    from repro_torch.targets.base import CompiledArtifact

    out = {"paper": {}, "quick": {}, "seconds": {}, "memory_devices": set()}
    run = CompiledArtifact.run

    def recording(self, memory=None):
        mem, state = run(self, memory)
        out["memory_devices"].add(mem.device.type)
        return mem, state

    restore = _no_plain_version_on_cuda()
    CompiledArtifact.run = recording
    try:
        for name, fn in claims.SECTIONS.items():
            t0 = time.perf_counter()
            out["paper"][name] = fn(device="cuda")
            out["seconds"][name] = time.perf_counter() - t0
        for name in CLAIMS_QUICK:
            t0 = time.perf_counter()
            out["quick"][name] = torch_run.QUICK_SECTIONS.get(
                name, torch_run.SECTIONS[name])("cuda")
            out["seconds"][name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["example"] = run_example("cuda")
        out["seconds"]["example"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        CompiledArtifact.run = run
        restore()
    return out


def check_claims(out, want) -> dict:
    """Every paper row on the card equal to the CPU's (name, value, derived,
    exact), ``table2`` and ``fig7`` equal to the golden file, the priced
    quick rows equal to the CPU's, every memory image on ``cuda``, the
    example's table equal to the CPU's; returns what the phase prints."""
    for name, rows in out["paper"].items():
        if rows != want["paper"][name]:
            bad = [(g, w) for g, w in zip(rows, want["paper"][name])
                   if g != w]
            raise AssertionError(f"{name} on cuda != cpu: {bad[:3]}")
    golden = json.loads(GOLDEN.read_text())
    for name in ("table2", "fig7"):
        got = {n: [us, d] for n, us, d in out["paper"][name]}
        if got != golden[name]:
            raise AssertionError(f"{name} != {GOLDEN.name}")
    for name in CLAIMS_PRICED:
        if out["quick"][name] != want["priced"][name]:
            raise AssertionError(f"{name}: priced rows on cuda != cpu")
    if out["memory_devices"] != {"cuda"}:
        raise AssertionError(f"memory on {out['memory_devices']}")
    table = out["example"][:15]               # the header and 14 patterns
    if table != want["example"][:15]:
        raise AssertionError("the example's table on cuda != cpu")
    if not out["example"][-1].endswith("kernels: OK"):
        raise AssertionError("the example's transpose failed")
    return {
        "section_seconds": out["seconds"],
        "paper_rows": [r for rows in out["paper"].values() for r in rows
                       if CLAIMS_SHOWN.fullmatch(r[0])],
        "paper_equal_to_cpu": True, "golden_equal": ["table2", "fig7"],
        "priced_equal_to_cpu": list(CLAIMS_PRICED),
        "kernels_us": out["quick"]["kernels"],
        "quick_rows": {name: len(rows) for name, rows in out["quick"].items()},
        "example_rows": table}


# ---------------------------------------------------------------------------
# phase 4f: the nn model-block zoo on the MVE path
# ---------------------------------------------------------------------------

NN_BATCH = 1024
NN_SEEDS = 16                # distinct images of each block, tiled to a batch
NN_ITERS = 5                 # batches per profiled window
NN_PRICED = ("mve-bs", "rvv-1d")


def nn_blocks() -> list:
    """``model_blocks("qwen2-0.5b", seq_len=128)`` at full size (qwen2's
    KV, attention and GEMM tiles, mamba2's SSM state, llama4-scout's
    routing) and the six ``BLOCK_KERNELS`` at their defaults, as
    ``[(label, runs)]``: ``NN_SEEDS`` instances of each block from
    distinct seeds, the first the reference's, all one program."""
    import inspect

    from repro_torch.nn import BLOCK_KERNELS, model_blocks

    specs = [model_blocks("qwen2-0.5b", seq_len=128, seed=s)
             for s in range(NN_SEEDS)]
    if len(specs[0]) != 7:
        raise AssertionError(f"model_blocks gave {len(specs[0])} specs")
    blocks = [(f"qwen2-0.5b/{spec.name}", [row[i].run for row in specs])
              for i, spec in enumerate(specs[0])]
    for name, make in sorted(BLOCK_KERNELS.items()):
        seed = inspect.signature(make).parameters["seed"].default
        blocks.append((f"default/{name}",
                       [make(seed=seed + s) for s in range(NN_SEEDS)]))
    for label, runs in blocks:
        if any(r.program != runs[0].program for r in runs):
            raise AssertionError(f"{label}: the seed changed the program")
    return blocks


def nn_reference(blocks) -> dict:
    """Each block's ``NN_SEEDS`` images run as one batch on the CPU
    (fused), each held against its own oracle, and the first instance's
    modeled cycles and energy on ``NN_PRICED``."""
    from repro_torch import targets
    from repro_torch.core import compile_program

    out = {}
    for label, runs in blocks:
        images = torch.from_numpy(np.stack([r.memory for r in runs]))
        mem = compile_program(runs[0].program, mode="fused",
                              device="cpu").run_batch(images)[0]
        for r, image in zip(runs, mem):
            r.check(image)
        prices = {}
        for t in NN_PRICED:
            art = targets.compile(runs[0].kernel, target=t, device="cpu")
            _, st = art.run(runs[0].memory)
            prices[t] = (art.timeline(st).total_cycles,
                         art.energy(st).total_pj)
        out[label] = (mem, prices)
    return out


def drive_nn(blocks) -> dict:
    """Every block on ``cuda`` under ``mode="fused"`` and ``mode="vm"``:
    its first instance as one image, and a batch of ``NN_BATCH`` images in
    which image i is instance ``i % NN_SEEDS``; then priced on
    ``NN_PRICED`` (each target's artifact runs it on the card).  A CUDA
    tensor reaching a plain version fails."""
    from repro_torch import targets
    from repro_torch.core import MVEConfig, compile_program
    from repro_torch.core.machine import as_memory

    cfg = MVEConfig()
    out = {}
    restore = _no_plain_version_on_cuda()
    try:
        for label, runs in blocks:
            run = runs[0]
            seeds = np.stack([r.memory for r in runs])
            images = as_memory(seeds[np.arange(NN_BATCH) % NN_SEEDS], "cuda")
            modes = {}
            for mode in ("fused", "vm"):
                cp = compile_program(run.program, cfg, mode=mode)
                mem, state = cp.run(run.memory)
                modes[mode] = (cp, mem, state, cp.run_batch(images)[0])
            priced = {}
            for t in NN_PRICED:
                art = targets.compile(run.kernel, target=t)
                mem, st = art.run(run.memory)
                priced[t] = (mem, art.timeline(st).total_cycles,
                             art.energy(st).total_pj)
            out[label] = (images, modes, priced)
        torch.cuda.synchronize()
    finally:
        restore()
    return out


def check_nn(blocks, out, want) -> dict:
    """Each result against its own instance's oracle on the card (bit for
    bit; ``attn_tile`` within ``ATTN_RTOL``) and bit-equal to that
    instance's CPU run, the one image and every image of the batch; the
    pricing equal to the CPU's; then device ms, launches and the device's
    busy share per 1024-image batch and per image (``NN_ITERS`` calls in
    one profiled window)."""
    rows = {}
    for label, runs in blocks:
        run = runs[0]
        cpu_mem, cpu_prices = want[label]
        cpu_bits = bits(cpu_mem.cuda())                  # (NN_SEEDS, N)
        images, modes, priced = out[label]
        row = {"instructions": len(run.program), "exactness": run.exactness,
               "distinct_images": NN_SEEDS,
               "max_rel_err": run.error_of(modes["fused"][1])}
        for mode, (cp, mem, state, batch) in modes.items():
            if mem.device.type != "cuda" or batch.device.type != "cuda":
                raise AssertionError(f"{label} {mode}: ran off the card")
            run.check(mem, state)
            for s, r in enumerate(runs):
                r.check(batch[s::NN_SEEDS])
            tiled = bits(batch).view(NN_BATCH // NN_SEEDS, NN_SEEDS, -1)
            if not torch.equal(bits(mem), cpu_bits[0]) or not torch.equal(
                    tiled, cpu_bits.expand_as(tiled)):
                raise AssertionError(f"{label} {mode}: card != CPU")
            batch_prof = device_profile(lambda: [
                cp.run_batch_async(images) for _ in range(NN_ITERS)])
            one_prof = device_profile(lambda: [
                cp.run(run.memory) for _ in range(NN_ITERS)])
            row[mode] = {
                "executor": cp.mode,
                "batch_device_ms": batch_prof["device_busy_ms"] / NN_ITERS,
                "batch_launches": batch_prof["device_launches"] / NN_ITERS,
                "batch_busy_share": batch_prof["device_busy_share"],
                "run_device_ms": one_prof["device_busy_ms"] / NN_ITERS,
                "run_launches": one_prof["device_launches"] / NN_ITERS,
                "run_busy_share": one_prof["device_busy_share"]}
        for t, (mem, cycles, energy) in priced.items():
            if not torch.equal(bits(mem), cpu_bits[0]):
                raise AssertionError(f"{label} on {t}: card != CPU")
            if (cycles, energy) != cpu_prices[t]:
                raise AssertionError(f"{label} on {t}: priced {cycles, energy}"
                                     f" on the card, {cpu_prices[t]} on the "
                                     "CPU")
            row[t] = {"cycles": cycles, "energy_pj": energy}
        rows[label] = row
    return {"blocks": rows, "batch": NN_BATCH}


def drive_serving_lm(stream) -> dict:
    """The ``serving_lm`` block stream (``benchmarks/torch_serving_bench``)
    through ``MVEScheduler`` on ``cuda``: per-request ``run`` in sequence,
    a warmed scheduler (``promote_after=2``, best of ``SERVE_REPLAYS``
    replays) and one profiled replay."""
    from benchmarks.torch_serving_bench import (replay_kernels,
                                                sequential_run)
    from repro_torch.core import MVEConfig
    from repro_torch.runtime.scheduler import MVEScheduler

    cfg = MVEConfig()
    restore = _no_plain_version_on_cuda()
    try:
        seq_s = sequential_run(cfg, stream, "cuda", 1)
        sched = MVEScheduler(cfg, promote_after=2, max_batch=16)
        for _ in range(2):
            replay_kernels(sched, stream)
        best = None
        for _ in range(SERVE_REPLAYS):
            wall, tickets = replay_kernels(sched, stream)
            if best is None or wall < best[0]:
                best = (wall, tickets)
        profiled = [sched.submit(r.kernel) for _, r in stream]
        prof = device_profile(sched.drain)
        sched.close()
    finally:
        restore()
    return {"sequential_s": seq_s, "steady_s": best[0], "tickets": best[1],
            "profiled": profiled, "profile": prof, "stats": sched.stats}


def check_serving_lm(stream, out, want) -> dict:
    """Every served block bit-equal to its stepwise run on the CPU
    (memory, registers, Tag) and passing its own oracle check."""
    for tickets in (out["tickets"], out["profiled"]):
        for (name, r), t, w in zip(stream, tickets, want):
            res = t.result()
            if not _host_state_equal(res, w):
                raise AssertionError(f"serving_lm {name}: != CPU stepwise")
            r.check(res.memory, res)
    st, n, prof = out["stats"], len(stream), out["profile"]
    if st.demotions:
        raise AssertionError(f"serving_lm: {st.demotions} demotions")
    return {"requests": n, "blocks": sorted({nm for nm, _ in stream}),
            "sequential_req_per_s": n / out["sequential_s"],
            "steady_req_per_s": n / out["steady_s"],
            "batch_efficiency": st.batch_efficiency,
            "promotions": st.promotions, "dispatches": st.dispatches,
            "profiled_drain": {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "device_busy_share",
                "device_launches", "host_blocking_calls")}}


# ---------------------------------------------------------------------------
# phase 5: LM serving at full width: qwen2-0.5b (`lm`), then the moe, ssm
# and hybrid families (`lm_families`)
# ---------------------------------------------------------------------------

LM_TOL = 4e-2                 # tests/test_models.py, bf16 prefill vs decode
# float32: the two orders of the same sums differ by ~1e-5 at the worst of
# 4 x 151936 logits at this width; a slip of semantics moves them by >= 1e-2
LM_FP32_TOL = 1e-3
DECODE_STEPS = 16
ENGINE_SLOTS, ENGINE_REQUESTS, ENGINE_MAX_SEQ = 4, 8, 256


# ROADMAP C12: the values tests/test_torch_float8_cache.py writes into a
# float8 cache (the reference's NaN above 464 and at +-inf, 448 at 464)
F8_EDGES = (464.0, -464.0, 464.01, -464.01, 479.9, -479.9, 480.0, -480.0,
            1e4, -1e4, float("inf"), float("-inf"), float("nan"),
            -float("nan"), 448.0, -0.0, 1e-9)


def check_float8_cache() -> dict:
    """``update_cache`` into a ``float8_e4m3fn`` cache on the card: the
    ``F8_EDGES`` of both signs and random values of scale 300 (about one
    in eight past 464), 4 x 8 kv heads x 128, k in float32 and v in bf16,
    by an int index and a ``(B,)`` index; the cache bytes must equal the
    same writes on the CPU."""
    from repro_torch.models.attention import update_cache

    edges = torch.tensor(F8_EDGES)
    gen = torch.Generator().manual_seed(12)
    vals = torch.cat([edges, -edges, 300 * torch.randn(
        4096 - 2 * len(F8_EDGES), generator=gen)]).reshape(4, 1, 8, 128)
    # rounded to bf16 once, on the CPU: the card's own rounding of a NaN
    # drops its sign, which is not update_cache's to answer for
    vals16 = vals.bfloat16()
    nan_bytes = 0
    for index in (3, torch.tensor([0, 5, 2, 7])):
        got = []
        for dev in ("cpu", "cuda"):
            k, v = (torch.zeros(4, 8, 8, 128, dtype=torch.float8_e4m3fn,
                                device=dev) for _ in range(2))
            idx = index.to(dev) if isinstance(index, torch.Tensor) else index
            update_cache(k, v, vals.to(dev), vals16.to(dev), idx)
            got.append([bits(c).cpu() for c in (k, v)])
        for what, x, cpu, card in zip("kv", (vals, vals16.float()), *got):
            if not torch.equal(cpu, card):
                rows = torch.arange(4)
                at = index if isinstance(index, torch.Tensor) else \
                    torch.full((4,), index)
                diff = (cpu != card)[rows, at].reshape(-1)
                raise AssertionError(
                    f"float8 cache {what} (index {index}): "
                    f"{int(diff.sum())} bytes differ from the CPU's, at "
                    f"inputs {x.reshape(-1)[diff][:8].tolist()}: CPU "
                    f"{cpu[rows, at].reshape(-1)[diff][:8].tolist()}, card "
                    f"{card[rows, at].reshape(-1)[diff][:8].tolist()}")
        nan_bytes = int(((got[1][0] & 0x7F) == 0x7F).sum())
    return {"values": vals.numel(), "nan_bytes": nan_bytes,
            "indices": ["int", "(B,)"], "bit_equal_to_cpu": True}


def _cast_(tree, dtype) -> dict:
    """Cast the leaves of a nested dict in place, one at a time (so one
    leaf, not the whole tree, is held twice), to ``dtype``: a torch dtype
    or a tree of them.  Returns the tree of the leaves' dtypes before."""
    before = {}
    for k, v in tree.items():
        want = dtype[k] if isinstance(dtype, dict) else dtype
        if isinstance(v, dict):
            before[k] = _cast_(v, want)
        else:
            before[k], tree[k] = v.dtype, v.to(want)
    return before


def watch_admissions(engine) -> dict:
    """Wrap ``engine``'s admission so that right after each one the
    admitted slot's recurrent rows (``ssm``, ``conv``: C9) must be all
    zero.  Keeps the count of admissions, of those to a reused slot, and
    the largest |value| a reused slot's rows held just before its
    admission (the last request's state: what the zeroing removed)."""
    admit, grid = engine._try_admit, engine.grid
    names = [n for n in ("ssm", "conv") if n in engine.cache]
    seen = {"admitted": 0, "reused": 0, "stale_max_abs": 0.0}
    used = set()

    def checked():
        if not engine._queue:
            return admit()
        before = {s: grid.payload(s) for s in range(grid.top)}
        stale = {s: max((float(engine.cache[n][:, s].abs().max())
                         for n in names), default=0.0)
                 for s in range(grid.top) if before[s] is None}
        admit()
        for s in range(grid.top):
            if grid.payload(s) is None or grid.payload(s) is before[s]:
                continue
            seen["admitted"] += 1
            if s in used:
                seen["reused"] += 1
                seen["stale_max_abs"] = max(seen["stale_max_abs"], stale[s])
            used.add(s)
            for n in names:
                left = int(torch.count_nonzero(engine.cache[n][:, s]))
                if left:
                    raise AssertionError(f"slot {s} admitted with {left} "
                                         f"nonzero {n} values (C9)")

    engine._try_admit = checked
    return seen


def check_alone(cfg, params, request, output, noise):
    """The request alone in a one-slot engine gives the same tokens as
    beside others — or the two runs part at a greedy near-tie: the batched
    run's token scores within ``noise`` (at least ``LM_TOL``) of the
    one-slot run's best logit at that step.  A batch of 4 and a batch of 1
    may round the bf16 products differently, and from there on the
    contexts differ; ``noise`` is the largest difference between two bf16
    evaluations of the same logits measured in this run."""
    from repro_torch.launch.serve import ContinuousBatchingEngine, Request

    alone = ContinuousBatchingEngine(cfg, params, 1, ENGINE_MAX_SEQ)
    rows, decode = [], alone.model.decode_step

    def recording(*args):
        logits, cache = decode(*args)
        rows.append(logits[0, :cfg.vocab_size].float())
        return logits, cache

    alone.model.decode_step = recording
    alone.submit(Request(rid=0, prompt=request.prompt,
                         max_new_tokens=request.max_new_tokens))
    solo = alone.run_until_drained()[0].output
    if solo == output:
        return "identical"
    j = next(i for i, (a, b) in enumerate(zip(solo, output)) if a != b)
    row = rows[len(request.prompt) - 1 + j]
    gap = float(row.max() - row[output[j]])
    if gap > max(LM_TOL, noise):
        raise AssertionError(
            f"request {request.rid}: token {j} is {output[j]} beside others, "
            f"{solo[j]} alone, {gap} below the best logit")
    return f"parted at token {j} on a near-tie ({gap})"


# (arch, layers run, prompt tokens): every family at its published widths;
# llama4-scout's 48 layers (107.8 B parameters, 215 GB in bf16) cut to 4 to
# fit one card; mamba2's 64 layers cut to 32 and zamba2's 54 to 24 (four
# groups of 6: four shared-attention blocks) so that the script, with the
# training phase, keeps to half its time limit; whisper's prompt inside its
# 448-token text context.  The first row is phase `lm`, the others phase
# `lm_families`.
FAMILIES = (("qwen2-0.5b", None, LM_SEQ), ("mamba2-2.7b", 32, LM_SEQ),
            ("zamba2-2.7b", 24, LM_SEQ),
            ("llama4-scout-17b-a16e", 4, LM_SEQ),
            ("llama-3.2-vision-11b", None, LM_SEQ),
            ("whisper-base", None, 384))
# a vlm's cross layers add tanh(gate) times their output, and the gate is
# declared zero: set it to this after init, or they add nothing
VLM_GATE = 0.5


def flash_launches(cfg) -> tuple:
    """Flash launches per prefill and per decode step: one per attention
    layer whose head dim the kernel takes (zamba2's 80 takes the plain
    route, as in the reference); decode self attention is plain, decode
    cross attention (one query row) the kernel."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    if cfg.resolved_head_dim not in HEAD_DIMS:
        return 0, 0
    L = cfg.num_layers
    cross = {"vlm": L // max(cfg.cross_attn_every, 1),
             "encdec": L}.get(cfg.family, 0)
    self_attn = {"ssm": 0, "hybrid": L // max(cfg.attn_every, 1),
                 "encdec": cfg.encoder_layers + L}.get(cfg.family, L)
    return self_attn + cross, cross


def drive_family(arch, layers, seq, flash_attention) -> dict:
    """One LM at full width with seeded random bf16 weights drawn on the
    card: a ``LM_BATCH`` x ``seq`` prefill (a vlm's image embeddings, an
    encdec's frames drawn at the shapes ``models/specs.py`` declares; the
    flash launches of :func:`flash_launches`), decode after a prefill
    against prefill one token longer (bf16 recorded; float32 held at
    ``LM_FP32_TOL``; an MoE with capacity for every token), a ``(B,)``
    cache index bit-equal to the scalar one, ``DECODE_STEPS`` greedy
    decode steps, and a ``ContinuousBatchingEngine`` of ``ENGINE_SLOTS``
    answering ``ENGINE_REQUESTS`` requests (slots reused; each admitted
    slot's recurrent state must be zero; the cross caches stay zero, as in
    the reference's engine), every request held against a one-slot
    engine."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch.serve import ContinuousBatchingEngine, Request
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import LM
    from repro_torch.trees import tree_leaves
    from repro_torch.models.specs import prefill_batch_specs

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if arch == FAMILIES[0][0] and (
            cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) != (
            Q_HEADS, KV_HEADS, HEAD_DIM):
        raise AssertionError(f"{arch} is not the shape timed: {cfg}")
    model = LM(cfg)
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()    # what earlier runs left
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    if "cross" in params:
        params["cross"]["gate"].fill_(VLM_GATE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # each leaf is drawn in float32 before its cast: not the serving peak
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaves = tree_leaves(params)
    if any(p.device.type != "cuda" for _, p in leaves):
        raise AssertionError(f"{arch}: parameters off the card")
    n_params = sum(p.numel() for _, p in leaves)
    del leaves
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    b, vocab = LM_BATCH, cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(1, vocab, (b, seq + 2), generator=gen,
                           device="cuda")
    # the vlm's image embeddings, the encdec's frames: bf16, as declared
    specs, _ = prefill_batch_specs(cfg, ShapeCell("smoke", seq, b,
                                                  "prefill"))
    extras = {n: torch.randn(d.shape, generator=gen, device="cuda").to(
        d.dtype) for n, d in specs.items() if d.dtype.is_floating_point}

    def batch(n, dtype=torch.bfloat16):
        """The first ``n`` tokens, with the extra inputs in ``dtype`` (the
        weights' type)."""
        pos = torch.arange(n, dtype=torch.int32, device="cuda")
        return {"tokens": tokens[:, :n], "positions": pos.expand(b, n),
                **{k: x.to(dtype) for k, x in extras.items()}}

    want_prefill, want_step = flash_launches(cfg)
    before = flash_attention.launches
    logits, cache = prefill(params, batch(seq))
    torch.cuda.synchronize()
    per_prefill = flash_attention.launches - before
    if per_prefill != want_prefill:
        raise AssertionError(f"{arch}: prefill launched flash "
                             f"{per_prefill} times, not {want_prefill}")
    want = {n: d.shape for n, d in model.cache_defs(b, seq).items()}
    got = {n: tuple(c.shape) for n, c in cache.items()}
    if (logits.shape != (b, cfg.padded_vocab) or not torch.isfinite(
            logits.float()).all() or got != want):
        raise AssertionError(f"{arch} prefill: logits {tuple(logits.shape)},"
                             f" cache {got} (declared {want})")
    t0 = time.perf_counter()
    prefill(params, batch(seq))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    def pad(c, extra):
        """A copy of the cache with ``extra`` more positions in its KV
        rows (the recurrent state and the cross caches have no sequence
        axis to grow)."""
        return {n: (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, extra))
                    if extra and n in ("k", "v", "shared_k", "shared_v")
                    else x.clone()) for n, x in c.items()}

    # decode after the prefill == prefill one token longer.  An MoE prefill
    # groups 2048 tokens and drops those past an expert's capacity, and one
    # token more regroups them; with capacity for every token
    # (capacity_factor = num_experts at top-1) none is dropped and the two
    # compute the same function.  Held at LM_FP32_TOL on float32 weights,
    # where only the semantics can differ; the bf16 difference is recorded
    # (an MoE's includes router near-ties that send a token elsewhere).
    cmp = (LM(dataclasses.replace(cfg, capacity_factor=cfg.num_experts))
           if cfg.family == "moe" else model)
    cmp_prefill, cmp_decode = make_prefill_step(cmp), make_decode_step(cmp)

    def decode_vs_prefill(p):
        dtype = p["embed"].dtype
        _, c = cmp_prefill(p, batch(seq, dtype))
        c, err = pad(c, 2), 0.0
        for t in (seq, seq + 1):
            got, c = cmp_decode(p, c, tokens[:, t:t + 1], t)
            want, _ = cmp_prefill(p, batch(t + 1, dtype))
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{arch} decode at {t}: non-finite")
            err = max(err, max_abs_err(got, want))
        return err

    bf16_err = decode_vs_prefill(params)
    peak = torch.cuda.max_memory_allocated()
    dtypes = _cast_(params, torch.float32)
    fp32_err = decode_vs_prefill(params)
    _cast_(params, dtypes)          # exact: the float32 values are bf16's
    fp32_peak = torch.cuda.max_memory_allocated()
    if fp32_err > LM_FP32_TOL:
        raise AssertionError(f"{arch}: float32 decode != prefill one token "
                             f"longer: {fp32_err} > {LM_FP32_TOL}")
    del cmp, cmp_prefill, cmp_decode
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()      # the float32 pass is over

    # a (B,) cache index with every row at one position is the scalar call
    padded = pad(cache, DECODE_STEPS + 2)
    before = flash_attention.launches
    a, _ = decode(params, pad(padded, 0), tokens[:, seq:seq + 1], seq)
    torch.cuda.synchronize()
    per_step = flash_attention.launches - before
    r, _ = decode(params, pad(padded, 0), tokens[:, seq:seq + 1],
                  torch.full((b,), seq, device="cuda"))
    if not torch.equal(bits(a), bits(r)):
        raise AssertionError(f"{arch}: (B,) cache index != scalar")
    if per_step != want_step:
        raise AssertionError(f"{arch}: a decode step launched flash "
                             f"{per_step} times, not {want_step}")
    del a, r

    tok = logits[:, :vocab].argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(DECODE_STEPS):
        step_logits, padded = decode(params, padded, tok, seq + i)
        tok = step_logits[:, :vocab].argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not torch.isfinite(step_logits.float()).all():
        raise AssertionError(f"{arch} greedy decode: non-finite logits")
    profiles = {
        "prefill": device_profile(lambda: prefill(params, batch(seq))),
        "decode_step": device_profile(lambda: decode(
            params, padded, tok, seq + DECODE_STEPS))}
    del padded, cache

    rng = np.random.default_rng(5)
    requests = [Request(rid=i, prompt=rng.integers(
        1, vocab, int(rng.integers(16, 65))).astype(np.int32),
        max_new_tokens=DECODE_STEPS) for i in range(ENGINE_REQUESTS)]
    engine = ContinuousBatchingEngine(cfg, params, ENGINE_SLOTS,
                                      ENGINE_MAX_SEQ)
    admissions = watch_admissions(engine)
    t0 = time.perf_counter()
    for req in requests:
        engine.submit(req)
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    if sorted(done) != list(range(ENGINE_REQUESTS)) or any(
            len(q.output) != DECODE_STEPS for q in done.values()):
        raise AssertionError(f"{arch}: the engine did not answer every "
                             "request")
    for name in ("cross_k", "cross_v"):
        if name in engine.cache and engine.cache[name].any():
            raise AssertionError(f"{arch}: the engine wrote its {name} "
                                 "cache (the reference's never does)")
    reused = ENGINE_REQUESTS - ENGINE_SLOTS
    if (admissions["admitted"], admissions["reused"]) != (
            ENGINE_REQUESTS, reused) or (cfg.family in ("ssm", "hybrid")
                                         and not admissions["stale_max_abs"]):
        raise AssertionError(f"{arch}: admissions {admissions}: expected "
                             f"{reused} reused slots holding a previous "
                             "request's state")
    # the near-tie allowance is the bf16 noise between two evaluations of
    # the same logits (decode vs prefill); an MoE's also holds tokens
    # routed to another expert on a bf16 near-tie of the router, a
    # different function, so there the fixed LM_TOL alone
    noise = 0.0 if cfg.family == "moe" else bf16_err
    alone = {q.rid: check_alone(cfg, params, q, done[q.rid].output, noise)
             for q in requests}
    peak, steps = max(peak, torch.cuda.max_memory_allocated()), engine.steps
    del params, engine
    # the engine and the admission check it holds refer to each other:
    # collect the cycle, or this model's weights stay on the card into the
    # next family's run
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "config": cfg.name, "family": cfg.family, "params": n_params,
        "layers": cfg.num_layers, "published_layers": get_config(
            arch).num_layers, "init_seconds": init_s, "batch": b,
        "seq": seq, "extra_inputs": {n: list(x.shape)
                                     for n, x in extras.items()},
        "flash_launches_per_prefill": per_prefill,
        "flash_launches_per_decode_step": per_step,
        "prefill_ms": prefill_s * 1e3,
        "prefill_tokens_per_s": b * seq / prefill_s,
        "decode_vs_prefill_max_abs_err_bf16": bf16_err,
        "decode_vs_prefill_max_abs_err_fp32": fp32_err,
        "tolerance_fp32": LM_FP32_TOL,
        "decode_ms_per_step": decode_s / DECODE_STEPS * 1e3,
        "decode_tokens_per_s": b * DECODE_STEPS / decode_s,
        "engine_slots": ENGINE_SLOTS, "engine_requests": len(done),
        "engine_prompt_tokens": sum(len(q.prompt) for q in requests),
        "engine_new_tokens": sum(len(q.output) for q in done.values()),
        "engine_steps": steps, "engine_seconds": engine_s,
        "admissions": admissions, "alone_vs_batched": alone,
        "profiles": profiles, "memory_allocated_at_start_bytes": at_start,
        "max_memory_allocated_bytes_init": init_peak,
        "max_memory_allocated_bytes": peak,
        "max_memory_allocated_bytes_fp32_pass": fp32_peak}


# ---------------------------------------------------------------------------
# phase 5c: training
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 1024      # qwen2-0.5b: 8 x 1024 tokens a step
TRAIN_STEPS, CKPT_EVERY = 6, 3
WHISPER_TEXT, WHISPER_STEPS = 384, 4  # whisper-base: 4 x 384 text tokens
RESUME_TOL = 5e-3                     # tests/test_train_loop.py
# float32 whisper step on the card vs on the CPU: the same function summed
# in other orders (the card's fp32 flash kernels, cuBLAS in full fp32)
TRAIN_FP32_LOSS_RTOL, TRAIN_FP32_NORM_RTOL = 1e-4, 1e-3
CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"


def _save_restore_s(model, state, meta, fmt="fp32") -> tuple:
    """Seconds to write ``state`` as a checkpoint and to read it back onto
    the card; the bytes written."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.launch.train import state_template

    where = str(CKPT_ROOT / "timed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(where, int(meta["step"]), state, meta)
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    t0 = time.perf_counter()
    back, _ = load_checkpoint(where, state_template(model, fmt))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for (k, a), (_, b) in zip(_tree_leaves(back), _tree_leaves(state)):
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"checkpoint round trip changed {k}")
    shutil.rmtree(where)
    return save_s, restore_s, nbytes


def _tree_leaves(tree):
    from repro_torch.trees import tree_leaves
    return tree_leaves(tree)


def drive_train_qwen2(flash_attention, flash_attention_bwd) -> dict:
    """qwen2-0.5b as published (bf16 parameters, fp32 moments) through
    ``train_loop`` on the card: 6 steps straight with a checkpoint every 3;
    then 3 steps in a fresh directory and a new ``train_loop`` call that
    restarts from its checkpoint to step 6, whose loss must equal the
    straight run's (bit for bit or within ``RESUME_TOL``: which is
    recorded).  Packed batches carry segment ids, so every self attention
    runs the segmented flash kernels: each forward launch segmented, two a
    backward call (remat "full" recomputes the forward), none of the plain
    route's chunks.  Then one more step profiled, and the checkpoint's save
    and restore timed."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import DataConfig, make_train_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainLoopConfig, train_loop
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig

    cfg = get_config("qwen2-0.5b")
    cell = ShapeCell("smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    from repro_torch.models.attention import chunked_attention
    before = (flash_attention.launches, flash_attention_bwd.launches,
              flash_attention.launches_segmented,
              chunked_attention.plain_chunks)

    def run(steps, where):
        t0 = time.perf_counter()
        m = train_loop(cfg, cell, TrainLoopConfig(
            steps=steps, ckpt_dir=str(CKPT_ROOT / where),
            ckpt_every=CKPT_EVERY, log_every=1), opt_cfg=opt, seed=0)
        torch.cuda.synchronize()
        return m, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    straight, straight_s = run(TRAIN_STEPS, "straight")
    loop_peak = torch.cuda.max_memory_allocated()
    first, _ = run(CKPT_EVERY, "resumed")
    resumed, resumed_s = run(TRAIN_STEPS, "resumed")
    shutil.rmtree(CKPT_ROOT / "resumed")
    diff = abs(straight["loss"] - resumed["loss"])
    for what, m in (("straight", straight), ("resumed", resumed)):
        if not (np.isfinite(m["loss"]) and m["grad_norm"] > 0
                and m["final_step"] == TRAIN_STEPS):
            raise AssertionError(f"qwen2-0.5b {what} run: {m}")
    if diff > RESUME_TOL:
        raise AssertionError(f"qwen2-0.5b resumed loss {resumed['loss']} "
                             f"!= straight {straight['loss']}")
    launched = (flash_attention.launches - before[0],
                flash_attention_bwd.launches - before[1],
                flash_attention.launches_segmented - before[2],
                chunked_attention.plain_chunks - before[3])
    fwd, bwd, segmented, plain = launched
    if not (fwd > 0 and segmented == fwd == 2 * bwd and plain == 0
            and bwd % cfg.num_layers == 0):
        raise AssertionError(f"qwen2-0.5b training: flash launches (forward,"
                             f" backward, segmented) and plain chunks "
                             f"{launched}: its packed batches carry segment "
                             f"ids, every self attention takes the "
                             f"segmented kernels")

    # the state after 6 steps, restored; one more step under the profiler
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch.train import state_template
    model = LM(cfg)
    state, meta = load_checkpoint(str(CKPT_ROOT / "straight"),
                                  state_template(model, "fp32"))
    shutil.rmtree(CKPT_ROOT / "straight")
    save_s, restore_s, nbytes = _save_restore_s(model, state, meta)
    batch = next(make_train_batches(DataConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0),
        start_doc=int(meta["next_doc"])))
    batch = {k: torch.from_numpy(x).cuda() for k, x in batch.items()
             if k != "next_doc"}
    step = make_train_step(model, opt)
    torch.cuda.reset_peak_memory_stats()
    profile = device_profile(lambda: step(state["params"], state["opt"],
                                          batch))
    step_peak = torch.cuda.max_memory_allocated()
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    step_s = straight["step_time_s"]
    return {
        "config": cfg.name, "params": cfg.param_count(),
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "ckpt_every": CKPT_EVERY, "optimizer": dataclasses.asdict(opt),
        "losses_final": {"straight": straight["loss"],
                         "resumed": resumed["loss"],
                         "after_3": first["loss"]},
        "resume": "bit-equal" if diff == 0 else f"within {diff}",
        "grad_norm": straight["grad_norm"],
        "step_ms": step_s * 1e3, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ /
        step_s, "run_seconds": {"straight_6": straight_s,
                                "resumed_3_to_6": resumed_s},
        "flash_launches": launched, "profiled_step": profile,
        "max_memory_allocated_bytes_loop": loop_peak,
        "max_memory_allocated_bytes_step": step_peak,
        "checkpoint_bytes": nbytes, "checkpoint_save_s": save_s,
        "checkpoint_restore_s": restore_s}


def flash_per_train_step(cfg) -> tuple:
    """Flash launches of one training step of an encdec model (forward,
    backward): the encoder's self attention, the decoder's self (whisper's
    decoder passes no segment ids) and cross attention, and again the
    decoder's under remat's recompute; the encoder is not checkpointed."""
    L, enc = cfg.num_layers, cfg.encoder_layers
    recompute = 2 * L if cfg.remat != "none" else 0
    return enc + 2 * L + recompute, enc + 2 * L


def drive_train_whisper(flash_attention, flash_attention_bwd) -> dict:
    """whisper-base as published (6 + 6 layers, bf16) through
    ``make_train_step`` on the card: ``WHISPER_STEPS`` steps of 4 x 384
    text tokens from the pipeline over 4 x 1500 frames drawn from the seed,
    the flash forward and backward launches of every step exact; one step
    profiled; the state's save and restore timed; then a float32 copy of
    the first step at batch 1, held against the same step on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_train_batches
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import LM
    from repro_torch.trees import tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.trees import value_and_grad

    cfg = get_config("whisper-base")
    model = LM(cfg)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=WHISPER_STEPS)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    initial = params                      # the float32 copy starts here
    opt_state = adamw_init(params)
    gen = torch.Generator(device="cuda").manual_seed(8)
    frames = torch.randn(LM_BATCH, cfg.num_frames, cfg.d_model,
                         generator=gen, device="cuda").bfloat16()
    batches = make_train_batches(DataConfig(cfg.vocab_size, WHISPER_TEXT,
                                            LM_BATCH, seed=0))
    host = [next(batches) for _ in range(WHISPER_STEPS + 1)]
    cuda_batches = [{**{k: torch.from_numpy(x).cuda() for k, x in b.items()
                        if k != "next_doc"}, "frames": frames} for b in host]
    step = steps_mod.make_train_step(model, opt)
    want = flash_per_train_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times, per_step = [], [], [], set()
    for b in cuda_batches[:WHISPER_STEPS]:
        before = (flash_attention.launches, flash_attention_bwd.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
        per_step.add((flash_attention.launches - before[0],
                      flash_attention_bwd.launches - before[1]))
    peak = torch.cuda.max_memory_allocated()
    if per_step != {want}:
        raise AssertionError(f"whisper-base: flash launches per step "
                             f"{per_step}, not {want}")
    if not all(np.isfinite(losses)) or not min(norms) > 0:
        raise AssertionError(f"whisper-base: losses {losses}, grad norms "
                             f"{norms}")
    profile = device_profile(lambda: step(params, opt_state,
                                          cuda_batches[-1]))
    save_s, restore_s, nbytes = _save_restore_s(
        model, {"params": params, "opt": opt_state},
        {"step": WHISPER_STEPS, "next_doc": int(host[-1]["next_doc"])})

    # float32 at batch 1: the card's step vs the CPU's, from the same state
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        one = {k: x[:1].float() if x.is_floating_point() else x[:1]
               for k, x in cuda_batches[0].items()}
        out = {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda x: x.to(device=dev, dtype=torch.float32),
                         initial)
            b = {k: x.to(dev) for k, x in one.items()}
            (loss, _), grads = value_and_grad(model.loss, p, b)
            _, _, m = steps_mod.make_train_step(model, opt)(
                p, adamw_init(p), b)
            out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                        dict(_tree_leaves(grads)), float(loss))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    (gl, gn, gg, _), (cl, cn, cg, _) = out["cuda"], out["cpu"]
    leaf_err = {k: float((gg[k].cpu() - cg[k]).abs().max() /
                         cg[k].abs().max().clamp_min(1e-30)) for k in cg}
    worst_leaf = max(leaf_err, key=leaf_err.get)
    loss_rel, norm_rel = abs(gl - cl) / abs(cl), abs(gn - cn) / abs(cn)
    if loss_rel > TRAIN_FP32_LOSS_RTOL or norm_rel > TRAIN_FP32_NORM_RTOL:
        raise AssertionError(f"whisper-base float32 step, card vs CPU: loss "
                             f"{gl} vs {cl}, grad norm {gn} vs {cn}")
    del params, opt_state, initial
    gc.collect()
    torch.cuda.empty_cache()
    step_s = float(np.median(times[1:]))
    return {
        "config": cfg.name, "params": cfg.param_count(), "batch": LM_BATCH,
        "text_tokens": WHISPER_TEXT, "frames": list(frames.shape),
        "steps": WHISPER_STEPS, "losses": losses, "grad_norms": norms,
        "step_ms": [t * 1e3 for t in times], "step_ms_median": step_s * 1e3,
        "tokens_per_s": LM_BATCH * WHISPER_TEXT / step_s,
        "frames_per_s": LM_BATCH * cfg.num_frames / step_s,
        "flash_launches_per_step": {"forward": want[0], "backward": want[1]},
        "profiled_step": profile, "max_memory_allocated_bytes": peak,
        "checkpoint_bytes": nbytes, "checkpoint_save_s": save_s,
        "checkpoint_restore_s": restore_s,
        "fp32_batch1_card_vs_cpu": {
            "loss": [gl, cl], "loss_rel": loss_rel,
            "grad_norm": [gn, cn], "grad_norm_rel": norm_rel,
            "tolerance": [TRAIN_FP32_LOSS_RTOL, TRAIN_FP32_NORM_RTOL],
            "worst_leaf": worst_leaf,
            "worst_leaf_rel_to_its_max": leaf_err[worst_leaf]}}


# qwen2-0.5b's flash launches a step (forward, backward) without segment
# ids, by remat option: "full" and "dots" recompute each of the 24 layers'
# attention in the backward, "none" keeps it
REMAT_FLASH = {"full": (48, 24), "dots": (48, 24), "none": (24, 24)}


def _bits_differ(a: dict, b: dict) -> list:
    """The paths of the leaves of ``a`` whose bits differ from ``b``'s."""
    return [k for k, x in _tree_leaves(a)
            if not torch.equal(bits(x), bits(b[k]))]


def _int8_against_cpu(opt, params, grads, state, norm) -> dict:
    """One AdamW update with int8 moments on the card and on the CPU from
    the same inputs; the CPU's results are compared on the card."""
    from repro_torch.optim import adamw_update
    from repro_torch.trees import tree_map

    cpu = [tree_map(lambda x: x.cpu(), t) for t in (params, grads, state)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, new, _ = adamw_update(opt, params, grads, state, grad_norm=norm)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want_p, want, _ = adamw_update(opt, *cpu, grad_norm=norm.cpu())
    cpu_s = time.perf_counter() - t0
    del cpu
    want = dict(_tree_leaves(tree_map(lambda x: x.cuda(), want)))
    q_steps, s_rel, q_differ, s_differ, rows = 0, 0.0, 0, 0, 0
    for k, x in _tree_leaves(new):
        w = want[k]
        if k.endswith("/q"):
            d = (x.int() - w.int()).abs()
            q_steps = max(q_steps, int(d.max()))
            q_differ += int((d > 0).sum())
        elif k.endswith("/s"):
            s_rel = max(s_rel, float((x - w).abs().max()
                                     / w.abs().max().clamp_min(1e-30)))
            s_differ += int((x != w).sum())
            rows += w.numel()
    return {"q_max_steps": q_steps, "q_entries_differing": q_differ,
            "q_entries": 2 * sum(x.numel() for _, x in _tree_leaves(params)),
            "s_max_rel_to_leaf_max": s_rel, "s_entries_differing": s_differ,
            "s_entries": rows, "params_leaves_differing": _bits_differ(
                p, dict(_tree_leaves(tree_map(lambda x: x.cuda(), want_p)))),
            "card_ms": card_ms, "cpu_s": cpu_s}


def drive_train_options(flash_attention, flash_attention_bwd) -> dict:
    """qwen2-0.5b as published (bf16) on one ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` batch of the pipeline without its segment ids (so self
    attention takes the flash route): the loss and every gradient leaf
    under ``remat`` "full" (twice: the step is deterministic), "dots" and
    "none", each bit-equal to the first "full" run, and each option's
    flash launches a step against ``REMAT_FLASH`` (a second call of each
    timed).  Then AdamW with int8 moments from those gradients: one update
    on the card from zero moments, and the next from its state on the card
    and on the CPU from the same inputs (parameters, state, gradients and
    their norm): ``q`` and ``s`` bit-equal (both devices multiply by
    float32(1/127), as the reference's compiled step does)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_train_batches
    from repro_torch.models import LM
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   global_norm)
    from repro_torch.trees import value_and_grad

    cfg = get_config("qwen2-0.5b")
    params = LM(cfg).init_params(
        torch.Generator(device="cuda").manual_seed(0))
    host = next(make_train_batches(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                              TRAIN_BATCH, seed=0)))
    batch = {k: torch.from_numpy(x).cuda() for k, x in host.items()
             if k not in ("next_doc", "segment_ids")}
    remat, full = {}, None
    for name, option in (("full", "full"), ("full again", "full"),
                         ("dots", "dots"), ("none", "none")):
        model = LM(dataclasses.replace(cfg, remat=option))
        before = (flash_attention.launches, flash_attention_bwd.launches)
        (loss, _), grads = value_and_grad(model.loss, params, batch)
        launches = (flash_attention.launches - before[0],
                    flash_attention_bwd.launches - before[1])
        if full is None:
            full = (loss, grads, dict(_tree_leaves(grads)))
        differ = _bits_differ(grads, full[2])
        loss_equal = bool(torch.equal(bits(loss), bits(full[0])))
        del grads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        value_and_grad(model.loss, params, batch)
        torch.cuda.synchronize()
        remat[name] = {"flash_launches": launches,
                       "predicted": REMAT_FLASH[option], "loss":
                       float(loss), "loss_bit_equal": loss_equal,
                       "leaves_differing": differ,
                       "step_ms": (time.perf_counter() - t0) * 1e3,
                       "max_memory_allocated":
                       torch.cuda.max_memory_allocated()}
    for name, r in remat.items():
        if tuple(r["flash_launches"]) != r["predicted"]:
            raise AssertionError(f"qwen2-0.5b remat {name}: flash launches "
                                 f"{r['flash_launches']}, not "
                                 f"{r['predicted']}")
        if not r["loss_bit_equal"] or r["leaves_differing"]:
            raise AssertionError(f"qwen2-0.5b remat {name} differs from "
                                 f"\"full\": {r}")

    grads = full[1]
    del full
    norm = global_norm(grads)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS,
                      state_format="int8")
    p, state, _ = adamw_update(opt, params, grads, adamw_init(params, "int8"),
                               grad_norm=norm)
    int8 = _int8_against_cpu(opt, p, grads, state, norm)
    del params, p, state, grads
    gc.collect()
    torch.cuda.empty_cache()
    if int8["q_entries_differing"] or int8["s_entries_differing"]:
        raise AssertionError(f"qwen2-0.5b int8 moments, card vs CPU: {int8}")
    return {"config": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "segment_ids": False, "remat": remat, "int8_update_2": int8,
            "int8_tolerance": "q and s bit-equal"}


# ---------------------------------------------------------------------------
# phase 5d: the mesh (its data and model axes at one rank)
# ---------------------------------------------------------------------------

MESH_STEPS = 3                         # whisper-base through jitted_cell
DP_STEPS = 2                           # make_dp_train_step, each way
PIPE_MICRO, PIPE_ROWS, PIPE_DIM = 4, 8, 1024
# tests/test_sharding.py's pipeline check: forward, gradient
PIPE_TOL, PIPE_GRAD_RTOL = 1e-5, 1e-4
MESH_ENTRY_ARGS = ["--arch", "qwen2-0.5b", "--batch", "8", "--seq", "128",
                   "--data", "1", "--ckpt-every", "2"]


def _leaves_equal(a, b) -> list:
    """Paths of the leaves of two trees (DTensors gathered) whose bits
    differ."""
    from repro_torch.parallel.axes import gather
    b = dict(_tree_leaves(b))
    return [k for k, x in _tree_leaves(a)
            if not torch.equal(bits(gather(x)), bits(gather(b[k])))]


def drive_mesh_whisper(mesh, flash_attention, flash_attention_bwd) -> dict:
    """whisper-base as published, the ``train`` phase's cell (4 x 384 text
    tokens over 4 x 1500 frames, bf16 weights, fp32 moments): ``MESH_STEPS``
    steps through ``jitted_cell`` on the mesh beside ``make_train_step``
    from the same state; every parameter, both moments and the loss bit for
    bit, the flash launches of each mesh step exact; one mesh step
    profiled (the ``train`` phase profiles ``make_train_step``'s)."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import DataConfig, make_train_batches
    from repro_torch.launch.steps import (jitted_cell, make_train_step,
                                          state_shardings)
    from repro_torch.models import LM
    from repro_torch.trees import tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.axes import place, sharding_context

    cfg = get_config("whisper-base")
    model = LM(cfg)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=MESH_STEPS)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(8)
    frames = torch.randn(LM_BATCH, cfg.num_frames, cfg.d_model,
                         generator=gen, device="cuda").bfloat16()
    batches = make_train_batches(DataConfig(cfg.vocab_size, WHISPER_TEXT,
                                            LM_BATCH, seed=0))
    batches = [{**{k: torch.from_numpy(x).cuda() for k, x in b.items()
                   if k != "next_doc"}, "frames": frames}
               for b in (next(batches) for _ in range(MESH_STEPS))]
    with sharding_context(mesh) as ctx:
        step, _ = jitted_cell(cfg, ShapeCell("mesh", WHISPER_TEXT, LM_BATCH,
                                             "train"), ctx, opt_cfg=opt)
        shard = state_shardings(model, opt, ctx)
    plain = make_train_step(model, opt)
    p1, s1 = params, adamw_init(params)
    p2 = tree_map(place, params, shard["params"])
    s2 = tree_map(place, adamw_init(params), shard["opt"])
    want = flash_per_train_step(cfg)
    per_step, times, losses = set(), [], []
    for b in batches:
        p1, s1, m1 = plain(p1, s1, b)
        before = (flash_attention.launches, flash_attention_bwd.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p2, s2, m2 = step(p2, s2, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.add((flash_attention.launches - before[0],
                      flash_attention_bwd.launches - before[1]))
        losses.append((float(m1["loss"]), float(m2["loss"])))
        if not torch.equal(bits(m1["loss"]), bits(m2["loss"])):
            raise AssertionError(f"whisper-base on the mesh: loss "
                                 f"{losses[-1]} differs from one device's")
    differ = {"params": _leaves_equal(p1, p2),
              "m": _leaves_equal(s1["m"], s2["m"]),
              "v": _leaves_equal(s1["v"], s2["v"])}
    if any(differ.values()):
        raise AssertionError(f"whisper-base through jitted_cell differs from "
                             f"make_train_step in {differ}")
    if per_step != {want}:
        raise AssertionError(f"whisper-base on the mesh: flash launches per "
                             f"step {per_step}, not {want}")
    profile = device_profile(lambda: step(p2, s2, batches[-1]))
    del p1, s1, p2, s2, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": cfg.name, "batch": LM_BATCH,
            "text_tokens": WHISPER_TEXT, "frames": list(frames.shape),
            "steps": MESH_STEPS, "losses_plain_mesh": losses,
            "equal": "bit for bit: every parameter, m, v and the loss",
            "flash_launches_per_step": {"forward": want[0],
                                        "backward": want[1]},
            "mesh_step_ms": [t * 1e3 for t in times],
            "profiled_step": profile}


# (arch, layers, decode steps) through jitted_cell's prefill and decode
# cells: qwen2-0.5b as published with DECODE_STEPS steps, each other family
# at its published widths with the fewest layers that hold every kind of
# its layers (2; llama4 4, as in `lm_families`; zamba2 6: one group of
# Mamba2 layers with its shared attention block; the vision model 5: one
# gated cross layer), 2 steps
MODEL_AXIS = (("qwen2-0.5b", None, DECODE_STEPS), ("mamba2-2.7b", 2, 2),
              ("zamba2-2.7b", 6, 2), ("llama4-scout-17b-a16e", 4, 2),
              ("llama-3.2-vision-11b", 5, 2), ("whisper-base", 2, 2))
# where a DTensor op computes otherwise than the plain one (named in
# PERF.md), its family's logits and cache are held to this
MODEL_AXIS_RTOL = 1e-6


def _rel_err(a, b) -> float:
    """The largest difference over the largest entry (0 for equal bits)."""
    if torch.equal(bits(a), bits(b)):
        return 0.0
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def drive_mesh_model_axis(mesh, arch, layers, steps, flash_attention
                          ) -> dict:
    """One family at its published widths through ``jitted_cell``'s
    ``prefill`` and ``decode`` cells on the mesh, whose ``model`` axis of
    one rank carries every ``constrain`` site as a ``DTensor``
    redistribution and the flash route on the rank's own heads: a
    ``LM_BATCH`` x 1024 prefill (whisper 384 tokens) and ``steps`` decode
    steps, beside ``LM.prefill`` / ``LM.decode_step`` called directly on
    the same inputs.  Logits and every cache leaf bit for bit (qwen2), or
    within ``MODEL_AXIS_RTOL`` where a DTensor op rounds otherwise (the
    worst relative error printed); the flash launches of each prefill
    and decode step those of :func:`flash_launches` on both paths; one
    more decode step profiled on each path (host wall ms, device busy ms,
    launches): the difference is what the ``DTensor`` path costs the
    host."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch.steps import jitted_cell
    from repro_torch.models import LM
    from repro_torch.models.specs import prefill_batch_specs
    from repro_torch.parallel.axes import gather, sharding_context

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    seq = 384 if cfg.family == "encdec" else LM_SEQ
    model, b = LM(cfg), LM_BATCH
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    if "cross" in params:
        params["cross"]["gate"].fill_(VLM_GATE)
    gen = torch.Generator(device="cuda").manual_seed(4)
    tokens = torch.randint(1, cfg.vocab_size, (b, seq + steps + 1),
                           generator=gen, device="cuda")
    specs, _ = prefill_batch_specs(cfg, ShapeCell("p", seq, b, "prefill"))
    batch = {"tokens": tokens[:, :seq],
             "positions": torch.arange(seq, dtype=torch.int32,
                                       device="cuda").expand(b, seq),
             **{n: torch.randn(d.shape, generator=gen, device="cuda").to(
                 d.dtype) for n, d in specs.items()
                if d.dtype.is_floating_point}}
    room = seq + steps + 1
    with sharding_context(mesh) as ctx:
        prefill, _ = jitted_cell(cfg, ShapeCell("p", seq, b, "prefill"), ctx)
        decode, _ = jitted_cell(cfg, ShapeCell("d", room, b, "decode"), ctx)
    want_prefill, want_step = flash_launches(cfg)
    errs, launches = {}, {"direct": [], "mesh": []}

    def run(name, fn, *args):
        before = flash_attention.launches
        out = fn(*args)
        torch.cuda.synchronize()
        launches[name].append(flash_attention.launches - before)
        return out

    def hold(what, got, want):
        errs[what] = max(errs.get(what, 0.0), _rel_err(gather(got), want))

    def pad(c):
        return {n: (torch.nn.functional.pad(gather(x), (0, 0, 0, 0, 0,
                                                        steps + 1))
                    if n in ("k", "v", "shared_k", "shared_v")
                    else gather(x).clone()) for n, x in c.items()}

    logits, cache = run("direct", model.prefill, params, batch)
    m_logits, m_cache = run("mesh", prefill, params, batch)
    hold("prefill_logits", m_logits, logits)
    for n, x in cache.items():
        hold("prefill_cache", m_cache[n], x)
    cache, m_cache = pad(cache), pad(m_cache)
    for t in range(seq, seq + steps):
        tok = tokens[:, t:t + 1]
        logits, cache = run("direct", model.decode_step, params, cache, tok,
                            t)
        m_logits, m_cache = run("mesh", decode, params, m_cache, tok,
                                torch.tensor(t))
        hold("decode_logits", m_logits, logits)
        for n, x in cache.items():
            hold("decode_cache", m_cache[n], x)
    tok, t = tokens[:, seq + steps:], seq + steps
    profile = {"direct": device_profile(
        lambda: model.decode_step(params, cache, tok, t)),
        "mesh": device_profile(
        lambda: decode(params, m_cache, tok, torch.tensor(t)))}
    for name in ("direct", "mesh"):
        got = launches[name]
        if got[0] != want_prefill or set(got[1:]) != {want_step}:
            raise AssertionError(f"{arch} {name}: flash launches {got}, not "
                                 f"{want_prefill} then {want_step} a step")
    worst = max(errs.values())
    tol = 0.0 if arch == MODEL_AXIS[0][0] else MODEL_AXIS_RTOL
    if worst > tol:
        raise AssertionError(f"{arch} through jitted_cell's model path: "
                             f"relative errors {errs} > {tol}")
    del params, cache, m_cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "batch": b, "prompt": seq,
            "decode_steps": steps, "bit_equal": worst == 0.0,
            "rel_err": errs,
            "flash_launches": {"prefill": want_prefill,
                               "decode_step": want_step},
            "decode_step_profile": profile,
            "dtensor_host_ms_per_decode_step": (
                profile["mesh"]["wall_ms"] - profile["direct"]["wall_ms"])}


def qwen2_gradients():
    """qwen2-0.5b as published, random bf16 weights from seed 0, and the
    gradient of its loss on the ``train`` phase's first 8 x 1024 batch
    (``make_train_step``'s backward): (model, params, batch, gradients)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_train_batches
    from repro_torch.models import LM
    from repro_torch.trees import value_and_grad

    cfg = get_config("qwen2-0.5b")
    model = LM(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    batches = make_train_batches(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                            TRAIN_BATCH, seed=0))
    batches = [{k: torch.from_numpy(x).cuda() for k, x in b.items()
                if k != "next_doc"}
               for b in (next(batches) for _ in range(DP_STEPS))]
    _, grads = value_and_grad(model.loss, params, batches[0])
    return model, params, batches, grads


def drive_mesh_compression(grads, cpu_group) -> tuple:
    """``compressed_allreduce_mean`` of every leaf of qwen2-0.5b's gradient
    (as float32), then ``compress_with_feedback`` from a zero residual, on
    the card over NCCL; the pass profiled (device ms, launches) beside
    ``dist.all_reduce`` of the same float32 tree (device time behind a
    sleep, timed only).  Each leaf's int8 payload, scale, mean, new
    gradient and new residual are copied to the host, where a thread
    started here runs the same functions over gloo (``cpu_group``) on the
    same gradients and holds them equal bit for bit, beside the checks
    that follow.  Returns (the record, the card's residual on the host,
    the thread's join function, which raises on a difference)."""
    import threading
    import traceback
    import torch.distributed as dist
    from repro_torch.trees import tree_map
    from repro_torch.parallel.compression import (compress_with_feedback,
                                                  compressed_allreduce_mean,
                                                  int8_payload,
                                                  zeros_like_residual)

    g32 = tree_map(lambda g: g.float(), grads)
    n = sum(x.numel() for _, x in _tree_leaves(g32))

    def sync():
        means = tree_map(compressed_allreduce_mean, g32)
        return compress_with_feedback(means, zeros_like_residual(means))

    def all_reduce():
        for _, x in _tree_leaves(g32):
            dist.all_reduce(x)          # one rank: the values stay

    sync()
    profile = device_profile(sync)
    ar_ms = device_ms(all_reduce, 3)

    def one(g, group):
        q, scale = int8_payload(g, group)
        mean = compressed_allreduce_mean(g, group)
        new_g, new_r = compress_with_feedback(
            {"g": mean}, {"g": torch.zeros_like(mean)})
        return q, scale, mean, new_g["g"], new_r["g"]

    card = {path: [x.cpu() for x in (g,) + one(g, None)]
            for path, g in _tree_leaves(g32)}
    del g32
    errors, seconds = [], []

    def check_on_cpu():
        t0 = time.perf_counter()
        try:
            for path, (g, *want) in card.items():
                for name, a, b in zip(("payload", "scale", "mean", "grad",
                                       "residual"), want, one(g, cpu_group)):
                    if not torch.equal(bits(a), bits(b)):
                        errors.append(f"{path}: the card's {name} differs "
                                      "from the CPU's")
        except Exception:               # reported by join, in the caller
            errors.append(traceback.format_exc())
        seconds.append(time.perf_counter() - t0)

    thread = threading.Thread(target=check_on_cpu, daemon=True)
    thread.start()

    def join() -> float:
        thread.join()
        if errors:
            raise AssertionError(f"compressed sync, card vs CPU: {errors}")
        return seconds[0]

    bytes_sync = 16 * n        # g and residual in, grad and residual out
    record = {"config": "qwen2-0.5b", "values": n,
              "equal_to_cpu": "bit for bit: payload, scale, mean, gradient, "
                              "residual of every leaf",
              "sync": {**profile, "bytes": bytes_sync,
                       "bound_ms": bytes_sync / HBM_BYTES_PER_S * 1e3,
                       "bound_by": "bytes"},
              "all_reduce_fp32": {"device_ms": ar_ms, "bytes": 8 * n,
                                  "bound_ms": 8 * n / HBM_BYTES_PER_S * 1e3}}
    return record, {k: v[-1] for k, v in card.items()}, join


def drive_mesh_dp(mesh, model, params, batches, residual) -> dict:
    """``make_dp_train_step`` on qwen2-0.5b's ``LM.loss``, ``DP_STEPS`` steps
    with ``compress=False`` (every parameter, both moments and the loss
    equal to ``make_train_step``'s bit for bit) and with ``compress=True``
    (finite loss; the residual after the first step equal to the
    compressed sync's on the same gradient)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.parallel.compression import (make_dp_train_step,
                                                  zeros_like_residual)

    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=DP_STEPS)

    def loss_fn(p, b):
        return model.loss(p, b)[0]

    def update(p, g, s):
        return adamw_update(opt, p, g, s)[:2]

    plain = make_train_step(model, opt)
    p, s = params, adamw_init(params)
    for b in batches:
        p, s, m = plain(p, s, b)
    out = {}
    for compress in (False, True):
        step = make_dp_train_step(loss_fn, update, mesh, compress=compress)
        q, st, r = params, adamw_init(params), zeros_like_residual(params)
        losses, t0 = [], time.perf_counter()
        for i, b in enumerate(batches):
            q, st, r, loss = step(q, st, r, b)
            losses.append(float(loss))
            if compress and i == 0:
                differ = [k for k, x in _tree_leaves(r) if not torch.equal(
                    bits(x.cpu()), bits(residual[k]))]
                if differ:
                    raise AssertionError(f"make_dp_train_step's residual "
                                         f"differs from the sync's in "
                                         f"{differ}")
        seconds = time.perf_counter() - t0
        if compress:
            if not all(np.isfinite(losses)):
                raise AssertionError(f"compressed DP losses {losses}")
        else:
            differ = {"params": _leaves_equal(p, q),
                      "m": _leaves_equal(s["m"], st["m"]),
                      "v": _leaves_equal(s["v"], st["v"])}
            if any(differ.values()) or losses[-1] != float(m["loss"]):
                raise AssertionError(f"make_dp_train_step(compress=False) "
                                     f"differs from make_train_step: "
                                     f"{differ}, {losses} vs {m['loss']}")
        out[f"compress={compress}"] = {"losses": losses,
                                       "seconds": seconds}
        del q, st, r
    del p, s
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": "qwen2-0.5b", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": DP_STEPS, **out,
            "compress=False": {**out["compress=False"],
                               "equal": "bit for bit to make_train_step"}}


def drive_mesh_pipeline() -> dict:
    """``pipeline_apply`` with one stage on the card (the reference test's
    ``tanh(h @ w)`` stage at D = ``PIPE_DIM``) against the sequential
    composition: output, loss and the weight's gradient."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply

    gen = torch.Generator(device="cuda").manual_seed(5)
    w = torch.randn(1, PIPE_DIM, PIPE_DIM, generator=gen,
                    device="cuda") * PIPE_DIM ** -0.5
    x = torch.randn(PIPE_MICRO, PIPE_ROWS, PIPE_DIM, generator=gen,
                    device="cuda")
    apply = pipeline_apply(lambda ws, h: torch.tanh(h @ ws["w"]),
                           make_mesh({"stage": 1}), 1)
    ws = w[0].clone().requires_grad_(True)
    y = apply({"w": ws}, x)
    loss = torch.mean(y ** 2)
    loss.backward()
    wq = w.clone().requires_grad_(True)
    h = torch.tanh(x.reshape(-1, PIPE_DIM) @ wq[0])
    want = torch.mean(h ** 2)
    want.backward()
    y_err = float((y - h.reshape(y.shape)).detach().abs().max())
    torch.testing.assert_close(y, h.reshape(y.shape), rtol=PIPE_TOL,
                               atol=PIPE_TOL)
    torch.testing.assert_close(ws.grad, wq.grad[0], rtol=PIPE_GRAD_RTOL,
                               atol=PIPE_TOL)
    if abs(float(loss.detach()) - float(want.detach())) > 1e-6:
        raise AssertionError(f"pipeline loss {float(loss.detach())} vs "
                             f"{float(want.detach())}")
    return {"stages": 1, "micro": PIPE_MICRO, "rows": PIPE_ROWS,
            "dim": PIPE_DIM, "max_abs_err": y_err,
            "grad_max_abs_err": float((ws.grad - wq.grad[0]).abs().max())}


def drive_mesh_entry_point() -> dict:
    """``launch/train.main`` for qwen2-0.5b as published
    (``MESH_ENTRY_ARGS``) as a torchrun rank of a 1-rank job, through the
    mesh path: 4 steps straight; 2 steps, then a resumed run to 4.  The
    resumed run's final checkpoint equals the straight run's bit for
    bit."""
    from repro_torch.launch import train as train_mod

    meshes, loop = [], train_mod.train_loop

    def spy(*args, **kw):
        meshes.append(kw.get("mesh"))
        return loop(*args, **kw)

    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    train_mod.train_loop = spy
    root = CKPT_ROOT / "mesh"
    t0 = time.perf_counter()
    try:
        for steps, where in ((4, "straight"), (2, "resumed"),
                             (4, "resumed")):
            train_mod.main(MESH_ENTRY_ARGS + ["--steps", str(steps),
                                              "--ckpt-dir",
                                              str(root / where)])
    finally:
        train_mod.train_loop = loop
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t0
    if len(meshes) != 3 or any(m is None for m in meshes):
        raise AssertionError(f"train.main under WORLD_SIZE=1 took the "
                             f"meshes {meshes}")
    a, b = (root / w / "step_00000004" for w in ("straight", "resumed"))
    manifest = json.loads((a / "manifest.json").read_text())
    if json.loads((b / "manifest.json").read_text()) != manifest:
        raise AssertionError("resumed checkpoint's manifest differs")
    differ = [e["key"] for e in manifest["leaves"]
              if not np.array_equal(np.load(a / e["file"], mmap_mode="r"),
                                    np.load(b / e["file"], mmap_mode="r"))]
    shutil.rmtree(root)
    if differ:
        raise AssertionError(f"resumed run differs from the straight one in "
                             f"{differ}")
    return {"args": MESH_ENTRY_ARGS, "runs": ["4 straight", "2", "2 -> 4"],
            "resumed_equal": "bit for bit (every leaf of step 4)",
            "mesh": str(meshes[0]), "seconds": seconds}


def drive_mesh(flash_attention, flash_attention_bwd) -> dict:
    """Phase 5d: a 1-rank process group (NCCL for the card, gloo for the
    CPU side of the compressed sync, which runs on a thread beside the
    later checks) from a ``FileStore`` in a temporary directory, a
    ``{"data": 1, "model": 1}`` mesh on ``cuda``, the six checks, the
    group destroyed at the end."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    out = {}
    torch.cuda.set_device(0)            # the rank's card, before the mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "cpu:gloo,cuda:nccl", rank=0, world_size=1,
            store=dist.FileStore(str(Path(tmp) / "store"), 1))
        try:
            mesh = make_mesh({"data": 1, "model": 1})
            if mesh.device_type != "cuda":
                raise AssertionError(f"mesh on {mesh.device_type}")
            seconds, t = {}, time.perf_counter()

            def lap(name):
                nonlocal t
                seconds[name] = time.perf_counter() - t
                t = time.perf_counter()

            out["whisper-base"] = drive_mesh_whisper(
                mesh, flash_attention, flash_attention_bwd)
            lap("whisper-base")
            out["model_axis"] = {
                arch: drive_mesh_model_axis(mesh, arch, layers, steps,
                                            flash_attention)
                for arch, layers, steps in MODEL_AXIS}
            lap("model_axis")
            model, params, batches, grads = qwen2_gradients()
            lap("qwen2_gradients")
            out["compressed_sync"], residual, join = drive_mesh_compression(
                grads, dist.new_group(backend="gloo"))
            del grads
            lap("compressed_sync")
            out["make_dp_train_step"] = drive_mesh_dp(
                mesh, model, params, batches, residual)
            del params, batches, residual
            gc.collect()
            torch.cuda.empty_cache()
            lap("make_dp_train_step")
            out["pipeline"] = drive_mesh_pipeline()
            lap("pipeline")
            out["entry_point"] = drive_mesh_entry_point()
            lap("entry_point")
            out["compressed_sync"]["cpu_check_seconds"] = join()
            lap("compressed_sync_cpu_wait")
            out["check_seconds"] = seconds
        finally:
            dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# phase 5e: the dry run's counts against the card's
# ---------------------------------------------------------------------------

# (arch, cell) counted on the card and on ``meta``: whisper-base's train
# cell (the ``mesh`` phase's: flash forward and backward) and qwen2-0.5b's
# prefill (the ``lm`` phase's: flash forward)
DRYRUN_CELLS = (("whisper-base", ("dryrun", WHISPER_TEXT, LM_BATCH, "train")),
                ("qwen2-0.5b", ("dryrun", LM_SEQ, LM_BATCH, "prefill")))
# the production-mesh proof: qwen2-0.5b's train_4k on 256 ranks with the
# roofline analysis, then on 512 without (host work: the whole model runs
# on meta tensors; qwen2-72b's would take minutes); llama4-scout's
# decode_32k on 256, whose one MoE group of 128 tokens spans the 16 data
# ranks (8 tokens a rank)
DRYRUN_PROOFS = (["--arch", "qwen2-0.5b", "--shape", "train_4k", "--force"],
                 ["--arch", "qwen2-0.5b", "--shape", "train_4k", "--force",
                  "--multi-pod", "--no-analysis"],
                 ["--arch", "llama4-scout-17b-a16e", "--shape", "decode_32k",
                  "--force"])
# what the gather of that group adds to one layer's collective bytes,
# against its prediction (the script exits 1 where they differ)
MOE_SPAN_BYTES = ["--arch", "llama4-scout-17b-a16e"]
# benchmarks/torch_model_axis_cells.py's meshes, one subprocess each
CELL_MESHES = ("2x4", "1x4")
DRYRUN_TIMEOUT = 240                 # s, each subprocess (run side by side)
_META_COUNTS = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.axes import sharding_context

dryrun.fake_group(1)
mesh = make_mesh({"data": 1, "model": 1})
out = {}
for arch, cell in json.loads(sys.argv[1]):
    with sharding_context(mesh) as ctx:
        out[arch] = dryrun.count_cell(get_config(arch), ShapeCell(*cell), ctx)
print(json.dumps(out))
"""


def _dryrun_batch(specs, vocab: int, gen) -> dict:
    """A batch of ``specs`` on the card: random tokens and targets, one
    document, every position counted, frames and image embeddings drawn
    from ``gen``."""
    out = {}
    for name, d in specs.items():
        if d.dtype.is_floating_point and name != "loss_mask":
            x = torch.randn(d.shape, generator=gen, device="cuda")
        elif name in ("tokens", "targets"):
            x = torch.randint(1, vocab, d.shape, generator=gen,
                              device="cuda")
        elif name == "positions":
            x = torch.arange(d.shape[1], device="cuda").expand(d.shape)
        else:                                  # loss_mask, segment_ids
            x = torch.ones(d.shape, device="cuda")
        out[name] = x.to(d.dtype).contiguous()
    return out


def _start(args, cwd) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc: subprocess.Popen, what: str) -> str:
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what}: no result in {DRYRUN_TIMEOUT} s")
    if proc.returncode:
        raise AssertionError(f"{what} failed: {out[-3000:]} {err[-3000:]}")
    return out


def drive_dryrun_card(cells, flash_attention, flash_attention_bwd) -> dict:
    """Each of ``cells`` once through ``jitted_cell`` on a ``(data 1,
    model 1)`` NCCL mesh of one rank, random bf16 weights from a seeded
    generator, under the dry run's cost counter; the flash launches of
    the counted step; the peak of device memory around it; a second call
    profiled for the device's busy time."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import local_tensors
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.models.specs import (prefill_batch_specs,
                                          train_batch_specs)
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.axes import sharding_context

    out = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "cpu:gloo,cuda:nccl", rank=0, world_size=1,
            store=dist.FileStore(str(Path(tmp) / "store"), 1))
        try:
            mesh = make_mesh({"data": 1, "model": 1})
            for arch, spec in cells:
                cfg, cell = get_config(arch), ShapeCell(*spec)
                params = LM(cfg).init_params(
                    torch.Generator(device="cuda").manual_seed(0))
                gen = torch.Generator(device="cuda").manual_seed(9)
                if cell.kind == "train":
                    specs, _ = train_batch_specs(cfg, cell)
                    args = (params, adamw_init(params),
                            _dryrun_batch(specs, cfg.vocab_size, gen))
                else:
                    specs, _ = prefill_batch_specs(cfg, cell)
                    args = (params, _dryrun_batch(specs, cfg.vocab_size,
                                                  gen))
                with sharding_context(mesh) as ctx:
                    step, args = dryrun.prepare_cell(cfg, cell, ctx,
                                                     args=args)
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    before = (flash_attention.launches,
                              flash_attention_bwd.launches)
                    counts = dryrun.count_step(step, args)
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated()
                    launches = (flash_attention.launches - before[0],
                                flash_attention_bwd.launches - before[1])
                    result = step(*args)
                    finite = all(bool(torch.isfinite(x).all())
                                 for x in local_tensors(result)
                                 if x.is_floating_point())
                    profile = device_profile(lambda: step(*args))
                out[arch] = {"cell": list(spec), "counts": counts,
                             "flash_launches": launches, "finite": finite,
                             "memory_before_step": base,
                             "max_memory_allocated": peak,
                             "profiled_step": profile}
                del params, args, step, result
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return out


def check_dryrun(card, meta, proofs) -> dict:
    """Phase 5e's gates: the card's flops equal the ``meta`` count's and
    neither is 0; the flash launches of the counted step are the ``mesh``
    and ``lm`` phases' (whisper 30 / 18 a train step, qwen2 24 a
    prefill); every result finite; each production-mesh record ``ok``,
    its flops, bytes and collective bytes and its peak above 0.  Prints,
    ungated, the predicted peak beside the card's, the roofline bound
    beside the busy time, the measured share of the bf16 peak and the
    bytes counted on the card over those counted on ``meta``."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import hlo_analysis

    out = {}
    for arch, spec in DRYRUN_CELLS:
        cfg, cell = get_config(arch), ShapeCell(*spec)
        got, want = card[arch]["counts"], meta[arch]
        if got["flops"] != want["flops"] or got["flops"] <= 0:
            raise AssertionError(f"{arch} {cell.kind}: the card counted "
                                 f"{got['flops']} flops, meta "
                                 f"{want['flops']}")
        launches = card[arch]["flash_launches"]
        rule = (flash_per_train_step(cfg) if cell.kind == "train"
                else (flash_launches(cfg)[0], 0))
        if tuple(launches) != tuple(rule):
            raise AssertionError(f"{arch} {cell.kind}: flash launches "
                                 f"{launches}, not {rule}")
        if not card[arch]["finite"]:
            raise AssertionError(f"{arch} {cell.kind}: non-finite results")
        rl = hlo_analysis.Roofline(
            flops_per_device=want["flops"], bytes_per_device=want["bytes"],
            collective_bytes_per_device=want["collectives"]["total"],
            chips=1, model_flops_total=hlo_analysis.model_flops(cfg, cell))
        busy_s = card[arch]["profiled_step"]["device_busy_ms"] / 1e3
        mem = want["memory"]
        out[arch] = {
            "cell": spec, "flops": want["flops"], "flops_equal": True,
            "flash_launches": launches,
            "bytes_card_over_meta": got["bytes"] / want["bytes"],
            "collectives_card": got["collectives"],
            "collectives_meta": want["collectives"],
            "peak_predicted_bytes": mem["argument_bytes"] +
            want["peak_bytes"],
            "step_peak_predicted_bytes": want["peak_bytes"],
            "max_memory_allocated": card[arch]["max_memory_allocated"],
            "step_peak_measured_bytes": card[arch]["max_memory_allocated"]
            - card[arch]["memory_before_step"],
            "memory_meta": mem, "memory_card": got["memory"],
            "bound_s": rl.bound_s, "dominant": rl.dominant,
            "busy_s": busy_s, "busy_over_bound": busy_s / rl.bound_s,
            "model_flops": rl.model_flops_total,
            "bf16_peak_share": rl.model_flops_total / (
                busy_s * hlo_analysis.PEAK_FLOPS),
            "profiled_step": card[arch]["profiled_step"]}
    for name, rec in proofs.items():
        raw = rec.get("cost_raw", {})
        if rec.get("status") != "ok" or not (
                raw.get("flops", 0) > 0 and raw.get("bytes", 0) > 0
                and raw.get("collectives", {}).get("total", 0) > 0
                and rec["memory"]["peak_bytes_per_device"] > 0):
            raise AssertionError(f"dry run {name}: {json.dumps(rec)[:3000]}")
        out[name] = {k: rec[k] for k in (
            "status", "chips", "compile_s", "memory", "cost_raw",
            "collectives", "roofline", "total_s") if k in rec}
    return out


def drive_dryrun(flash_attention, flash_attention_bwd) -> dict:
    """Phase 5e: the ``meta`` counts of ``DRYRUN_CELLS`` (a ``fake`` group
    of one rank), the model-axis cells, the MoE gather's bytes
    (``MOE_SPAN_BYTES``) and the production-mesh runs of ``DRYRUN_PROOFS``
    (``python -m repro_torch.launch.dryrun``, 256 and 512 ``fake`` ranks)
    start in subprocesses that see no card; meanwhile the same cells run on
    the card under the counter; then :func:`check_dryrun`."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cells_py = str(ROOT / "benchmarks" / "torch_model_axis_cells.py")
        procs = [_start(["-c", _META_COUNTS, json.dumps(DRYRUN_CELLS)], tmp),
                 _start([str(ROOT / "benchmarks" / "torch_moe_span_bytes.py"),
                         *MOE_SPAN_BYTES], tmp)]
        procs += [_start([cells_py, "--mesh", m], tmp) for m in CELL_MESHES]
        procs += [_start(["-m", "repro_torch.launch.dryrun", *args], tmp)
                  for args in DRYRUN_PROOFS]
        try:
            card = drive_dryrun_card(DRYRUN_CELLS, flash_attention,
                                     flash_attention_bwd)
            card_s = time.perf_counter() - t0
            meta = json.loads(_finish(procs[0], "meta count").splitlines()[-1])
            span = json.loads(_finish(procs[1], "the MoE gather's bytes")
                              .splitlines()[-1])
            cells = [json.loads(_finish(p, f"the model-axis cells at {m}")
                                .splitlines()[-1])
                     for p, m in zip(procs[2:], CELL_MESHES)]
            printed = [_finish(p, f"dryrun {' '.join(args)}").strip()
                       for p, args in zip(procs[2 + len(CELL_MESHES):],
                                          DRYRUN_PROOFS)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        records = {}
        for args in DRYRUN_PROOFS:
            mesh = "2x16x16" if "--multi-pod" in args else "16x16"
            name = f"{args[1]}__{args[3]}__pod{mesh}.json"
            records[f"{args[1]} {args[3]} {mesh}"] = json.loads(
                (Path(tmp) / "results" / "dryrun_torch" / name).read_text())
    out = check_dryrun(card, meta, records)
    out["model_axis_cells"] = {"torch": cells[0]["torch"],
                               "ran": sum(len(c["cells"]) for c in cells)}
    out["moe_span_bytes"] = span
    out["printed"] = printed
    out["check_seconds"] = {"card": card_s,
                            "all": time.perf_counter() - t0}
    return out


# ---------------------------------------------------------------------------
# phase 6: quantized_matmul, the int8 serving-path product
# ---------------------------------------------------------------------------

QUANT_REL_TOL = 0.05     # int8 activations and weights vs the float product


def drive_quantized(ops, ref):
    """``quantized_matmul`` at qwen2-0.5b's MLP shape, both ``bitserial``
    values: equal to the same steps through the plain versions, and close
    to the float product."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    m, k, n = MLP_SHAPE
    x = torch.randn(m, k, generator=gen, device="cuda")
    w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
    wq_t, ws = ref.quantize_rowwise_ref(w.T.contiguous())   # per column
    wq, scale = wq_t.T.contiguous(), ws[:, 0]
    exact = (x.double() @ w.double()).float()
    xq, xs = ref.quantize_rowwise_ref(x)
    out = {}
    for bitserial in (False, True):
        got = ops.quantized_matmul(x, wq, scale, bitserial=bitserial)
        acc = (ref.bitplane_matmul_ref(xq, wq) if bitserial
               else ref.int8_matmul_ref(xq, wq))
        plain = acc.to(torch.float32) * xs * scale[None, :]
        rel = float((got - exact).abs().max() / exact.abs().max())
        if not torch.equal(got, plain) or rel > QUANT_REL_TOL:
            raise AssertionError(f"quantized_matmul(bitserial={bitserial}):"
                                 f" equal to plain {torch.equal(got, plain)},"
                                 f" error vs float {rel}")
        out[f"bitserial={bitserial}"] = {"equal_to_plain": True,
                                         "max_err_vs_float_rel": rel}
    return out


def run_card_tests() -> dict:
    """Phase 2: the ``card`` tests (``tests/test_torch_*_card.py``) in this
    process, so every kernel the drives below launch is first held against
    its plain version at the main paths' shapes and limits.  Returns the
    number of test files and of tests by outcome; a failure, an error or a
    skip raises."""
    import pytest

    class Outcomes:
        def __init__(self):
            self.counts = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.counts[report.outcome] = \
                    self.counts.get(report.outcome, 0) + 1

    files = sorted(str(p) for p in
                   (ROOT / "tests").glob("test_torch_*_card.py"))
    seen = Outcomes()
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "card", *files],
                     plugins=[seen])
    if rc != 0 or set(seen.counts) != {"passed"}:
        raise AssertionError(f"the card tests: exit code {rc}, {seen.counts}")
    return {"files": len(files), **seen.counts}


def main() -> int:
    t_start = time.perf_counter()
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs on a CUDA device only", file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, card=card, torch=torch.__version__,
         cuda=torch.version.cuda)
    # ---- 2. card: each kernel against its plain version -----------------
    t0 = time.perf_counter()
    outcomes = run_card_tests()
    emit("card", seconds=time.perf_counter() - t0, **outcomes)

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bitplane_gemm import bitplane_matmul, int8_matmul
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.float_ops import float_binary, float_convert
    from repro_torch.kernels.mdgather import mdgather
    from repro_torch.kernels.mdscatter import mdscatter_
    wrappers = {"mdgather": mdgather, "mdscatter": mdscatter_,
                "flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd,
                "int8_matmul": int8_matmul,
                "bitplane_matmul": bitplane_matmul,
                "float_binary": float_binary, "float_convert": float_convert}
    mve = ("mdgather", "mdscatter", "float_binary")

    def drive(path, needs, fn, *args):
        """Run one main path with every launch counter at 0 just before it
        and read just after (the flash wrappers' float32 launches also
        as "<name> fp32", the forward's segmented ones as "<name>
        segmented"); each kernel in ``needs`` must have launched."""
        for w in wrappers.values():
            w.launches = 0
            for sub in ("launches_fp32", "launches_segmented"):
                if hasattr(w, sub):
                    setattr(w, sub, 0)
        out = fn(*args)
        counts = {name: w.launches for name, w in wrappers.items()}
        counts.update({f"{name} fp32": w.launches_fp32
                       for name, w in wrappers.items()
                       if hasattr(w, "launches_fp32")})
        counts.update({f"{name} segmented": w.launches_segmented
                       for name, w in wrappers.items()
                       if hasattr(w, "launches_segmented")})
        for name in needs:
            if counts[name] <= 0:
                raise AssertionError(f"the {path} path never launched {name}")
        return out, counts

    # ---- 4-6. the main paths, each with its launch counts ----------------
    (rows, batched, single_s, batch_s), counts = drive(
        "MVE", mve, drive_main_path)
    emit("path", mode="fused", patterns=rows, batched=batched, batch=BATCH,
         single_seconds=single_s, batch_seconds=batch_s, launches=counts)
    t0 = time.perf_counter()
    vm_out, vm_counts = drive("VM", mve + ("float_convert",), drive_vm)
    vm_drive_s = time.perf_counter() - t0
    vm_checks = check_vm(vm_out)
    del vm_out
    emit("vm", drive_seconds=vm_drive_s, seconds=time.perf_counter() - t0,
         launches=vm_counts, **vm_checks)
    t0 = time.perf_counter()
    tg = drive_targets()
    emit("targets", seconds=time.perf_counter() - t0, **tg)
    t0 = time.perf_counter()
    claims_want = claims_reference()
    claims_out, claims_counts = drive(
        "claims", mve + ("int8_matmul", "bitplane_matmul", "flash_attention"),
        drive_claims)
    claims = check_claims(claims_out, claims_want)
    del claims_out, claims_want
    emit("claims", seconds=time.perf_counter() - t0, launches=claims_counts,
         **claims)
    t0 = time.perf_counter()
    opt_out, opt_counts = drive("opt", mve, drive_opt)
    opt_checks = check_opt(opt_out)
    del opt_out
    emit("opt", seconds=time.perf_counter() - t0, launches=opt_counts,
         **opt_checks)
    t0 = time.perf_counter()
    from benchmarks.torch_serving_bench import request_stream
    stream = request_stream()
    want = serve_reference(stream)
    chaos_cpu = chaos_replays(stream, "cpu")
    serve_out, serve_counts = drive("serve", mve, drive_serve, stream)
    chaos = chaos_replays(stream, "cuda")
    serve = check_serve(serve_out, chaos, chaos_cpu, want)
    del serve_out, chaos, chaos_cpu
    emit("serve", seconds=time.perf_counter() - t0, launches=serve_counts,
         **serve)
    t0 = time.perf_counter()
    from benchmarks.torch_serving_bench import lm_block_stream
    blocks, lm_stream = nn_blocks(), lm_block_stream()
    nn_want, lm_want = nn_reference(blocks), serve_reference(lm_stream)
    (nn_out, slm_out), nn_counts = drive("nn", mve, lambda: (
        drive_nn(blocks), drive_serving_lm(lm_stream)))
    nn_checks = check_nn(blocks, nn_out, nn_want)
    slm = check_serving_lm(lm_stream, slm_out, lm_want)
    del nn_out, slm_out
    emit("nn", seconds=time.perf_counter() - t0, launches=nn_counts,
         serving_lm=slm, **nn_checks)
    t0 = time.perf_counter()
    restore = _no_plain_version_on_cuda()       # no flash on the plain path
    try:
        lm, lm_counts = drive("LM", ("flash_attention",), drive_family,
                              *FAMILIES[0], flash_attention)
        emit("lm", seconds=time.perf_counter() - t0, launches=lm_counts,
             float8_cache=check_float8_cache(), **lm)
        t0 = time.perf_counter()
        families, fam_counts = drive(
            "lm_families", ("flash_attention",), lambda: {
                arch: drive_family(arch, layers, seq, flash_attention)
                for arch, layers, seq in FAMILIES[1:]})
    finally:
        restore()
    emit("lm_families", seconds=time.perf_counter() - t0,
         launches=fam_counts, families=families)
    t0 = time.perf_counter()
    restore = _no_plain_version_on_cuda()
    try:
        train, train_counts = drive(
            "train", ("flash_attention", "flash_attention_bwd"), lambda: {
                "qwen2-0.5b": drive_train_qwen2(flash_attention,
                                                flash_attention_bwd),
                "whisper-base": drive_train_whisper(flash_attention,
                                                    flash_attention_bwd),
                "qwen2-0.5b options": drive_train_options(
                    flash_attention, flash_attention_bwd)})
    finally:
        restore()
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    emit("train", seconds=time.perf_counter() - t0, launches=train_counts,
         models=train)
    t0 = time.perf_counter()
    restore = _no_plain_version_on_cuda()
    try:
        mesh, mesh_counts = drive(
            "mesh", ("flash_attention", "flash_attention_bwd"), drive_mesh,
            flash_attention, flash_attention_bwd)
    finally:
        restore()
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    emit("mesh", seconds=time.perf_counter() - t0, launches=mesh_counts,
         **mesh)
    t0 = time.perf_counter()
    restore = _no_plain_version_on_cuda()
    try:
        dry, dry_counts = drive(
            "dryrun", ("flash_attention", "flash_attention_bwd"),
            drive_dryrun, flash_attention, flash_attention_bwd)
    finally:
        restore()
    emit("dryrun", seconds=time.perf_counter() - t0, launches=dry_counts,
         **dry)
    quant, quant_counts = drive("quantized", ("int8_matmul",
                                              "bitplane_matmul"),
                                drive_quantized, ops, ref)
    emit("quantized", shape=MLP_SHAPE, launches=quant_counts, **quant)
    launches = {name: counts[name] + vm_counts[name] + opt_counts[name]
                + serve_counts[name] + nn_counts[name]
                for name in mve + ("float_convert",)}
    launches.update({
        "flash_attention": (lm_counts["flash_attention"]
                            + fam_counts["flash_attention"]
                            + train_counts["flash_attention"]
                            + mesh_counts["flash_attention"]
                            + dry_counts["flash_attention"]),
        "flash_attention_bwd": (train_counts["flash_attention_bwd"]
                                + mesh_counts["flash_attention_bwd"]
                                + dry_counts["flash_attention_bwd"]),
        "int8_matmul": quant_counts["int8_matmul"],
        "bitplane_matmul": quant_counts["bitplane_matmul"]})
    for name in launches:                   # 4g runs all but the backward
        launches[name] += claims_counts[name]
    fp32 = {name: sum(c[f"{name} fp32"] for c in (
        lm_counts, fam_counts, train_counts, mesh_counts, dry_counts,
        claims_counts)) for name in ("flash_attention", "flash_attention_bwd")}
    segmented = sum(c["flash_attention segmented"] for c in (
        lm_counts, fam_counts, train_counts, mesh_counts, dry_counts,
        claims_counts))

    # ---- 7. result -------------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": replaces, "launches": launches[name]})
        if name in fp32:
            kernels[-1]["launches_fp32"] = fp32[name]
        if name == "flash_attention":
            kernels[-1]["launches_segmented"] = segmented
    emit("total", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
