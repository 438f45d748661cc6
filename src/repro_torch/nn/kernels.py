"""The model-block kernel zoo: real LM blocks on the ``@mve.kernel``
frontend.

Six block families cover the per-layer compute of a small LM:

  kv_gather    — multi-dimensional strided KV-cache read (the paper's
                 vsld story): a (head_dim, window, kv_heads) tile pulled
                 from a (seq, kv_heads, head_dim) cache in one access
  kv_scatter   — the write side (vsst with CR strides): a new tile
                 scattered into the cache layout
  attn_tile    — attention score + online softmax + PV accumulate
                 (after the flash-attention kernel): chunked over kv with
                 running max/sum and exp-rescale correction
  gemm_tile    — tiled int8 GEMM in bit-plane form (after the bit-plane
                 GEMM kernel): weights as unsigned bytes, planes
                 shifted/masked out with vshi/vand and accumulated with
                 two's-complement sign on plane 7
  ssm_scan     — one diagonal-SSM (Mamba2/SSD-style) decode step:
                 elementwise state decay + input inject, then a
                 cross-dimension tree reduction for the output
  moe_gather   — top-k expert gather through random-base pointer
                 tables (Eq. 1), gate-weighted accumulate

Every block is held against its plain PyTorch oracle in
:mod:`repro_torch.kernels.ref` — bit for bit for the integer and
copy/elementwise blocks (the oracles mirror the kernel's combination
order, see ``tree_sum_ref``), and within :data:`ATTN_RTOL` for the softmax
block.  The oracle's results are computed once, when the block is built;
:meth:`BlockRun.check` compares them with an executed memory image on
whatever device that image lies, one or a batch of images, without a
host round trip per element.  The inputs are drawn from the same NumPy
seeds as the reference's zoo, so the programs and images are its own.
Every block builds to a plain :class:`~repro_torch.core.isa.Program`, so
the whole executor/target/optimizer equivalence class applies unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.isa import DType
from ..core.machine import MVEConfig
from ..frontend import BCAST, CR, DERIVED, SEQ, Kernel, KernelBuilder
from ..kernels import ref
from .ops import exp_approx, recip_approx, tree_reduce_dim0

LANES = MVEConfig().lanes  # 8192

#: The accuracy bound of the softmax/exp path: exp_approx contributes
#: ~3e-6 relative, recip_approx is fp32-exact, and the fp32 accumulation
#: order differs from the oracle's — the measured worst-case relative error
#: is ~1e-5; the asserted bound keeps a 20x margin without hiding a real
#: numeric regression.
ATTN_RTOL = 2e-4
ATTN_ATOL = 2e-5


@dataclasses.dataclass
class BlockRun:
    """One built model block: kernel + memory + oracle results.

    ``expected`` maps operand names to what the oracle says they hold after
    the run (float32 tensors on the CPU); ``exactness`` records the
    contract :meth:`check` enforces (``"bit"`` or the ``rtol`` bound).
    """

    name: str
    family: str                 # memory | attention | gemm | ssm | moe
    dim: str                    # multi-dimensionality label, like patterns
    kernel: Kernel
    memory: np.ndarray
    expected: Dict[str, torch.Tensor]
    exactness: str
    flops: float = 0.0

    @property
    def program(self):
        return self.kernel.program

    def region(self, mem, name: str) -> torch.Tensor:
        """Operand ``name`` of a memory image (``(N,)`` or a batch ``(...,
        N)``; a tensor on any device, or a NumPy array) as a float32 view
        shaped ``(..., *operand shape)``, on the image's device."""
        if not isinstance(mem, torch.Tensor):
            mem = torch.from_numpy(np.ascontiguousarray(mem))
        op = self.kernel.plan.operands[name]
        got = mem[..., op.base:op.base + op.size]
        return got.to(torch.float32).reshape(mem.shape[:-1] + op.shape)

    def check(self, mem_after, state=None) -> None:
        """Assert the executed memory image (one or a batch) against the
        oracle: bit for bit, or within ``ATTN_RTOL``/``ATTN_ATOL`` for the
        softmax block.  The comparison runs on the image's device."""
        for name, want in self.expected.items():
            got = self.region(mem_after, name)
            want = want.to(got.device).expand(got.shape)
            if self.exactness == "bit":
                ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
            else:
                ok = bool(((got - want).abs()
                           <= ATTN_ATOL + ATTN_RTOL * want.abs()).all())
            if not ok:
                err = float((got.double() - want.double()).abs().max())
                raise AssertionError(
                    f"{self.name}: operand {name!r} differs from its oracle "
                    f"({self.exactness}); max abs err {err}")

    def error_of(self, mem_after) -> float:
        """Max relative error against the oracle over outputs of magnitude
        >= 1e-2 (smaller ones sit under the absolute term of the
        contract); 0 for a block that matched bit for bit."""
        worst = 0.0
        for name, want in self.expected.items():
            got = self.region(mem_after, name).double()
            want = want.to(got.device).double().expand(got.shape)
            mask = want.abs() >= 1e-2
            if bool(mask.any()):
                rel = (got - want).abs()[mask] / want.abs()[mask]
                worst = max(worst, float(rel.max()))
        return worst


# ---------------------------------------------------------------------------
# kv_gather / kv_scatter — the multi-dimensional random-access story.
# ---------------------------------------------------------------------------

def kv_gather(window: int = 32, n_kv: int = 2, head_dim: int = 16,
              max_seq: int = 64, pos0: int = 8, seed: int = 0) -> BlockRun:
    """Gather a (head_dim, window, n_kv) KV tile from a
    (max_seq, n_kv, head_dim) cache in a single 3-D strided load."""
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal(max_seq * n_kv * head_dim
                                ).astype(np.float32)
    dims = (head_dim, window, n_kv)
    strides = (1, n_kv * head_dim, head_dim)
    base = pos0 * n_kv * head_dim
    expected = ref.mdgather_ref(torch.from_numpy(cache), dims, strides, base)

    b = KernelBuilder("kv_gather")
    co = b.input("cache", (max_seq * n_kv * head_dim,), DType.F,
                 init=cache)
    out = b.output("tile", (n_kv, window, head_dim), DType.F)
    b.width(32)
    with b.dims(*dims, ld_strides={1: strides[1], 2: strides[2]}):
        b.scalar(4)
        v = co.at(base).load(SEQ, CR, CR)
        out.store(v, SEQ, DERIVED, DERIVED)
    k = b.build()
    return BlockRun("kv_gather", "memory", "3D", k, k.pack(),
                    {"tile": expected.reshape(n_kv, window, head_dim)},
                    exactness="bit")


def kv_scatter(window: int = 32, n_kv: int = 2, head_dim: int = 16,
               max_seq: int = 64, pos0: int = 8, seed: int = 1
               ) -> BlockRun:
    """Scatter a new (head_dim, window, n_kv) tile into the cache layout
    through store-side CR strides (the vsst path)."""
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal(max_seq * n_kv * head_dim
                                ).astype(np.float32)
    vals = rng.standard_normal((n_kv, window, head_dim)
                               ).astype(np.float32)
    dims = (head_dim, window, n_kv)
    strides = (1, n_kv * head_dim, head_dim)
    base = pos0 * n_kv * head_dim
    expected = ref.mdscatter_ref(torch.from_numpy(cache),
                                 torch.from_numpy(vals.ravel()), dims,
                                 strides, base)

    b = KernelBuilder("kv_scatter")
    vo = b.input("tile", (n_kv, window, head_dim), DType.F, init=vals)
    co = b.inout("cache", (max_seq * n_kv * head_dim,), DType.F,
                 init=cache)
    b.width(32)
    with b.dims(*dims, st_strides={1: strides[1], 2: strides[2]}):
        b.scalar(4)
        v = vo.load(SEQ, DERIVED, DERIVED)
        co.at(base).store(v, SEQ, CR, CR)
    k = b.build()
    return BlockRun("kv_scatter", "memory", "3D", k, k.pack(),
                    {"cache": expected}, exactness="bit")


# ---------------------------------------------------------------------------
# attn_tile — score + online softmax + PV accumulate.
# ---------------------------------------------------------------------------

def attn_tile(tq: int = 64, tk: int = 32, d: int = 16, chunk: int = 16,
              seed: int = 2, scale: Optional[float] = None) -> BlockRun:
    """One attention tile, online-softmax style: kv arrives in chunks;
    a running max/sum pair and an exp correction factor keep the
    partial output consistent (after the flash-attention kernel).

    Lane layouts per pass: scores in (chunk, tq), per-row state in
    (tq,), output accumulation in (d, tq) — the accumulator register
    survives layout switches because reconfiguring dimensions never
    touches register contents.
    """
    if tk % chunk or chunk & (chunk - 1):
        raise ValueError("tk must be a multiple of chunk, chunk a power "
                         f"of two; got tk={tk} chunk={chunk}")
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((tq, d)).astype(np.float32)
    kk_ = rng.standard_normal((tk, d)).astype(np.float32)
    v = rng.standard_normal((tk, d)).astype(np.float32)
    scale = float(scale) if scale is not None else 1.0 / np.sqrt(d)
    expected = ref.flash_attention_ref(
        *(torch.from_numpy(x)[None, None] for x in (q, kk_, v)),
        causal=False, scale=scale)[0, 0]

    b = KernelBuilder("attn_tile")
    qo = b.input("q", (tq, d), DType.F, init=q)
    ko = b.input("k", (tk, d), DType.F, init=kk_)
    vo = b.input("v", (tk, d), DType.F, init=v)
    oo = b.output("o", (tq, d), DType.F)
    so = b.scratch("scores", (tq, chunk), DType.F)
    ro = b.scratch("reduce", (tq, chunk), DType.F)
    mo = b.scratch("m_run", (tq,), DType.F)
    lo = b.scratch("l_run", (tq,), DType.F)
    ao = b.scratch("row_tmp", (tq,), DType.F)
    b.width(32)
    o_acc = None
    for c in range(tk // chunk):
        k0 = c * chunk
        # scores s[kk, q] = scale * sum_d K[k0+kk, d] * Q[q, d]
        b.dims(chunk, tq, ld_strides={0: d, 1: d},
               st_strides={1: chunk})
        b.scalar(6)
        acc = b.const(DType.F, 0.0)
        for dd in range(d):
            kcol = ko.at(k0, dd).load(CR, BCAST)
            qcol = qo.at(0, dd).load(BCAST, CR)
            acc += kcol * qcol
        acc *= scale
        so.at(0, 0).store(acc, SEQ, CR)
        tree_reduce_dim0(b, so, ro, chunk, tq, op="max")
        # running max update + correction factor alpha (per-q lanes)
        b.dims(tq, ld_strides={0: chunk})
        b.scalar(3)
        m_c = ro.at(0, 0).load(CR)
        if c == 0:
            mo.store(m_c, SEQ)
            alpha = None
        else:
            m_old = mo.load(SEQ)
            m_new = m_old.max(m_c)
            mo.store(m_new, SEQ)
            alpha = exp_approx(b, m_old - m_new)
            ao.store(alpha, SEQ)
        # p = exp(s - m_new), back into the score scratch
        b.dims(chunk, tq, st_strides={1: chunk})
        mrow = mo.load(BCAST, SEQ)
        p = exp_approx(b, acc - mrow)
        so.at(0, 0).store(p, SEQ, CR)
        tree_reduce_dim0(b, so, ro, chunk, tq, op="add")
        # running sum update (per-q lanes)
        b.dims(tq, ld_strides={0: chunk})
        b.scalar(2)
        l_c = ro.at(0, 0).load(CR)
        if c == 0:
            lo.store(l_c, SEQ)
        else:
            l_old = lo.load(SEQ)
            l_old *= alpha
            l_old += l_c
            lo.store(l_old, SEQ)
        # O accumulate in (d, q) lanes; rescale past chunks by alpha
        b.dims(d, tq, ld_strides={1: chunk})
        b.scalar(4)
        if c == 0:
            o_acc = b.const(DType.F, 0.0)
            b.keep(o_acc)
        else:
            o_acc *= ao.load(BCAST, SEQ)
        for kk in range(chunk):
            prow = so.at(0, kk).load(BCAST, CR)
            vrow = vo.at(k0 + kk, 0).load(SEQ, BCAST)
            o_acc += prow * vrow
    # normalize: o /= l  (reciprocal composed from existing ops)
    b.dims(tq)
    b.scalar(2)
    r = recip_approx(b, lo.load(SEQ), max_val=tk)
    ao.store(r, SEQ)
    b.dims(d, tq)
    o_acc *= ao.load(BCAST, SEQ)
    oo.store(o_acc, SEQ, DERIVED)
    k = b.build()
    return BlockRun("attn_tile", "attention", "2D", k, k.pack(),
                    {"o": expected}, exactness=f"rtol={ATTN_RTOL:g}",
                    flops=2.0 * tq * tk * (2 * d + 3))


# ---------------------------------------------------------------------------
# gemm_tile — bit-plane int8 GEMM (after the bit-plane GEMM kernel).
# ---------------------------------------------------------------------------

def gemm_tile(n: int = 64, kdim: int = 8, m: int = 64, seed: int = 3
              ) -> BlockRun:
    """C[N,M] = A[N,K] @ W[K,M] on int8 inputs, weight planes peeled
    bit-serially: W lives in memory as unsigned bytes; per plane ``p``
    the kernel shifts/masks the bit out (vshi/vand), scales it back by
    ``2**p`` and accumulates ``A-column * plane`` — subtracting on plane
    7 (two's complement).  Bit-exact against both int8 matmul oracles.
    """
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (n, kdim)).astype(np.int32)
    w = rng.integers(-128, 128, (kdim, m)).astype(np.int32)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    expected = ref.bitplane_matmul_ref(ta, tw)
    if not torch.equal(expected, ref.int8_matmul_ref(ta, tw)):
        raise AssertionError("gemm_tile: the int8 and bit-plane oracles "
                             "disagree")
    rows_per_iter = min(LANES // m, n, 256)

    b = KernelBuilder("gemm_tile")
    ao = b.input("a", (n, kdim), DType.DW, init=a)
    wo = b.input("w_u8", (kdim, m), DType.DW, init=w & 0xFF)
    co = b.output("c", (n, m), DType.DW)
    b.width(32)
    with b.dims(m, rows_per_iter, ld_strides={1: kdim}):
        one = b.const(DType.DW, 1)
        for n0 in range(0, n, rows_per_iter):
            b.scalar(6)
            acc = b.const(DType.DW, 0)
            for kk in range(kdim):
                b.scalar(4)
                col = ao.at(n0, kk).load(BCAST, CR)
                wrow = wo.at(kk, 0).load(SEQ, BCAST)
                for bit in range(8):
                    plane = wrow >> bit if bit else wrow.copy()
                    plane &= one
                    if bit:
                        plane <<= bit
                    term = col * plane
                    if bit == 7:
                        acc -= term
                    else:
                        acc += term
            co.at(n0, 0).store(acc, SEQ, DERIVED)
    k = b.build()
    # the memory image holds the int32 results as float32 (exact: every
    # |c| <= 128 * 128 * K is far below 2**24)
    return BlockRun("gemm_tile", "gemm", "2D", k, k.pack(),
                    {"c": expected.to(torch.float32)}, exactness="bit",
                    flops=2.0 * n * kdim * m)


# ---------------------------------------------------------------------------
# ssm_scan — one diagonal-SSM decode step (models/ssm.py family).
# ---------------------------------------------------------------------------

def ssm_scan(n_state: int = 16, d_inner: int = 64, seed: int = 4
             ) -> BlockRun:
    """h' = a * h + b ⊗ x (elementwise, state-major lanes), then
    y[p] = tree-sum_n c[n] * h'[p, n] — the cross-dimension reduction
    the base ISA lacks, supplied by :func:`tree_reduce_dim0`."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((d_inner, n_state)).astype(np.float32)
    a = rng.uniform(0.0, 1.0, (d_inner, n_state)).astype(np.float32)
    bvec = rng.standard_normal(n_state).astype(np.float32)
    x = rng.standard_normal(d_inner).astype(np.float32)
    cvec = rng.standard_normal(n_state).astype(np.float32)
    exp_h, exp_y = ref.ssm_scan_ref(*(torch.from_numpy(t) for t in
                                      (h, a, bvec, x, cvec)))

    b = KernelBuilder("ssm_scan")
    ho = b.inout("h", (d_inner, n_state), DType.F, init=h)
    ao = b.input("a", (d_inner, n_state), DType.F, init=a)
    bo = b.input("b", (n_state,), DType.F, init=bvec)
    xo = b.input("x", (d_inner,), DType.F, init=x)
    co = b.input("c", (n_state,), DType.F, init=cvec)
    yo = b.output("y", (d_inner,), DType.F)
    so = b.scratch("prod", (d_inner, n_state), DType.F)
    ro = b.scratch("reduce", (d_inner, n_state), DType.F)
    b.width(32)
    with b.dims(n_state, d_inner):
        b.scalar(5)
        t = bo.load(SEQ, BCAST) * xo.load(BCAST, SEQ)
        hn = ao.load(SEQ, DERIVED) * ho.load(SEQ, DERIVED)
        hn += t
        ho.store(hn, SEQ, DERIVED)
        w = co.load(SEQ, BCAST) * hn
        so.store(w, SEQ, DERIVED)
    tree_reduce_dim0(b, so, ro, n_state, d_inner, op="add")
    b.dims(d_inner, ld_strides={0: n_state})
    b.scalar(2)
    yo.store(ro.at(0, 0).load(CR), SEQ)
    k = b.build()
    return BlockRun("ssm_scan", "ssm", "2D", k, k.pack(),
                    {"h": exp_h, "y": exp_y}, exactness="bit",
                    flops=5.0 * d_inner * n_state)


# ---------------------------------------------------------------------------
# moe_gather — top-k expert gather through pointer tables (Eq. 1).
# ---------------------------------------------------------------------------

def moe_gather(tokens: int = 64, d_expert: int = 32, n_experts: int = 8,
               topk: int = 2, seed: int = 5) -> BlockRun:
    """y[t] = sum_j gate[t,j] * W[expert[t,j], :]: per-token expert rows
    arrive through random-base loads walking a pointer table built from
    the routing decision — the paper's 4th, "random" dimension."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n_experts, d_expert)).astype(np.float32)
    experts = rng.integers(0, n_experts, (tokens, topk))
    gates = rng.uniform(0.1, 1.0, (tokens, topk)).astype(np.float32)
    gates = (gates / gates.sum(axis=1, keepdims=True)).astype(np.float32)
    expected = ref.moe_gather_ref(*(torch.from_numpy(t) for t in
                                    (w, experts, gates)))

    b = KernelBuilder("moe_gather")
    wo = b.input("w", (n_experts, d_expert), DType.F, init=w)
    go = b.input("gates", (tokens, topk), DType.F, init=gates)
    ptrs = [b.input(f"ptrs{j}", (tokens,), DType.F,
                    init=wo.addr(experts[:, j] * d_expert))
            for j in range(topk)]
    yo = b.output("y", (tokens, d_expert), DType.F)
    b.width(32)
    with b.dims(d_expert, tokens, ld_strides={1: topk}):
        b.scalar(4 + 2 * topk)
        acc = b.const(DType.F, 0.0)
        for j in range(topk):
            row = ptrs[j].rload(SEQ)
            gate = go.at(0, j).load(BCAST, CR)
            acc += row * gate
        yo.store(acc, SEQ, DERIVED)
    k = b.build()
    return BlockRun("moe_gather", "moe", "2D+rnd", k, k.pack(),
                    {"y": expected}, exactness="bit",
                    flops=2.0 * tokens * topk * d_expert)


#: The zoo registry, mirroring ``core.patterns.PATTERNS``.
BLOCK_KERNELS: Dict[str, Callable[..., BlockRun]] = {
    "kv_gather": kv_gather,
    "kv_scatter": kv_scatter,
    "attn_tile": attn_tile,
    "gemm_tile": gemm_tile,
    "ssm_scan": ssm_scan,
    "moe_gather": moe_gather,
}

#: The paper's multi-dimensional access story: blocks where MVE must
#: beat the 1D ISA (the models bench asserts this geomean).
MULTIDIM_BLOCKS = ("kv_gather", "kv_scatter", "attn_tile")
