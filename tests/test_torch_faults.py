"""Places where the port once disagreed with the reference, each pinned by
the input that showed it (ROADMAP queue C): port fused == port stepwise ==
reference ``run_stepwise``, bit for bit, NaN bits included.

* C3 — a store address in ``[-N, 0)`` wraps to ``addr + N`` (the
  reference's scatters index Python-style); below ``-N`` it is dropped;
  collisions are resolved after the wrap, highest lane winning.
* C2 — ``vmax``/``vmin`` return the NaN bits and zero signs that
  ``jnp.maximum``/``jnp.minimum`` return on XLA:CPU.
* C6 — a random-base access whose pointer is NaN, ±inf or past int32: the
  reference's executors disagree with each other (undefined float -> int
  casts, index narrowing, an int32 add that wraps); the port saturates the
  pointer to int32 (NaN -> 0) and adds in int64, the same in all its
  executors.  The reference's values are written down here, not copied.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile_program as ref_compile
from repro.core import isa as ref_isa
from repro.core.isa import DType
from repro.kernels import ref as jref

from repro_torch import convert
from repro_torch.core.engine import compile_program
from repro_torch.kernels import ref
from repro_torch.kernels.mdscatter import mdscatter

from _torch_parity import (PORT_ORACLE, REF_ORACLE, _image,
                           assert_bits_equal, assert_state_equal,
                           assert_trace_equal, check_program)

I = ref_isa
N = 4096


def _negative_stride_store():
    """``vsst`` whose CR stride is negative: lanes land below 0 (wrap), far
    below ``-N`` (dropped), and on ``N - 1`` twice (lane ``-1`` after the
    wrap and lane ``N - 1`` before it collide; the higher lane wins)."""
    return [I.vsetwidth(32), I.vsetdimc(2), I.vsetdiml(0, 8),
            I.vsetdiml(1, 4), I.vsld(DType.F, 0, 0, 1, 2),
            I.vsetststr(0, -3),
            I.vsst(DType.F, 0, 10, 3, 2),          # 10 down to -83
            I.vsetststr(0, -3000),
            I.vsst(DType.F, 0, 20, 3, 1),          # -2980, -5980 (drops)
            I.vsetdimc(1), I.vsetdiml(0, 2), I.vsetststr(0, -N),
            I.vsst(DType.DW, 0, N - 1, 3)]         # N-1, then -1 -> N-1


def _negative_pointer_store():
    """``vrst`` through a pointer table holding negative pointers: -1 and
    -8 wrap, ``-N - 5`` drops, and -1 collides with ``N - 1``."""
    return [I.vsetwidth(32), I.vsetdimc(2), I.vsetdiml(0, 4),
            I.vsetdiml(1, 5), I.vsld(DType.F, 0, 0, 1, 2),
            I.vrst(DType.F, 0, 600, 1, 0),
            I.vunsetmask(1), I.vrst(DType.F, 0, 600, 0, 0)]


def _pointer_image():
    mem = _image(11)
    mem[600:605] = [N - 1, -1, -8, -N - 5, 100]
    return mem


@pytest.mark.parametrize("name", ["vsst_negative_stride",
                                  "vrst_negative_pointer"])
def test_c3_negative_store_addresses_wrap_like_the_reference(name):
    program, image = {
        "vsst_negative_stride": (_negative_stride_store, _image),
        "vrst_negative_pointer": (_negative_pointer_store, _pointer_image),
    }[name]
    mem, _ = check_program(program(), image())
    before = np.asarray(image(), np.float32)
    # the wrap really happened: the image's end was written
    assert not np.array_equal(mem.numpy()[N - 96:], before[N - 96:])


@pytest.mark.parametrize("dims,strides,base", [
    ((8, 4), (-3, -24), 10), ((6,), (-5,), 2), ((5, 3), (1, -40), 12),
    ((4,), (-70,), 30)])
def test_c3_plain_scatter_wraps_like_the_reference_oracle(dims, strides,
                                                          base):
    rng = np.random.default_rng(0)
    dst = rng.standard_normal(64).astype(np.float32)
    vals = rng.standard_normal(int(np.prod(dims))).astype(np.float32)
    got = mdscatter(torch.from_numpy(dst), torch.from_numpy(vals), dims,
                    strides, base)
    want = jref.mdscatter_ref(jnp.asarray(dst), jnp.asarray(vals), dims,
                              strides, base)
    assert_bits_equal(want, got.numpy())


def test_c3_wrap_helper():
    addr = torch.tensor([-9, -8, -1, 0, 7, 8])
    np.testing.assert_array_equal(
        ref.wrap_store_addresses(addr, 8).numpy(), [-1, 0, 7, 0, 7, 8])
    np.testing.assert_array_equal(
        ref.wrap_store_addresses(np.array([-3, 3]), 8), [5, 3])


_NAN_BITS = [0x7FC00001, 0xFFC00002, 0x7F800001, 0xFF800003, 0x7FC00000,
             0xFFC00000, 0x00000000, 0x80000000, 0x3F800000, 0xBF800000,
             0x7F800000, 0xFF800000]


def _nan_image():
    """Every pairing of quiet/signalling NaNs of both signs with each other,
    with ±0, ±1 and ±inf, as two float32 operand vectors."""
    a, b = np.meshgrid(np.array(_NAN_BITS, np.uint32),
                       np.array(_NAN_BITS, np.uint32))
    mem = np.zeros(N, np.float32)
    mem[:a.size] = a.ravel().view(np.float32)
    mem[256:256 + b.size] = b.ravel().view(np.float32)
    return mem


def _nan_program():
    """The C2 input — ``inf - inf`` into ``vmax`` — then every NaN pairing
    through ``vmax``/``vmin`` in both operand orders, in fp32 and fp16."""
    n = len(_NAN_BITS) ** 2
    p = [I.vsetwidth(32), I.vsetdimc(1), I.vsetdiml(0, n),
         I.vsetdup(DType.F, 0, float("inf")), I.vsub(DType.F, 1, 0, 0),
         I.vsetdup(DType.F, 2, 1.0), I.vmax(DType.F, 3, 1, 2),
         I.vmin(DType.F, 4, 2, 1), I.vsst(DType.F, 3, 1024, 1),
         I.vsld(DType.F, 5, 0, 1), I.vsld(DType.F, 6, 256, 1)]
    for k, (op, x, y) in enumerate([(I.vmax, 5, 6), (I.vmax, 6, 5),
                                    (I.vmin, 5, 6), (I.vmin, 6, 5)]):
        p += [op(DType.F, 7, x, y), I.vsst(DType.F, 7, 2048 + 256 * k, 1)]
    p += [I.vcvt(DType.HF, 8, 5), I.vcvt(DType.HF, 9, 6),
          I.vmax(DType.HF, 10, 8, 9), I.vmin(DType.HF, 11, 9, 8)]
    return p


def test_c2_vmax_vmin_keep_the_references_nan_bits():
    mem, state = check_program(_nan_program(), _nan_image())
    # the C2 input itself: inf - inf is the negative quiet NaN, and vmax
    # hands it back unchanged rather than as torch's canonical NaN
    r3 = state.regs[3].numpy().view(np.uint32)
    assert r3[0] == 0xFFC00000


def _c6_image(p):
    """Each cell holds its own address; the pointer table at 600 is
    ``[p, 50]``."""
    mem = np.arange(N, dtype=np.float32)
    mem[600:602] = [p, 50.0]
    return mem


_C6_PROGRAMS = {
    # vrld through the table, then a dense store of the lanes to 2000
    "vrld": [I.vsetwidth(32), I.vsetdimc(2), I.vsetdiml(0, 4),
             I.vsetdiml(1, 2), I.vrld(DType.F, 0, 600, 1, 0),
             I.vsst(DType.F, 0, 2000, 1, 2)],
    # values 100.. loaded, then stored through the table
    "vrst": [I.vsetwidth(32), I.vsetdimc(2), I.vsetdiml(0, 4),
             I.vsetdiml(1, 2), I.vsld(DType.F, 0, 100, 1, 2),
             I.vrst(DType.F, 0, 600, 1, 0)],
}

_ROW0, _ROW1, _LAST = [0, 1, 2, 3], [50, 51, 52, 53], [N - 1]

#: (op, p) -> executor -> (what the run did, the access's trace ``lines``):
#: for ``vrld`` the addresses lanes 0-3 read (the cells hold their
#: address), for ``vrst`` the cells written.  "port" is every executor of
#: the port.
C6 = {
    ("vrld", "nan"): {"ref_step": ([0] * 4, 2), "ref_fused": (_ROW0, 2),
                      "ref_vm": (_ROW0, 2), "port": (_ROW0, 2)},
    ("vrld", "+inf"): {"ref_step": ([0] * 4, 2),
                       "ref_fused": ([N - 1, 0, 0, 0], 3),
                       "ref_vm": ([N - 1, 0, 0, 0], 3),
                       "port": ([N - 1] * 4, 3)},
    ("vrld", "-inf"): {"ref_step": ([0] * 4, 2), "ref_fused": ([0] * 4, 2),
                       "ref_vm": ([0] * 4, 2), "port": ([0] * 4, 2)},
    ("vrld", "3e9"): {"ref_step": ([N - 1] * 4, 2),
                      "ref_fused": ([N - 1, 0, 0, 0], 3),
                      "ref_vm": ([N - 1, 0, 0, 0], 3),
                      "port": ([N - 1] * 4, 3)},
    ("vrst", "nan"): {"ref_step": (_ROW0 + _ROW1, 2),
                      "ref_fused": (_ROW0 + _ROW1 + _LAST, 2),
                      "ref_vm": (_ROW0 + _ROW1, 2),
                      "port": (_ROW0 + _ROW1, 2)},
    ("vrst", "+inf"): {"ref_step": (_ROW0 + _ROW1, 2),
                       "ref_fused": (_ROW1 + _LAST, 3),
                       "ref_vm": (_ROW1, 3), "port": (_ROW1, 3)},
    ("vrst", "-inf"): {"ref_step": (_ROW0 + _ROW1, 2),
                       "ref_fused": (_ROW1 + _LAST, 2),
                       "ref_vm": (_ROW1, 2), "port": (_ROW1, 2)},
    ("vrst", "3e9"): {"ref_step": (_ROW1, 2),
                      "ref_fused": (_ROW1 + _LAST, 3),
                      "ref_vm": (_ROW1, 3), "port": (_ROW1, 3)},
}
_P = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf, "3e9": 3e9}


def _c6_observed(op, image, mem, state):
    mem = np.asarray(mem, dtype=np.float32)
    if op == "vrld":
        did = mem[2000:2004].astype(np.int64).tolist()
    else:
        did = np.flatnonzero(mem.view(np.uint32)
                             != image.view(np.uint32)).tolist()
    lines = [ev.lines for ev in state.trace if ev.op.name in ("RLD", "RST")]
    assert len(lines) == 1
    return did, lines[0]


@pytest.mark.parametrize("op,p", sorted(C6))
def test_c6_nonfinite_pointers(op, p):
    """The port's executors — stepwise, fused, VM, and the VM and fused
    batches — agree with each other bit for bit (memory, registers, Tag,
    trace); the reference's three executors give the values written down
    in :data:`C6`, which the port does not copy."""
    program, image = _C6_PROGRAMS[op], _c6_image(_P[p])
    want = C6[(op, p)]
    ref_runs = {"ref_step": REF_ORACLE.run_stepwise(program, image),
                "ref_fused": ref_compile(program, mode="fused").run(image),
                "ref_vm": ref_compile(program, mode="vm").run(image)}
    for name, (mem, state) in ref_runs.items():
        assert _c6_observed(op, image, mem, state) == want[name], name

    port_program = convert.program_from_reference(program)
    mem_s, st_s = PORT_ORACLE.run_stepwise(port_program, image)
    assert _c6_observed(op, image, mem_s.numpy(), st_s) == want["port"]
    batch = np.stack([image, _c6_image(1000.0)])
    for mode in ("fused", "vm"):
        cp = compile_program(port_program, mode=mode, device="cpu")
        assert cp.mode == mode
        mem, state = cp.run(image)
        assert_bits_equal(mem_s.numpy(), mem.numpy(), mode)
        assert_state_equal(_as_reference_state(st_s), state, mode)
        assert_trace_equal(st_s.trace, state.trace)
        mems, regs, tag = cp.run_batch(batch)
        assert_bits_equal(mem_s.numpy(), mems[0].numpy(), f"{mode} batch")
        for k, v in st_s.regs.items():
            assert_bits_equal(v.numpy(), regs[k][0].numpy(), f"{mode} v{k}")
        assert_bits_equal(st_s.tag.numpy(), tag[0].numpy())


def _as_reference_state(state):
    """A port state in the shape ``assert_state_equal`` compares against
    (NumPy memory, registers and Tag)."""
    from types import SimpleNamespace
    return SimpleNamespace(memory=state.memory.numpy(),
                           regs={k: v.numpy() for k, v in state.regs.items()},
                           tag=state.tag.numpy())
