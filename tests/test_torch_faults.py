"""Places where the port once disagreed with the reference, each pinned by
the input that showed it (ROADMAP queue C): port fused == port stepwise ==
reference ``run_stepwise``, bit for bit, NaN bits included.

* C3 — a store address in ``[-N, 0)`` wraps to ``addr + N`` (the
  reference's scatters index Python-style); below ``-N`` it is dropped;
  collisions are resolved after the wrap, highest lane winning.
* C2 — ``vmax``/``vmin`` return the NaN bits and zero signs that
  ``jnp.maximum``/``jnp.minimum`` return on XLA:CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import isa as ref_isa
from repro.core.isa import DType
from repro.kernels import ref as jref

from repro_torch.kernels import ref
from repro_torch.kernels.mdscatter import mdscatter

from _torch_parity import _image, assert_bits_equal, check_program

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
