"""Plain reference for ``mve-table4``: what each frozen Section-IV pattern
computes, written from the pattern's definition over the operands of a
batch of memory images, with no ISA executor.

``expected(name, pattern, before)`` is the whole image after the program:
the input image with its outputs (and scratch) written.  Float operations
are IEEE float32, one rounding each, in the program's order, with x86's
flush of subnormal results to zero (the machine's float rule); integers
are exact in the operand's type (the inputs lie in ``[0, 255)``, so only
``png_up``'s byte sum wraps).  Pointer tables are read from the image, as
the random-base accesses read them.  ``lower=True`` rounds every float
result to bfloat16: the control, computed one precision below the
configuration's float32.

Imports nothing of the program.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

TINY = torch.finfo(torch.float32).tiny


def _region(img: torch.Tensor, op: dict) -> torch.Tensor:
    size = 1
    for n in op["shape"]:
        size *= n
    return img[:, op["base"]:op["base"] + size].reshape(
        img.shape[0], *op["shape"])


def _write(img: torch.Tensor, op: dict, value: torch.Tensor) -> None:
    _region(img, op).copy_(value.to(torch.float32))


class _Float:
    """float32 arithmetic as the machine does it (or, lowered, bfloat16)."""

    def __init__(self, lower: bool):
        self.lower = lower

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.where(x.abs() < TINY, x * 0.0, x)     # flush to zero
        if self.lower:
            x = x.to(torch.bfloat16).to(torch.float32)
        return x

    def add(self, a, b):
        return self._round(a + b)

    def mul(self, a, b):
        return self._round(a * b)


def _daxpy(ops, img, out, f):
    x, y = _region(img, ops["x"]), _region(img, ops["y"])
    _write(out, ops["y"], f.add(y, f.mul(torch.tensor(1.5), x)))


def _gemm(ops, img, out, f):
    a, b = _region(img, ops["a"]), _region(img, ops["b"])
    acc = torch.zeros(a.shape[0], a.shape[1], b.shape[2], device=img.device)
    for k in range(a.shape[2]):
        acc = f.add(acc, f.mul(a[:, :, k, None], b[:, None, k, :]))
    _write(out, ops["c"], acc)


def _intra_pred(ops, img, out, f):
    r1 = _region(img, ops["ref1"]).to(torch.int32)
    r2 = _region(img, ops["ref2"]).to(torch.int32)
    _write(out, ops["pred"], (r1[:, :, None, :] + r2[:, :, :, None]) >> 1)


def _memcpy(ops, img, out, f):
    _write(out, ops["dst"], _region(img, ops["src"]))


def _rows_at(img: torch.Tensor, ptrs: torch.Tensor, width: int
             ) -> torch.Tensor:
    """``img[b, ptrs[b, r] + j]`` for every row pointer and j < width."""
    idx = ptrs.long()[:, :, None] + torch.arange(width, device=img.device)
    return torch.gather(img, 1, idx.reshape(img.shape[0], -1)).reshape(
        idx.shape)


def _png_up(ops, img, out, f):
    width = ops["raw"]["shape"][1]
    raw = _rows_at(img, _region(img, ops["raw_ptrs"]), width).to(torch.int32)
    prior = _rows_at(img, _region(img, ops["prior_ptrs"]),
                     width).to(torch.int32)
    _write(out, ops["out"], (raw + prior) & 0xFF)


def _upsample(ops, img, out, f):
    width = ops["rows"]["shape"][1]
    src = _rows_at(img, _region(img, ops["in_ptrs"]), width)
    wide = src.repeat_interleave(2, dim=2)                # out[2x + r] = src[x]
    dst = _region(img, ops["out_ptrs"]).long()[:, :, None] + \
        torch.arange(2 * width, device=img.device)
    out.scatter_(1, dst.reshape(img.shape[0], -1),
                 wide.reshape(img.shape[0], -1))


def _rgb2gray(ops, img, out, f):
    rgb = _region(img, ops["rgb"]).to(torch.int32)
    gray = (rgb[..., 0] * 5 + rgb[..., 1] * 9 + rgb[..., 2] * 2) >> 4
    _write(out, ops["gray"], gray)


def _alpha_blend(ops, img, out, f):
    s = _region(img, ops["src"]).to(torch.int32)
    d = _region(img, ops["dst"]).to(torch.int32)
    _write(out, ops["dst"], (s * 6 + d * 10) >> 4)


def _audio_mix(ops, img, out, f):
    a, b = _region(img, ops["a"]), _region(img, ops["b"])
    gain = torch.tensor(0.7, dtype=torch.float32)
    _write(out, ops["out"], f.mul(f.add(a, b), gain))


def _reduction(ops, img, out, f):
    """The Section-IV tree: at each level the upper half of the live lanes
    is stored to the scratch region's start and added onto the lower
    half, down to 256 partial sums."""
    acc = _region(img, ops["x"]).to(torch.int64).clone()
    tmp = _region(out, ops["tmp"])
    floor = ops["partial"]["shape"][0]
    m = acc.shape[1]
    while m > floor:
        half = m // 2
        tmp[:, :half] = acc[:, half:m].to(torch.float32)
        acc[:, :half] += acc[:, half:m]
        m = half
    _write(out, ops["partial"], acc[:, :floor])


def _xor_cipher(ops, img, out, f):
    pt = _region(img, ops["plaintext"]).to(torch.int32)
    key = _region(img, ops["key"]).to(torch.int32)
    _write(out, ops["ciphertext"], pt ^ key[:, None, :])


def _transpose(ops, img, out, f):
    _write(out, ops["out"], _region(img, ops["a"]).transpose(1, 2))


PATTERNS: Dict[str, Callable] = {
    "daxpy": _daxpy, "gemm": _gemm, "intra_pred": _intra_pred,
    "memcpy": _memcpy, "png_up": _png_up, "upsample": _upsample,
    "rgb2gray": _rgb2gray, "alpha_blend": _alpha_blend,
    "audio_mix": _audio_mix, "reduction": _reduction,
    "xor_cipher": _xor_cipher, "transpose": _transpose,
}


@torch.no_grad()
def expected(name: str, pattern: dict, before: torch.Tensor,
             lower: bool = False) -> torch.Tensor:
    """The ``(B, N)`` images after the pattern's program ran on
    ``before``."""
    ops = {op["name"]: op for op in pattern["operands"]}
    out = before.clone()
    PATTERNS[name](ops, before, out, _Float(lower))
    return out
