"""Every route of the ``vsld`` kernel on the same load walks, on one card.

``kernels/mdgather.py::load_plan`` picks one route of
``csrc/mdgather.cu`` per walk; this script calls the kernel's C entry with
each route that computes the walk right — ``walk`` for every walk, the
copy where the plan says ``contiguous``, the tile where it says ``tiled`` —
so that the plan's choices can be held against the alternatives.  It
times the transpose pattern's load walk, the same walk over rows 64
elements apart (each row's 16 elements then start on a 64-byte boundary,
where the pattern's 49-element rows put them anywhere), a contiguous run
and gemm's replicating row walk (fp32, 8192 lanes, image 50176, 1 and 1024
images), each route first checked bit for bit against the plain version,
beside ``torch.index_select`` and the bytes bound (each needed element
read once, each lane written once, at 3.35 TB/s); and ``zero_`` of the
output (only its writes) as the write rate's yardstick.  Needs a CUDA
device.

    PYTHONPATH=src python -m benchmarks.torch_gather_routes \\
        --out chiprun_out/gather_routes.json
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from benchmarks.torch_kernel_ab import device_ms, time_ms
from repro_torch.kernels import _build, ref
from repro_torch.kernels.mdgather import _ROUTE_IDS, _call, _entry, _Plan

HBM_BYTES_PER_S = 3.35e12
BATCH, LANES, IMAGE = 1024, 8192, 50176
WALKS = {"transposing": ((512, 16), (49, 1), 0),
         "transposing, aligned rows": ((512, 16), (64, 1), 0),
         "contiguous": ((8192,), (1,), 0),
         "replicating": ((64, 128), (0, 16), 0)}


def launch(src: torch.Tensor, packed: _Plan) -> torch.Tensor:
    """The kernel's C entry with a packed plan whose route may differ from
    the one the wrapper's plan chose."""
    out = torch.empty(src.shape[:-1] + (LANES,), dtype=src.dtype,
                      device=src.device)
    batch = src.shape[0] if src.dim() == 2 else 1
    code = _entry()(src.data_ptr(), out.data_ptr(), batch,
                    src.element_size(), ctypes.addressof(packed),
                    torch.cuda.current_stream().cuda_stream)
    _build.check(code, "mdgather")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_gather_routes needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    rows = [{"card": card, "torch": torch.__version__}]
    print(json.dumps(rows[0]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch, iters in ((BATCH, 50), (1, 500)):
        shape = (batch, IMAGE) if batch > 1 else (IMAGE,)
        src = torch.randn(shape, generator=gen, device="cuda")
        for name, (dims, strides, base) in WALKS.items():
            _, plan, packed = _call(dims, strides, base, IMAGE, LANES)
            addr = ref.mdv_lane_addresses(dims, strides, base, LANES, "cuda")
            unique = int(np.unique(addr.cpu().numpy()).size)
            want = ref.mdgather_ref(src, dims, strides, base, LANES)
            row = {"walk": name, "batch": batch, "plan": plan.route,
                   "bound_ms": batch * (unique + LANES) * 4
                   / HBM_BYTES_PER_S * 1e3}
            for route in sorted({"walk", plan.route}):
                forced = _Plan.from_buffer_copy(packed)
                forced.route = _ROUTE_IDS[route]
                if not torch.equal(launch(src, forced), want):
                    raise AssertionError(f"{route} route != plain: {name}")
                call = (lambda: launch(src, forced))
                row[f"{route}_ms"] = time_ms(call, iters)
                row[f"{route}_device_ms"] = device_ms(call, 100)
            lib = (lambda: torch.index_select(src, -1, addr))
            row["index_select_ms"] = time_ms(lib, iters)
            row["index_select_device_ms"] = device_ms(lib, 100)
            rows.append(row)
            print(json.dumps(row), flush=True)
        out = torch.empty(shape[:-1] + (LANES,), device="cuda")
        rows.append({"yardstick": "zero_", "batch": batch,
                     "bound_ms": out.numel() * 4 / HBM_BYTES_PER_S * 1e3,
                     "ms": time_ms(out.zero_, iters),
                     "device_ms": device_ms(out.zero_, 100)})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
