"""Builds the CUDA sources under ``csrc/`` and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so one ``nvcc`` call per source takes seconds.  All sources are
compiled together (one process each, started at once) at the first kernel
launch, into ``build/repro_torch_kernels/`` at the root of the checkout;
the library's file name carries a hash of every file under ``csrc/``, so an
edited source is rebuilt and an unchanged one is reused.  A failing build
or load raises :class:`KernelBuildError` — there is no other path for a
CUDA tensor.

Nothing in this module runs at import: the tests on a machine without
``nvcc`` import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing, a source failed to compile, or a library failed
    to load."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels cannot be built on this machine")


def source_hash() -> str:
    """Hash of every file under ``csrc/`` plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, all
    in parallel; returns ``{name: path of its shared library}``.  The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``<name>.log``."""
    tag = source_hash()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {src.stem: BUILD_DIR / f"lib{src.stem}_{tag}.so"
            for src in sorted(CSRC.glob("*.cu"))}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if not todo:
        return outs
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, todo[name])
    if failures:
        raise KernelBuildError("nvcc failed for " + "\n".join(failures))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            path = build_all().get(name)
            if path is None:
                raise KernelBuildError(f"no CUDA source csrc/{name}.cu")
            try:
                _LIBS[name] = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"loading {path} failed: {e}") from e
        return _LIBS[name]


def check(code: int, what: str) -> None:
    """Raise on the non-zero CUDA error code a C entry point returned."""
    if code != 0:
        raise RuntimeError(
            f"{what}: launch failed with CUDA error {code}"
            if code > 0 else f"{what}: unsupported element size")
