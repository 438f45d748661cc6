"""Shared helpers of the port's mesh tests: a script run on N ranks of a
gloo process group (N processes, a ``FileStore`` in a temporary directory,
so no port is picked), and a script of the reference run on N XLA host
devices, each in its own processes under a timeout, never in the pytest
worker.  Scripts exchange arrays through ``.npz`` files."""
import os
import subprocess
import sys
import tempfile
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", rank=RANK, world_size=WORLD,
                        store=dist.FileStore(sys.argv[3], WORLD))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         os.path.join(ROOT, "tests")])
    env.update(extra)
    return env


def run_ranks(code: str, world: int, timeout: float = 120) -> list:
    """``code`` on ``world`` gloo ranks (``RANK``, ``WORLD`` and ``np``,
    ``torch``, ``dist`` defined; the group started); returns each rank's
    stdout.  Fails on any rank's error or on the timeout."""
    script = _PRELUDE + textwrap.dedent(code) + \
        "\ndist.destroy_process_group()\n"
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(world), store],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(OMP_NUM_THREADS="1")) for r in range(world)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                assert p.returncode == 0, err[-4000:]
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return outs


def run_script(code: str, args=(), timeout: float = 120, **env) -> str:
    """``code`` in a fresh process with ``args`` as ``sys.argv[1:]``."""
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code), *map(str, args)],
        capture_output=True, text=True, timeout=timeout, env=_env(**env))
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def run_reference(code: str, devices: int, args=(),
                  timeout: float = 300) -> str:
    """``code`` in a process whose JAX has ``devices`` CPU devices."""
    return run_script(
        code, args, timeout, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
