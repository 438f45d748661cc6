"""The port stands alone: ``repro_torch`` imports and runs with ``jax`` and
the reference package made unimportable — every module of it, the MVE path
(fused and VM), the targets, timing and silicon models, the optimizer, the
program server, the LM slice (prefill, decode, the serving engine) for
all six families (dense, moe, ssm, hybrid, vlm, encdec) with their input
specs, and the ``nn`` block zoo —
and importing it neither builds nor loads a CUDA kernel.  The VM's, the
targets' and the scheduler's entry points default to ``cuda``.  A new
module of the port (or a port benchmark or example) that imports ``jax``
or ``repro`` fails both tests here.
"""
import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None            # any import of these now raises
import importlib, pkgutil
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
from repro_torch.kernels import _build
assert not _build._LIBS, "a kernel library was loaded at import"
assert not _build.BUILD_DIR.exists() or not any(
    p.stat().st_mtime > START for p in _build.BUILD_DIR.iterdir()), \
    "importing the package built something"
import numpy as np
from repro_torch.core import patterns
from repro_torch.core.machine import to_numpy
run = patterns.PATTERNS["{pattern}"]()
mem, state = patterns.run_pattern(run, device="cpu")
run.check(to_numpy(mem), state)
for needed in ("repro_torch.configs", "repro_torch.core.packing",
               "repro_torch.kernels.flash_attention",
               "repro_torch.kernels.bitplane_gemm", "repro_torch.models.lm",
               "repro_torch.launch.steps", "repro_torch.launch.serve",
               "repro_torch.core.vm", "repro_torch.core.rvv",
               "repro_torch.timing.uarch", "repro_torch.timing.model",
               "repro_torch.silicon.sram", "repro_torch.silicon.params",
               "repro_torch.silicon.area", "repro_torch.silicon.sweep",
               "repro_torch.silicon.autotune", "repro_torch.targets.base",
               "repro_torch.targets.builtin", "repro_torch.targets.timed",
               "repro_torch.targets.bicameral", "repro_torch.kernels.float_ops",
               "repro_torch.opt.passes", "repro_torch.opt.pipeline",
               "repro_torch.opt.verify", "repro_torch.opt.tune",
               "repro_torch.resilience.errors", "repro_torch.resilience.faults",
               "repro_torch.resilience.breaker", "repro_torch.resilience.audit",
               "repro_torch.runtime.health", "repro_torch.runtime.scheduler",
               "repro_torch.nn", "repro_torch.nn.ops",
               "repro_torch.nn.kernels", "repro_torch.nn.blocks", "repro_torch.models.moe",
               "repro_torch.models.ssm", "repro_torch.models.specs"):
    assert needed in mods, needed
# the VM, the targets and the silicon model run too
from repro_torch import targets
from repro_torch.core import cost, engine
engine_mod = engine
from repro_torch.core.machine import MVEConfig
vm_mem, vm_state = engine.compile_program(run.program, mode="vm",
                                          device="cpu").run(run.memory)
run.check(to_numpy(vm_mem), vm_state)
assert len(targets.list_targets()) == 13
art = targets.compile(run.program, target="rvv-1d-timed", device="cpu")
assert art.timeline(art.run(run.memory)[1]).total_cycles > 0
assert cost.EnergyParams.derive(MVEConfig()) == cost.DEFAULT_ENERGY
# the optimizer and the program server run too
from repro_torch import opt
from repro_torch.launch.serve import MVEProgramServer
art = engine.compile_program(run.program, opt_level=opt.MAX_OPT_LEVEL,
                             device="cpu")
run.check(to_numpy(art.run(run.memory)[0]), None)
srv = MVEProgramServer(device="cpu")
req = srv.submit(run.program, run.memory)
srv.run_until_drained()
run.check(req.result.memory, req.result)
# their entry points default to the card: cuda, never the CPU instead
import torch
from repro_torch.runtime import MVEScheduler
for make in (lambda: engine.compile_program(run.program, mode="vm"),
             lambda: targets.compile(run.program, target="neon").cp,
             lambda: MVEScheduler()):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        try:
            make()
        except RuntimeError as err:
            assert "cuda" in str(err)
        else:
            raise AssertionError("a CUDA default ran without a card")
# the LM slice too: prefill (flash route), decode, the serving engine
import dataclasses, torch
from repro_torch.configs import get_config
from repro_torch.launch.serve import ContinuousBatchingEngine, Request
from repro_torch.models import LM
cfg = dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                          num_heads=2, num_kv_heads=1, head_dim=64,
                          d_model=128, num_layers=1)
model = LM(cfg)
params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
tokens = torch.arange(1, 9).reshape(1, 8)
logits, cache = model.prefill(params, {"tokens": tokens,
                                       "positions": tokens - 1})
assert torch.isfinite(logits.float()).all()
engine = ContinuousBatchingEngine(cfg, params, 2, 16, device="cpu")
engine.submit(Request(rid=0, prompt=np.arange(1, 4), max_new_tokens=2))
assert len(engine.run_until_drained()[0].output) == 2
# the nn zoo and the moe / ssm / hybrid / vlm / encdec families too, and
# a vlm / encdec prefill from the specs' inputs
from repro_torch.nn import BLOCK_KERNELS, model_blocks
blk = BLOCK_KERNELS["ssm_scan"](n_state=8, d_inner=16)
blk.check(engine_mod.compile_program(blk.program, device="cpu").run(
    blk.memory)[0])
assert len(model_blocks(quick=True)) == 7
for arch in ("llama4-scout-17b-a16e", "mamba2-2.7b", "zamba2-2.7b",
             "llama-3.2-vision-11b", "whisper-base"):
    cfg = dataclasses.replace(get_config(arch, reduced=True), num_layers=2)
    model = LM(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    eng = ContinuousBatchingEngine(cfg, params, 2, 16, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(1, 4), max_new_tokens=2))
    assert len(eng.run_until_drained()[0].output) == 2
    if cfg.family in ("vlm", "encdec"):
        from repro_torch.configs import ShapeCell
        from repro_torch.models.specs import prefill_batch_specs
        specs, _ = prefill_batch_specs(cfg, ShapeCell("p", 4, 1, "prefill"))
        batch = {n: torch.randn(d.shape).to(d.dtype)
                 for n, d in specs.items() if d.dtype == torch.bfloat16}
        batch.update(tokens=tokens[:, :4], positions=tokens[:, :4] - 1)
        logits, cache = model.prefill(params, batch)
        assert torch.isfinite(logits.float()).all() and "cross_k" in cache
assert not _build._LIBS
assert not any(m == "jax" or m.startswith("jax.") or m == "repro"
               or m.startswith("repro.") for m in sys.modules
               if sys.modules[m] is not None)
print("OK", len(mods), len(state.trace))
"""


def _run(pattern):
    import time
    script = _SCRIPT.replace("START", repr(time.time())).replace(
        "{pattern}", pattern)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_runs_without_jax_or_the_reference_package():
    proc = _run("daxpy")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_port_sources_name_neither_package():
    """No module of the port (nor the on-card smoke script) imports
    ``jax`` or anything of ``repro``."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    files += list((SRC.parent / "benchmarks").glob("torch_*.py"))
    files += list((SRC.parent / "examples").glob("*_torch.py"))
    assert len(files) > 30
    for path in files:
        assert not pat.search(path.read_text()), path
