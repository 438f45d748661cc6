"""Multi-tenant MVE program serving on the PyTorch/CUDA port (the twin of
``examples/serve_programs.py``).

Replays a mixed Section-IV pattern stream — concurrent tenants submitting
recurring *and* data-dependent programs — through the signature-batched
scheduler behind ``MVEProgramServer``, and prints the tier and batching
decisions, throughput against sequential execution, the host waits per
drain cycle, and the shared compile-cache state.  Results come back to
the host as NumPy arrays.

    PYTHONPATH=src python examples/serve_programs_torch.py --device cpu
    PYTHONPATH=src python examples/serve_programs_torch.py           # cuda
"""
import argparse
import time

import numpy as np

from repro_torch.core import MVEConfig, compile_program
from repro_torch.core.machine import resolve_device, to_numpy
from repro_torch.core.patterns import PATTERNS
from repro_torch.launch.serve import MVEProgramServer

MIX = [("daxpy", 4), ("gemm", 3), ("alpha_blend", 3), ("memcpy", 3),
       ("spmm", 3), ("fir", 2)]          # spmm/fir: a new program per seed


def build_stream():
    stream = []
    for name, count in MIX:
        for i in range(count):
            stream.append((name, PATTERNS[name](seed=i + 1)))
    return stream


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where to run: cuda (default) or cpu")
    device = resolve_device(ap.parse_args().device)
    cfg = MVEConfig()
    stream = build_stream()
    print(f"stream: {len(stream)} requests over {len(MIX)} pattern "
          f"families (spmm/fir arrive as fresh programs per request), "
          f"on {device}")

    server = MVEProgramServer(cfg=cfg, promote_after=2, max_batch=16,
                              device=device)
    print("\n== replay 1: cold — VM tier ==")
    t0 = time.perf_counter()
    for _, r in stream:
        # frontend kernels submit directly — named operands, no flat
        # memory image at the call site
        server.submit(r.kernel)
    done = server.run_until_drained()
    print(f"served {len(done)} requests in "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms")

    print("\n== replay 2-3: hot programs promoted to fused batches ==")
    sched = server.scheduler
    for _ in range(2):
        for _, r in stream:
            server.submit(r.kernel)
        syncs, drains = sched.host_syncs, sched.stats.drains
        t0 = time.perf_counter()
        server.run_until_drained()
        wall = time.perf_counter() - t0
    print(f"steady replay: {wall * 1e3:.0f} ms "
          f"({len(stream) / wall:.0f} req/s), "
          f"{(sched.host_syncs - syncs) / (sched.stats.drains - drains):.0f}"
          f" host wait(s) per drain cycle")
    lat = server.latency_stats(last=len(stream))
    print(f"latency p50={lat['p50'] * 1e3:.1f} ms "
          f"p95={lat['p95'] * 1e3:.1f} ms")

    st = sched.stats
    print(f"\nscheduler: {st.requests} requests in {st.dispatches} "
          f"dispatches (batch efficiency {st.batch_efficiency:.1f}x), "
          f"{st.promotions} programs promoted, {st.demotions} demotions, "
          f"{st.signature_buckets} signature buckets")
    print(f"shared caches: {sched.cache_info()}")

    # sequential baseline + bit-exactness spot check
    cps = [compile_program(r.program, cfg, device=device) for _, r in stream]
    for cp, (_, r) in zip(cps, stream):
        to_numpy(cp.run(r.memory)[0])
    t0 = time.perf_counter()
    seq = [to_numpy(cp.run(r.memory)[0]) for cp, (_, r) in zip(cps, stream)]
    seq_wall = time.perf_counter() - t0
    print(f"\nsequential per-request run(): {seq_wall * 1e3:.0f} ms "
          f"-> scheduler speedup {seq_wall / wall:.1f}x")
    first_replay = sorted(done.items())[:len(stream)]
    for (rid, req), mem in zip(first_replay, seq):
        np.testing.assert_array_equal(mem.view(np.uint32),
                                      req.result.memory.view(np.uint32))
    print("results bit-identical to per-request execution")
    first = done[min(done)]
    name, arr = next(iter(first.result.operands.items()))
    print(f"named results: request 0 operand {name!r} shape "
          f"{arr.shape} read back by name")
    sched.close()


if __name__ == "__main__":
    main()
