"""Run one cell of ``BENCHMARK.json`` once on the CUDA device.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's inputs and weights from ``--seed``, sets up (kernels
come from ``build/`` inside the checkout after its first run), measures for
``--seconds`` seconds, checks what the timed path produced against the
plain reference, and prints one JSON object as the last line of standard
output; the numbers compared, each beside its limit, are also the last
lines of standard error.  Without a CUDA device, with fewer devices than
the cell asks for, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import harness

EXIT_NO_DEVICE = 3
EXIT_UNKNOWN = 4
EXIT_FORBIDDEN = 5


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(chips: int, outcome) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    if outcome.trace is not None:
        info["busy_s"] = outcome.trace.busy_s
        info["window_s"] = outcome.trace.window_s
    return info


def main(argv=None) -> int:
    started = harness.process_start_time()
    args = parse(argv)
    os.environ.update(harness.cache_environment())
    harness.use_program()
    try:
        cell = harness.find_cell(args.workload)
        readers = harness.metric_readers(cell) if args.trace else {}
    except harness.UnknownName as e:
        print(f"portbench: {e}", file=sys.stderr)
        return EXIT_UNKNOWN
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return EXIT_NO_DEVICE
    outcome = cell.loop.run(cell, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), device=torch.device("cuda"),
                            started=started)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: modules loaded that the port may not use: "
              f"{', '.join(loaded)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    line, lines = harness.result_line(
        cell, outcome, bool(args.trace), readers,
        device_info(chips, outcome))
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
