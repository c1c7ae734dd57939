"""Run one cell of ``BENCHMARK.json`` once on this machine's card(s).

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints one JSON line as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``; ``checks`` last: each
number that decides ``correct`` beside its limit), and the checks again as
the last lines of standard error. Exits non-zero, printing no result, when
the machine has fewer CUDA cards than the cell asks for, or when JAX or the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from benchmark import isolation, registry

def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = registry.load_benchmark()
    cell = registry.workload(bench, args.workload)
    # one process with few threads: no OpenMP pool spinning beside the
    # host's work (nothing on the measured paths runs CPU ops in parallel)
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark import context

    ctx = context.make(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0))
    registry.driver(ctx.traffic["kind"]).run(ctx)
    leaked = isolation.forbidden_loaded()
    if leaked:
        print(f"forbidden modules loaded in the measuring process: {leaked}", file=sys.stderr)
        return 3
    out = context.result(ctx)
    print(json.dumps(out), flush=True)
    for c in ctx.checks:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
