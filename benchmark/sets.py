"""Run one cell several times, one process a run, and print the spread of
each metric: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median.

    python3 -m benchmark.sets --workload <name> --seeds 11,12,13 --seconds 45 \\
        [--trace 0|1] [--out <file.jsonl>]

Each run is ``python3 -m benchmark.run`` with one seed; its result line,
exit code and the end of its standard error are appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values: list[float]) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("nan")


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    result = None
    if p.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"workload": workload, "seed": seed, "trace": trace, "rc": p.returncode,
            "wall_s": time.perf_counter() - t0, "result": result, "stderr": p.stderr[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = one_run(args.workload, seed, args.seconds, args.trace)
        runs.append(run)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(run) + "\n")
        res = run["result"] or {}
        print(json.dumps({"seed": seed, "rc": run["rc"], "wall_s": round(run["wall_s"], 1),
                          "correct": res.get("correct"),
                          "metrics": {k: v["value"] for k, v in res.get("metrics", {}).items()},
                          "checks": res.get("checks"), "info": res.get("info")}), flush=True)
        if run["rc"] != 0:
            print(run["stderr"], file=sys.stderr, flush=True)
    ok = [r["result"] for r in runs if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    summary = {}
    for k in names:
        vals = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
        summary[k] = {"median": statistics.median(vals), "values": vals,
                      "spread": spread(vals) if len(vals) >= 2 else None}
    print(json.dumps({"workload": args.workload, "runs": len(runs), "ok": len(ok),
                      "correct": sum(bool(r["correct"]) for r in ok), "summary": summary}),
          flush=True)
    return 0 if len(ok) == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
