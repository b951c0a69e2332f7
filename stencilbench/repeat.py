"""Run one cell several times, each run its own process, and sum up the
spread of each metric: the tool that sets and checks the bounds.

    python3 -m stencilbench.repeat --workload <cell> --seeds 1,2,3 \\
        --seconds 20 [--trace 0] [--out runs.jsonl]

Runs ``python3 -m stencilbench.run`` once per seed, in turn, and appends one
JSON line per run to ``--out`` (the seed, the exit code, the result line and
the end of standard error). Then prints, for each metric, its median and
three spreads, each a share of the median:

- ``spread``: the distance between the first and third quartile of
  ``statistics.quantiles(values, n=4)``;
- ``spread_trim``: the same with the run farthest from the median left
  out, as a bound's tightness is judged;
- ``range``: the highest run less the lowest.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def spread_trim(values) -> float:
    """``spread`` without the run farthest from the median."""
    med = statistics.median(values)
    rest = sorted(values, key=lambda v: abs(v - med))[:-1]
    return spread(rest)


def value_range(values) -> float:
    return (max(values) - min(values)) / statistics.median(values)


def run_one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "stencilbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace,
            "rc": proc.returncode, "process_s": time.perf_counter() - t0,
            "card": lines[-2] if len(lines) > 1 else None,
            "result": result, "stderr": proc.stderr[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m stencilbench.repeat")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    values: dict = {}
    bad = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        run = run_one(args.workload, seed, args.seconds, args.trace)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(run) + "\n")
        res = run["result"] or {}
        ok = run["rc"] == 0 and res.get("correct") is True
        bad += not ok
        print(f"seed {seed}: rc {run['rc']} correct {res.get('correct')} "
              f"checks {res.get('checks')} "
              f"{run['process_s']:.1f} s", flush=True)
        if not ok:
            print(run["stderr"][-1500:], flush=True)
        for name, m in res.get("metrics", {}).items():
            values.setdefault(name, []).append(m["value"])
            print(f"  {name} {m['value']!r}", flush=True)
    for name, vals in values.items():
        line = f"{name}: n {len(vals)} median {statistics.median(vals)!r}"
        if len(vals) >= 3:
            line += (f" spread {spread(vals)!r} spread_trim "
                     f"{spread_trim(vals)!r} range {value_range(vals)!r}")
        print(line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
