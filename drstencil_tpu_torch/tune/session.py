"""Tuning sessions — the port of ``drstencil_tpu/tune/session.py``.

Runs the autotuner over every benchmark stencil, appends the session's
wall time to ``tuning-time.log``, merges the per-config metric rows into
one ``gpuMetrics.csv`` table, and takes one ``torch.profiler`` trace of
the first stencil's best config (``utils/profiling.maybe_trace``).

``python -m drstencil_tpu_torch.tune.session --out-dir tuning_gpu``
"""

from __future__ import annotations

import csv
import os
import time
from typing import List, Optional

from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.tune.tuner import Tuner

ALL = [
    "2d5pt_star", "2d5pt_cross", "2d9pt_star", "2d9pt_cross",
    "2d9pt_box", "2d25pt_box", "3d7pt_star", "3d9pt_cross",
]


def aggregate_metrics(out_dir: str, dest: Optional[str] = None) -> str:
    """Merge ``metrics.csv`` rows into the session-wide table.

    ``metrics.csv`` is an append-log that re-emits its header on a schema
    change; rows are merged under the union of all schemas seen."""
    dest = dest or os.path.join(out_dir, "gpuMetrics.csv")
    src = os.path.join(out_dir, "metrics.csv")
    rows: List[dict] = []
    fields: List[str] = []
    if os.path.exists(src):
        header = None
        with open(src) as f:
            for rec in csv.reader(f):
                if not rec:
                    continue
                if rec[0] == "stencil":
                    header = rec
                    fields += [c for c in rec if c not in fields]
                    continue
                if header:
                    rows.append(dict(zip(header, rec)))
    if rows:
        with open(dest, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, restval="")
            w.writeheader()
            w.writerows(rows)
    return dest


def run_session(bench_dir: str, out_dir: str,
                budget_per_stencil: float = 600.0,
                max_configs: Optional[int] = None, stencils=None, log=print,
                trace: bool = False, device=None):
    """Sweep each stencil on ``device`` (``None`` = CUDA); returns
    name -> ``SweepResult``."""
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    results = {}
    names = list(stencils or ALL)
    for name in names:
        spec = load_stc(os.path.join(bench_dir, name + ".stc"))
        tuner = Tuner(spec, out_dir, time_budget_s=budget_per_stencil,
                      device=device)
        res = tuner.sweep(max_configs=max_configs, log=log)
        results[name] = res
        log(f"[{name}] best: "
            f"{res.best_cfg.label() if res.best_cfg else 'none'} "
            f"{res.best_ms:.3f} ms/step")
    aggregate_metrics(out_dir)
    if trace:
        session_trace(bench_dir, out_dir, names[0], log, device)
    with open(os.path.join(out_dir, "tuning-time.log"), "a") as f:
        f.write(f"session: {time.time() - t0:.0f} s\n")
    return results


def session_trace(bench_dir: str, out_dir: str, name: str, log=print,
                  device=None) -> Optional[str]:
    """One profiler trace of ``name``'s best config (two timed pairs) into
    ``out_dir/trace``; returns the directory, or None where the trace
    failed, an empty trace of the card included (soft: tracing never kills
    a session)."""
    from drstencil_tpu_torch.ops.runner import StencilProgram
    from drstencil_tpu_torch.tune import tuned as tuned_mod
    from drstencil_tpu_torch.utils.profiling import (TRACE_ERROR,
                                                     maybe_trace,
                                                     trace_failed)

    trace_dir = os.path.join(out_dir, "trace")
    try:
        spec = load_stc(os.path.join(bench_dir, name + ".stc"))
        prog = StencilProgram(spec, tuned_mod.best_config(name), device)
        with maybe_trace(trace_dir) as active:
            prog.time(pairs=2, warmup_pairs=1, repeats=1)
    except Exception as e:  # soft: tracing must never kill a session
        log(f"session trace skipped: {str(e)[:200]}")
        return None
    if active and not trace_failed(trace_dir):
        log(f"profiler trace written to {trace_dir}")
        return trace_dir
    if active:
        log(f"session trace failed: see {trace_dir}/{TRACE_ERROR}")
    return None


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="tune all benchmark stencils")
    ap.add_argument("--bench-dir", default="benchmarks")
    ap.add_argument("--out-dir", default="tuning_gpu")
    ap.add_argument("--budget", type=float, default=600.0)
    ap.add_argument("--max-configs", type=int, default=None)
    ap.add_argument("--stencils", default=None,
                    help="comma-separated subset")
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the once-per-session profiler trace")
    args = ap.parse_args(argv)
    run_session(
        args.bench_dir, args.out_dir, budget_per_stencil=args.budget,
        max_configs=args.max_configs,
        stencils=args.stencils.split(",") if args.stencils else None,
        trace=not args.no_trace,
    )


if __name__ == "__main__":
    main()
