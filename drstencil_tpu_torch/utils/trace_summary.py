"""Per-kernel device metrics of a captured ``torch.profiler`` trace — the port
of ``drstencil_tpu/utils/trace_summary.py``.

Given a trace directory written by ``utils.profiling.maybe_trace`` (or
``tuning/capture_trace.py``), parse the Chrome trace (``trace.json``, as
``maybe_trace`` names it, or ``*.trace.json``, either gzipped) and aggregate
the card's timeline into per-kernel rows (count, total/mean device ms).
The card's events are told apart by their Kineto category (``kernel``,
``gpu_memcpy``, ``gpu_memset``), and a row's ``thread`` is the CUDA
stream's name from the trace's ``thread_name`` metadata.

Library: ``summarize(trace_dir) -> list[Row]``, ``busy_share(trace_dir)``.
CLI: ``python -m drstencil_tpu_torch.utils.trace_summary <trace_dir>
[out.csv]`` prints the table and optionally appends CSV rows
(deviceMetrics.csv, the reference's gpuMetrics.csv analogue).
"""

from __future__ import annotations

import csv
import glob
import gzip
import json
import os
from dataclasses import dataclass

# Kineto categories of the work the card itself runs
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the names a trace file may have, newest first among the matches
TRACE_PATTERNS = ("trace.json", "trace.json.gz", "*.trace.json",
                  "*.trace.json.gz")


@dataclass(frozen=True)
class Row:
    name: str        # kernel (or copy / set) name on the card's timeline
    thread: str      # the CUDA stream's name, e.g. 'stream 7'
    count: int
    total_ms: float

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0


def _find_trace_json(trace_dir: str) -> str:
    hits = {p for pat in TRACE_PATTERNS
            for p in glob.glob(os.path.join(trace_dir, "**", pat),
                               recursive=True)}
    if not hits:
        raise FileNotFoundError(
            f"no trace.json or *.trace.json(.gz) under {trace_dir} — was the "
            "trace captured? (see trace_error.txt if present)")
    return max(hits, key=os.path.getmtime)


def load_events(trace_dir: str) -> list:
    """The ``traceEvents`` of the newest trace under ``trace_dir``."""
    path = _find_trace_json(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def is_device_event(e: dict) -> bool:
    return e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES


def summarize(trace_dir: str, device_only: bool = True) -> list[Row]:
    """Aggregate complete ('X') events by (thread, name).

    ``device_only`` keeps the card's events (:data:`DEVICE_CATEGORIES`);
    the host rows are every operator and runtime call the Python side
    made, and rarely what a kernel investigation needs."""
    events = load_events(trace_dir)
    thread_names = {(e.get("pid"), e.get("tid")): e["args"].get("name", "")
                    for e in events
                    if e.get("ph") == "M" and e.get("name") == "thread_name"}
    agg: dict = {}
    for e in events:
        if e.get("ph") != "X" or (device_only and not is_device_event(e)):
            continue
        key = (thread_names.get((e.get("pid"), e.get("tid")),
                                str(e.get("tid"))), e.get("name", "?"))
        n, tot = agg.get(key, (0, 0.0))
        agg[key] = (n + 1, tot + e.get("dur", 0) / 1e3)
    rows = [Row(name=k[1], thread=k[0], count=n, total_ms=tot)
            for k, (n, tot) in agg.items()]
    rows.sort(key=lambda r: -r.total_ms)
    return rows


def busy_share(trace_dir: str) -> dict:
    """The card's kernel events and its busy share over their span: kernel
    µs over (end of the last kernel - start of the first)."""
    ks = [e for e in load_events(trace_dir)
          if is_device_event(e) and e.get("cat") == "kernel"]
    if not ks:
        return {"kernel_events": 0}
    span = max(e["ts"] + e["dur"] for e in ks) - min(e["ts"] for e in ks)
    busy = sum(e["dur"] for e in ks)
    names = sorted({e.get("name", "")[:60] for e in ks})
    return {"kernel_events": len(ks), "kernel_us": busy, "span_us": span,
            "busy_share": busy / span if span else None, "names": names[:8]}


def write_csv(rows: list[Row], path: str, label: str = "") -> None:
    """Append rows to a deviceMetrics.csv (gpuMetrics.csv analogue)."""
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["label", "thread", "kernel",
                        "count", "total_ms", "mean_ms"])
        for r in rows:
            w.writerow([label, r.thread, r.name, r.count,
                        round(r.total_ms, 4), round(r.mean_ms, 4)])


def print_table(rows: list[Row], top: int = 20) -> None:
    print(f"{'thread':<14} {'kernel':<44} {'n':>4} "
          f"{'total ms':>10} {'mean ms':>9}")
    for r in rows[:top]:
        print(f"{r.thread:<14.14} {r.name:<44.44} {r.count:>4} "
              f"{r.total_ms:>10.3f} {r.mean_ms:>9.4f}")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="summarize a torch.profiler trace's device timeline")
    ap.add_argument("trace_dir")
    ap.add_argument("out_csv", nargs="?", default=None)
    ap.add_argument("--label", default="",
                    help="CSV row label (config); defaults to the trace "
                    "directory's basename")
    ap.add_argument("--all", action="store_true",
                    help="include host events, not just the card's")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    rows = summarize(args.trace_dir, device_only=not args.all)
    print_table(rows, args.top)
    if args.out_csv:
        label = args.label or os.path.basename(
            os.path.normpath(args.trace_dir))
        write_csv(rows, args.out_csv, label=label)
        print(f"appended {len(rows)} rows to {args.out_csv}")


if __name__ == "__main__":
    main()
