"""Take ONE ``torch.profiler`` trace of a stencil program on the card — the
port of ``tuning/capture_trace.py``.

Writes ``build/trace/<subdir>/`` (``trace.json``, ``kernels.txt``, or
``trace_error.txt`` with the failing traceback) and prints a one-line
verdict, then ``utils/trace_summary``'s table of the card's timeline, then
as its last line one JSON object: the config's label, the trace directory,
the kernel launches the wrappers counted in the traced window, the
table's rows and ``trace_summary.busy_share``.  The traced window is
``time(pairs=2, warmup_pairs=1, repeats=1)``: one warmup pair and two
timed pairs, six kernel launches.

    python -m drstencil_tpu_torch.tuning.capture_trace [stencil] [subdir]

With a stencil argument the TUNED winner (``tune/tuned.best_config``) is
traced; the default traces a plain step-1 2d5pt_star.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import sys

from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.tune.tuned import BENCH_DIR, best_config
from drstencil_tpu_torch.utils import trace_summary
from drstencil_tpu_torch.utils.profiling import maybe_trace

TRACE_ROOT = os.path.join(kernels.BUILD_DIR, "trace")
# the traced window: warmup pairs, timed pairs, repeats of StencilProgram.time
WARMUP_PAIRS, PAIRS, REPEATS = 1, 2, 1


def capture(name: str | None = None, sub: str = "trace") -> dict:
    """Trace ``name``'s winner (or the plain step-1 2d5pt_star) into
    ``TRACE_ROOT/sub``, emptied first.  Returns the directory, whether the
    profiler ran, the artifacts written, the config's label and the kernel
    launches the wrappers counted in the traced window."""
    trace_dir = os.path.join(TRACE_ROOT, sub)
    shutil.rmtree(trace_dir, ignore_errors=True)
    if name:
        spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
        cfg = best_config(name)
    else:
        spec = load_stc(os.path.join(BENCH_DIR, "2d5pt_star.stc"))
        cfg = KernelConfig(variant="stream", step=1)
    prog = StencilProgram(spec, cfg)
    kernels.reset_launches()
    with maybe_trace(trace_dir) as active:
        prog.time(pairs=PAIRS, warmup_pairs=WARMUP_PAIRS, repeats=REPEATS)
    return {
        "trace_dir": trace_dir, "active": active,
        "artifacts": sorted(
            p for p in glob.glob(os.path.join(trace_dir, "**"),
                                 recursive=True)
            if os.path.isfile(p) and not p.endswith("trace_error.txt")),
        "label": f"{spec.name}:{cfg.label()}",
        "launches": sum(k.launches for k in kernels.KERNELS),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else None
    sub = argv[1] if len(argv) > 1 else "trace"
    if name:
        print(f"tracing {name} winner: {best_config(name).label()}")
    got = capture(name, sub)
    trace_dir = got["trace_dir"]
    if got["active"] and got["artifacts"]:
        print(f"trace: OK — {len(got['artifacts'])} artifact(s) under "
              f"{trace_dir}; {got['launches']} kernel launches counted in "
              "the traced window")
        for p in got["artifacts"]:
            print("  ", os.path.relpath(p), os.path.getsize(p), "bytes")
    elif got["active"]:
        print(f"trace: profiler context entered but produced NO artifacts "
              f"under {trace_dir}")
        return 1
    else:
        err = os.path.join(trace_dir, "trace_error.txt")
        tail = (open(err).read().splitlines()[-1] if os.path.exists(err)
                else "?")
        print(f"trace: FAILED — {tail} (full traceback in {err})")
        return 1
    rows = trace_summary.summarize(trace_dir)
    trace_summary.print_table(rows)
    print(json.dumps({
        "label": got["label"], "trace_dir": trace_dir,
        "launches": got["launches"],
        "rows": [{"name": r.name, "thread": r.thread, "count": r.count,
                  "total_ms": r.total_ms} for r in rows],
        "busy": trace_summary.busy_share(trace_dir)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
