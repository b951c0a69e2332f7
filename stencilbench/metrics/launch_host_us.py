"""Median host microseconds of the port's own work per application in the
slice: each span ``drstencil.apply <kernel> <plan>`` (``ops/stream``'s apply:
its checks, the wrapper's checks and plan lookup, device and stream, the
ctypes call) less the part of it that CUDA runtime and driver calls on its
thread cover, so that a launch blocked on a full queue, and
``cudaFuncSetAttribute``, count for nothing. The median, since the host's
jitter puts a long tail on single applications. It includes the profiler's
own cost of recording the span and its runtime calls. None where the
program records no such span."""

import bisect
import statistics
from collections import defaultdict

from stencilbench.trace import union_us

# the program's apply spans, matched by this prefix of their name
SPAN = "drstencil.apply "
CALLS = ("cuda_runtime", "cuda_driver")


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    spans, calls = [], defaultdict(list)
    for e in sl.events:
        if "dur" not in e:
            continue
        cat = e.get("cat")
        if (cat == "user_annotation" and e["name"].startswith(SPAN)
                and sl.t0 <= e["ts"] <= sl.t1):
            spans.append(e)
        elif cat in CALLS:
            calls[(e.get("pid"), e.get("tid"))].append(
                (e["ts"], e["ts"] + e["dur"]))
    if not spans:
        return None
    for group in calls.values():
        group.sort()
    self_us = []
    for e in spans:
        a, b = e["ts"], e["ts"] + e["dur"]
        group = calls.get((e.get("pid"), e.get("tid")), [])
        i = bisect.bisect_left(group, (a, -float("inf")))
        inside = []
        while i < len(group) and group[i][0] < b:
            inside.append((group[i][0], min(group[i][1], b)))
            i += 1
        self_us.append((b - a) - union_us(inside))
    return statistics.median(self_us)
