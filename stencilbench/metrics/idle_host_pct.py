"""Share of the slice's wall time, in percent, in which no device operation
runs (kernel, copy, memset) while the program's host path has not yet
finished issuing the operation that ends the stretch: the device waits for
the port's own host side.

Each operation is matched to the runtime or driver call that issued it by
the trace's ``args.correlation``. An operation is the program's when that
call lies in a ``drstencil.run_pairs`` span on its thread. A stretch ended
by such an operation counts when the call had not returned by the
stretch's start, from the later of that start and the span's: before the
span the host was in the caller's code. The device's own stretches (their
operation issued before they began), stretches ended by the caller's
operations (the harness's reset copy), the slice's opening stretch before
any of them, and its closing stretch, which no operation ends, do not
count. None where the trace holds no such span."""

import bisect
from collections import defaultdict

# the program's span around each StencilProgram.run_pairs call
SPAN = "drstencil.run_pairs"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
CALLS = ("cuda_runtime", "cuda_driver")


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.t1 <= sl.t0:
        return None
    runs, issued, ops = defaultdict(list), {}, []
    for e in sl.events:
        if "dur" not in e:
            continue
        a, b, cat = e["ts"], e["ts"] + e["dur"], e.get("cat")
        thread = (e.get("pid"), e.get("tid"))
        if cat == "user_annotation" and e.get("name") == SPAN:
            runs[thread].append((a, b))
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        if cat in CALLS:
            # the outermost call of a correlation: its first start, last end
            s, t, _ = issued.get(corr, (a, b, thread))
            issued[corr] = (min(a, s), max(b, t), thread)
        elif cat in DEVICE:
            a, b = max(a, sl.t0), min(b, sl.t1)
            if b > a:
                ops.append((a, b, corr))
    if not runs:
        return None
    for group in runs.values():
        group.sort()

    def run_of(call):
        """The start of the run_pairs span holding ``call``, or None."""
        s, t, thread = call
        group = runs.get(thread, [])
        i = bisect.bisect_right(group, (s, float("inf"))) - 1
        if i >= 0 and group[i][0] <= s and t <= group[i][1]:
            return group[i][0]
        return None

    host_us, end = 0.0, sl.t0
    for a, b, corr in sorted(ops):
        call = issued.get(corr)
        if a > end and call is not None and call[1] > end:
            start = run_of(call)
            if start is not None:
                host_us += max(0.0, a - max(end, start))
        end = max(end, b)
    return 100.0 * host_us / (sl.t1 - sl.t0)
