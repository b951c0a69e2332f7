"""Share of the slice's wall time, in percent, in which no kernel runs on
the card. Copies (the reset, the readback) count as idle here; they show in
the breakdown's device operations."""

from stencilbench.trace import union_us


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.t1 <= sl.t0:
        return None
    busy = union_us((a, b) for a, b, _ in sl.kernels())
    return 100.0 * (1.0 - busy / (sl.t1 - sl.t0))
