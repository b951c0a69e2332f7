"""Share of the slice's wall time, in percent, in which no kernel runs on a
card, averaged over the cards the run used (each card's own idle share, so
a card idles while another one runs). Copies (the reset, the readback, the
halo exchange) count as idle here; they show in the breakdown's device
operations."""

from stencilbench.trace import union_us


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.t1 <= sl.t0:
        return None
    idle = [100.0 * (1.0 - union_us(kernels) / (sl.t1 - sl.t0))
            for kernels in sl.per_card(("kernel",))]
    return sum(idle) / len(idle)
