"""The least time of the slice's requested work over the device time of the
kernels that ran in it, in percent. The work is counted from the `.stc`
table and the grid alone (``work.Work``): (2 taps - 1) flops per cell per
requested timestep, one read of the field and one write of the result per
request; the least time is the larger of the two at one card's data-sheet
peaks. Every kernel of the slice counts: the reset and the readback are
copies, so in these mixes only the stencil kernels run. On several cards the
kernels' time is summed over them, so the whole grid's work at one card's
peaks over it is each card's share of its own roofline, averaged."""


def read(ctx):
    sl = ctx.slice
    if sl is None or ctx.peaks is None:
        return None
    kernel_s = sum(b - a for a, b, _ in sl.kernels()) / 1e6
    if kernel_s <= 0:
        return None
    return 100.0 * sl.requests * ctx.work.least_seconds(ctx.peaks) / kernel_s
