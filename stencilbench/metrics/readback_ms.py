"""Mean host milliseconds of the slice's ``final_a`` calls, from the
harness's own span around each; only a mix that returns results has them."""


def read(ctx):
    sl = ctx.slice
    spans = sl.spans("stencilbench.readback") if sl is not None else []
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
