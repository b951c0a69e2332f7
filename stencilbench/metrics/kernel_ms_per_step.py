"""Device milliseconds of the slice's kernels per card per timestep they
computed (``pairs x 2 x step`` per request, at least the requested ones):
the kernels' time summed over the cards, over the cards the run used."""


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.requests == 0:
        return None
    kernels = sl.kernels()
    if not kernels:
        return None
    kernel_ms = sum(b - a for a, b, _ in kernels) / 1e3
    return kernel_ms / sl.cards / (sl.requests * ctx.work.computed_timesteps)
