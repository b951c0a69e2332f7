"""Requested stencil-cell updates per second: cells x requested timesteps x
completed requests over the host-clock seconds of the whole window."""


def read(ctx):
    w = ctx.window
    if w is None or w.requests == 0:
        return None
    return w.requests * ctx.work.cells * ctx.work.timesteps / w.wall_s / 1e9
