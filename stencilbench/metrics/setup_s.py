"""Seconds from the process's start to the window's: imports, the plan's
build or cache hit, the field made on the card, one warm-up request."""


def read(ctx):
    return ctx.setup_s
