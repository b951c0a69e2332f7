"""95th percentile over all requests of the window of the time from a
request's reset being issued to its result being in host memory; only a mix
whose requests return their result has one."""

import statistics


def read(ctx):
    lat = ctx.window.latencies if ctx.window is not None else []
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
