"""One client in a closed loop: a request is issued once the previous one
has been issued (``readback: false``, back to back on the card's queue) or
has returned its result (``readback: true``). A request resets the state
from the field, solves, and returns the result where the mix asks."""

from __future__ import annotations

import contextlib
import math
import time

from stencilbench.harness import Window


def run(bench, mix: dict, seconds: float = math.inf, requests=None,
        first: int = 0, span=None) -> Window:
    """Issue requests until ``seconds`` have passed on the host clock (at
    least one), or ``requests`` of them; then wait for the card. ``span(name)`` wraps each
    step of a request (the traced slice gives the profiler's)."""
    span = span or (lambda name: contextlib.nullcontext())
    readback = mix["readback"]
    latencies = []
    n = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while (n < requests) if requests is not None else (
            n == 0 or time.perf_counter() < deadline):
        ts = time.perf_counter()
        with span("stencilbench.reset"):
            bench.reset()
        with span("stencilbench.solve"):
            bench.solve()
        out = None
        if readback:
            with span("stencilbench.readback"):
                out = bench.readback()
            latencies.append(time.perf_counter() - ts)
        bench.answered(first + n, out)
        n += 1
    bench.sync()
    return Window(requests=n, wall_s=time.perf_counter() - t0,
                  latencies=latencies)
