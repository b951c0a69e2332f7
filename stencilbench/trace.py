"""The traced slice: one ``torch.profiler`` session over a bounded run of
requests after the measured window, and what its trace holds.

The slice is the host span ``stencilbench.slice`` around the loop and its
final synchronize; every reading is clipped to it. Device operations are the
trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; the harness's
own spans (``stencilbench.reset``, ``.solve``, ``.readback``) are its
``user_annotation`` events. A device operation's card is its ``args.device``
(its ``pid`` where that is missing); busy time and idle gaps are taken card
by card, so a card counts as idle while another one runs. The trace is
written under the temporary directory and removed once read. A process
holds one session only: a second one recorded no device event on the card.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
from collections import defaultdict
from dataclasses import dataclass

SLICE = "stencilbench.slice"
SPAN_PREFIX = "stencilbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


def _interval(event, t0, t1):
    a, b = event["ts"], event["ts"] + event["dur"]
    return max(a, t0), min(b, t1)


def union_us(intervals) -> float:
    """Length covered by the union of ``(start, end)`` intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def card_of(event):
    """The card a device event ran on."""
    return (event.get("args") or {}).get("device", event.get("pid"))


@dataclass
class Slice:
    """A traced slice: its events, its span ``[t0, t1)`` in the trace's
    microseconds, the requests it ran and the cards the run used."""

    events: list
    t0: float
    t1: float
    requests: int
    cards: int = 1

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _clipped(self, cats, by_card=False):
        out = []
        for e in self.events:
            if e.get("cat") in cats and "dur" in e:
                a, b = _interval(e, self.t0, self.t1)
                if b > a:
                    out.append((a, b, card_of(e) if by_card else e["name"]))
        return out

    def device_ops(self):
        """``(start, end, name)`` of every device operation in the slice."""
        return self._clipped(DEVICE_CATS)

    def kernels(self):
        return self._clipped(("kernel",))

    def copies(self):
        return self._clipped(("gpu_memcpy",))

    def per_card(self, cats=DEVICE_CATS) -> list:
        """``(start, end)`` intervals of the operations of ``cats``, one
        list a card: ``cards`` lists at least, cards with none empty."""
        cards = defaultdict(list)
        for a, b, card in self._clipped(cats, by_card=True):
            cards[card].append((a, b))
        lists = list(cards.values())
        return lists + [[] for _ in range(self.cards - len(lists))]

    def spans(self, name: str):
        """Durations in seconds of the harness's spans named ``name``."""
        return [e["dur"] / 1e6 for e in self.events
                if e.get("cat") == "user_annotation" and e["name"] == name
                and self.t0 <= e["ts"] <= self.t1]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on a card, averaged over the
        cards."""
        busy = [union_us(ops) for ops in self.per_card()]
        return sum(busy) / len(busy) / 1e6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing when each began, both summed
        over the cards."""
        ops = defaultdict(float)
        for a, b, name in self.device_ops():
            ops[name] += (b - a) / 1e6
        host = self._host_events()
        gaps = defaultdict(lambda: [0.0, 0])
        for a, b in self._gaps():
            label = gaps[_host_at(host, a)]
            label[0] += (b - a) / 1e6
            label[1] += 1
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {"device_ops": [[n, s] for n, s in top_ops],
                "idle_gaps": [[f"{n} ({c} gaps)", s]
                              for n, (s, c) in top_gaps]}

    def _gaps(self):
        """Each card's stretches with no operation running on it."""
        for ops in self.per_card():
            end = self.t0
            for a, b in sorted(ops):
                if a > end:
                    yield end, a
                end = max(end, b)
            if self.t1 > end:
                yield end, self.t1

    def _host_events(self):
        """``(start, end, name)`` of the harness's spans and of the host's
        operations, each list sorted."""
        spans, ops = [], []
        for e in self.events:
            if "dur" not in e:
                continue
            item = (e["ts"], e["ts"] + e["dur"], e["name"])
            if (e.get("cat") == "user_annotation"
                    and e["name"].startswith(SPAN_PREFIX)
                    and e["name"] != SLICE):
                spans.append(item)
            elif e.get("cat") in HOST_CATS:
                ops.append(item)
        return sorted(spans), sorted(ops)


def _host_at(host, t: float) -> str:
    """The innermost harness span and host operation running at ``t``: the
    latest to start of those that contain it, among the 64 before ``t``."""
    names = []
    for group in host:
        i = bisect.bisect_right(group, (t, float("inf"), ""))
        found = "python"
        for a, b, name in reversed(group[max(0, i - 64):i]):
            if a <= t < b:
                found = name
                break
        names.append(found)
    span, op = names
    if span == "python":
        return f"outside spans: {op}"
    return f"{span[len(SPAN_PREFIX):]}: {op}"


def read_slice(path: str, requests: int, cards: int = 1) -> Slice:
    """The slice of the chrome trace at ``path``, of a run on ``cards``
    cards."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == SLICE]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} '{SLICE}' spans")
    t0 = spans[0]["ts"]
    sl = Slice(events=events, t0=t0, t1=t0 + spans[0]["dur"],
               requests=requests, cards=cards)
    if not sl.device_ops():
        raise RuntimeError("the trace holds no device operation in the "
                           "slice: the profiler recorded no CUDA activity")
    return sl


def traced_slice(bench, driver, mix: dict, first: int) -> Slice:
    """Run ``mix["trace_requests"]`` requests under one profiler session and
    read its trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tmp = tempfile.mkdtemp(prefix="stencilbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(SLICE):
                run = driver.run(bench, mix, requests=mix["trace_requests"],
                                 first=first, span=record_function)
        prof.export_chrome_trace(path)
        return read_slice(path, run.requests, len(bench.devices))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
