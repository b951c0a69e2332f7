"""The per-layer readers and the breakdown, read from a synthetic trace."""

import gzip
import json
import os

import pytest

from stencilbench import cells, harness, trace, work

K = "stencil_kernel(float const*, float*)"
COPY = "Memcpy DtoH (Device -> Pageable)"
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


def synthetic(path):
    """A slice from 1000 to 2000 us: two requests of a reset copy, two
    kernels and a readback copy under the harness's spans."""
    events = [ev("user_annotation", trace.SLICE, 1000, 1000),
              # outside the slice: never counted
              ev("kernel", K, 100, 500), ev("kernel", K, 1990, 50)]
    for t in (1000, 1490):
        events += [
            ev("user_annotation", "stencilbench.reset", t, 10),
            ev("cpu_op", "aten::copy_", t + 1, 8),
            ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", t + 10, 20),
            ev("user_annotation", "stencilbench.solve", t + 10, 20),
            ev("kernel", K, t + 40, 100),
            ev("kernel", K, t + 150, 100),
            ev("user_annotation", "stencilbench.readback", t + 30, 300),
            ev("cuda_runtime", "cudaMemcpyAsync", t + 35, 290),
            ev("gpu_memcpy", COPY, t + 260, 60),
        ]
    events.append({"ph": "f", "cat": "ac2g", "name": "flow", "ts": 1200})
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return trace.read_slice(str(path), requests=2)


def ctx(sl, taps=25, dims=(96, 80), step=3):
    return harness.Context(
        setup_s=1.0, window=None, slice=sl,
        work=work.work_of(dims, taps, 48, step, "float32"),
        peaks=work.card_peaks("NVIDIA H100 80GB HBM3"))


def read(name, c):
    return cells.load_module(cells.ROOT, "metrics", name).read(c)


def test_slice_span_and_device_time(tmp_path):
    sl = synthetic(tmp_path / "t.json")
    assert (sl.t0, sl.t1, sl.window_s) == (1000, 2000, 1e-3)
    # kernels 4 x 100 us plus 10 us of the one that starts at 1990
    assert sum(b - a for a, b, _ in sl.kernels()) == pytest.approx(410)
    # copies 2 x (20 + 60) us, no overlap with kernels
    assert sl.busy_s() == pytest.approx(570e-6)


def test_idle_share_counts_copies_as_idle(tmp_path):
    c = ctx(synthetic(tmp_path / "t.json"))
    assert read("device_idle_pct", c) == pytest.approx(100 * (1 - 0.41))


def test_kernel_ms_per_step_and_roofline(tmp_path):
    c = ctx(synthetic(tmp_path / "t.json"))
    assert read("kernel_ms_per_step", c) == pytest.approx(0.41 / (2 * 48))
    least = 49 * 96 * 80 * 48 / 67e12
    assert read("kernel_roofline_pct", c) == pytest.approx(
        100 * 2 * least / 410e-6)


def test_readback_ms_is_the_mean_span(tmp_path):
    c = ctx(synthetic(tmp_path / "t.json"))
    assert read("readback_ms", c) == pytest.approx(0.3)


def test_readers_find_nothing_without_a_slice():
    c = ctx(None)
    for name in ("device_idle_pct", "kernel_ms_per_step",
                 "kernel_roofline_pct", "readback_ms"):
        assert read(name, c) is None
    c.peaks = None
    assert read("kernel_roofline_pct", c) is None


def test_breakdown(tmp_path):
    b = synthetic(tmp_path / "t.json").breakdown()
    ops = dict(b["device_ops"])
    assert ops[K] == pytest.approx(410e-6)
    assert ops[COPY] == pytest.approx(120e-6)
    assert len(b["device_ops"]) == 3
    gaps = dict(b["idle_gaps"])
    # from the slice's start to the reset's copy: the host in Python
    assert gaps["reset: python (1 gaps)"] == pytest.approx(10e-6)
    # between the reset's copy and the first kernel, each request
    assert gaps["readback: python (2 gaps)"] == pytest.approx(20e-6)
    # between the kernels and the readback copy, and after it up to the
    # next request's copy and the slice's end: the host in the readback call
    assert gaps["readback: cudaMemcpyAsync (6 gaps)"] == pytest.approx(
        400e-6)
    total = sum(s for _, s in b["idle_gaps"])
    assert total == pytest.approx(1e-3 - 570e-6)
    assert len(b["idle_gaps"]) <= trace.TOP


def test_a_trace_without_device_events_is_refused(tmp_path):
    path = tmp_path / "empty.json"
    with open(path, "w") as f:
        json.dump({"traceEvents": [
            ev("user_annotation", trace.SLICE, 0, 100),
            ev("cpu_op", "aten::copy_", 10, 5)]}, f)
    with pytest.raises(RuntimeError, match="no device operation"):
        trace.read_slice(str(path), 1)
    with open(path, "w") as f:
        json.dump({"traceEvents": [ev("kernel", K, 0, 100)]}, f)
    with pytest.raises(RuntimeError, match="0 'stencilbench.slice' spans"):
        trace.read_slice(str(path), 1)


def test_union():
    assert trace.union_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert trace.union_us([]) == 0


PEER = "Memcpy PtoP (Device -> Device)"


def on_card(cat, name, ts, dur, card):
    e = ev(cat, name, ts, dur)
    e.update(pid=card, args={"device": card, "stream": 7})
    return e


def four_cards(path, cards=4):
    """A slice from 0 to 1000 us on four cards, one request: card k runs
    kernels for 100 (k + 1) us; cards 0 to 2 each send two 10 us peer
    copies; card 3 runs no copy."""
    events = [ev("user_annotation", trace.SLICE, 0, 1000)]
    for k in range(4):
        events.append(on_card("kernel", K, 100, 100 * (k + 1), k))
    for k in range(3):
        events += [on_card("gpu_memcpy", PEER, 600 + 20 * k, 10, k),
                   on_card("gpu_memcpy", PEER, 700 + 20 * k, 10, k)]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return trace.read_slice(str(path), requests=1, cards=cards)


def test_readers_per_card_on_four_cards(tmp_path):
    sl = four_cards(tmp_path / "t.json")
    c = ctx(sl, taps=7, dims=(64, 32, 32), step=4)
    # each card's idle share, averaged: (90 + 80 + 70 + 60) / 4
    assert read("device_idle_pct", c) == pytest.approx(75.0)
    # 1000 us of kernels over four cards and 48 computed timesteps
    assert read("kernel_ms_per_step", c) == pytest.approx(1.0 / 4 / 48)
    # the whole grid's work at one card's peaks over the summed kernel time
    least = 13 * 64 * 32 * 32 * 48 / 67e12
    assert read("kernel_roofline_pct", c) == pytest.approx(
        100 * least / 1000e-6)
    # 60 us of peer copies over 12 applications (6 pairs of 2)
    assert read("exchange_ms", c) == pytest.approx(0.06 / 12)
    # busy per card: 120, 220, 320 and 400 us, averaged
    assert sl.busy_s() == pytest.approx(265e-6)
    gaps = sum(s for _, s in sl.breakdown()["idle_gaps"])
    assert gaps == pytest.approx(4 * 1000e-6 - 1060e-6)


def test_a_card_with_nothing_to_run_counts_as_idle(tmp_path):
    sl = four_cards(tmp_path / "t.json", cards=5)
    c = ctx(sl, taps=7, dims=(64, 32, 32), step=4)
    assert read("device_idle_pct", c) == pytest.approx((300 + 100) / 5)
    assert sl.busy_s() == pytest.approx(1060e-6 / 5)


def test_no_peer_copy_no_exchange(tmp_path):
    """One card's reset copies are no exchange."""
    c = ctx(synthetic(tmp_path / "t.json"))
    assert read("exchange_ms", c) is None
    assert read("exchange_ms", ctx(None)) is None


def parent_readers(sl, work, peaks):
    """The one-card readers as they read before the per-card ones: the
    union of every kernel, of every device operation, and of every idle
    gap, over the whole slice."""
    kernels = sum(b - a for a, b, _ in sl.kernels())
    busy = trace.union_us((a, b) for a, b, _ in sl.kernels())
    gaps, end = [], sl.t0
    for a, b in sorted((a, b) for a, b, _ in sl.device_ops()):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if sl.t1 > end:
        gaps.append((end, sl.t1))
    return {"device_idle_pct": 100.0 * (1.0 - busy / (sl.t1 - sl.t0)),
            "kernel_ms_per_step": kernels / 1e3 / (
                sl.requests * work.computed_timesteps),
            "kernel_roofline_pct": 100.0 * sl.requests * work.least_seconds(
                peaks) / (kernels / 1e6),
            "busy_s": trace.union_us(
                (a, b) for a, b, _ in sl.device_ops()) / 1e6,
            "gaps": gaps}


@pytest.mark.parametrize("name", ["2d25pt_box.solve48", "3d7pt_star.solve48"])
def test_one_card_readers_read_as_before_on_a_recorded_trace(tmp_path, name):
    """A traced slice of three requests recorded on an NVIDIA H100 80GB
    HBM3 (``tests/data``): each reader gives the number the one-card
    formula gives, bit for bit, and the number it gave on the card."""
    with gzip.open(os.path.join(DATA, f"{name}.trace.json.gz"), "rt") as f:
        recorded = json.load(f)
    path = tmp_path / "trace.json"
    with open(path, "w") as f:
        json.dump({"traceEvents": recorded["traceEvents"]}, f)
    meta = recorded["meta"]
    sl = trace.read_slice(str(path), meta["requests"])
    work_ = work.Work(**meta["work"])
    c = harness.Context(setup_s=1.0, window=None, slice=sl, work=work_,
                        peaks=work.card_peaks(meta["card"]))
    before = parent_readers(sl, work_, c.peaks)
    for metric in ("device_idle_pct", "kernel_ms_per_step",
                   "kernel_roofline_pct"):
        assert read(metric, c) == before[metric] == meta["readers"][metric]
    assert sl.busy_s() == before["busy_s"] == meta["readers"]["busy_s"]
    assert list(sl._gaps()) == before["gaps"]
    assert read("exchange_ms", c) is None
    assert sl.breakdown() == json.loads(json.dumps(
        meta["readers"]["breakdown"]))


def test_four_card_readers_on_a_recorded_trace(tmp_path):
    """A traced slice of two requests of the sharded bench recorded on four
    NVIDIA H100 80GB HBM3 (``tests/data``; 2000 x 2048 x 2048, 500 planes a
    card): peer copies run on the card that sends them (``pid``; they carry
    no ``args.device``), each card's idle share is averaged, and each reader
    gives the number it gave on the cards."""
    name = "3d7pt_star-2000x2048x2048.four-cards.trace.json.gz"
    with gzip.open(os.path.join(DATA, name), "rt") as f:
        recorded = json.load(f)
    path = tmp_path / "trace.json"
    with open(path, "w") as f:
        json.dump({"traceEvents": recorded["traceEvents"]}, f)
    meta = recorded["meta"]
    sl = trace.read_slice(str(path), meta["requests"], cards=4)
    work_ = work.Work(**meta["work"])
    c = harness.Context(setup_s=1.0, window=None, slice=sl, work=work_,
                        peaks=work.card_peaks(meta["card"]))
    for metric in ("device_idle_pct", "kernel_ms_per_step",
                   "kernel_roofline_pct", "exchange_ms"):
        assert read(metric, c) == pytest.approx(meta["readers"][metric],
                                                rel=1e-12)
    kernels = sl.per_card(("kernel",))
    assert len(kernels) == 4 and all(len(k) == 24 for k in kernels)
    idle = [100 * (1 - trace.union_us(k) / (sl.t1 - sl.t0)) for k in kernels]
    assert read("device_idle_pct", c) == pytest.approx(sum(idle) / 4)
    peer = [b - a for a, b, n in sl.copies() if "PtoP" in n]
    assert len(peer) == 2 * 12 * 6
    assert read("exchange_ms", c) == pytest.approx(sum(peer) / 1e3 / 24)
    assert 0 < sl.busy_s() <= sl.window_s
