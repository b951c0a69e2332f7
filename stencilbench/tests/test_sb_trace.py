"""The per-layer readers and the breakdown, read from a synthetic trace."""

import json

import pytest

from stencilbench import cells, harness, trace, work

K = "stencil_kernel(float const*, float*)"
COPY = "Memcpy DtoH (Device -> Pageable)"


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
