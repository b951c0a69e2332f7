"""The readers of the program's own spans and counters, on synthetic traces:
``launch_host_us`` (the apply spans' self time), ``idle_host_pct`` (idle
stretches the program's host path caused) and ``plan_setup_s`` (the plan
cache's seconds), which ``BENCHMARK.json`` lists for the solve cells."""

import json
import os
import re

import pytest

from stencilbench import cells, harness, trace, work
from stencilbench.conftest import SHARDED, copy_bench

K = "stencil_kernel(float const*, float*)"
APPLY = "drstencil.apply stencil2d_levels plan_0123456789abcdef"
# the one-card cells whose mix returns nothing
SOLVE_CELLS = [w["name"] for w in cells.benchmark(cells.ROOT)["workloads"]
               if w["chips"] == 1 and not cells.load_json(
                   cells.ROOT, "traffic", w["traffic"])["readback"]]
NEW = {"launch_host_us", "idle_host_pct", "plan_setup_s"}
# the three metrics' entries in BENCHMARK.json
ENTRIES = [m for m in cells.benchmark(cells.ROOT)["per_layer"]
           if m["name"] in NEW]


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0 if cat in trace.DEVICE_CATS else 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def write(path, events, requests=1):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return trace.read_slice(str(path), requests=requests)


def synthetic(path):
    """A slice from 1000 to 2000 us: a reset copy, then three applications
    in one ``run_pairs`` (one launch mid-call when the device idles, one
    blocked on a full queue, one issued after the device ran dry), then the
    synchronize."""
    events = [
        ev("user_annotation", trace.SLICE, 1000, 1000),
        # issued and run before the slice: never counted
        ev("cuda_runtime", "cudaLaunchKernel", 50, 5, corr=1),
        ev("kernel", K, 100, 500, corr=1),
        ev("user_annotation", "stencilbench.reset", 1005, 20),
        ev("cuda_runtime", "cudaMemcpyAsync", 1010, 10, corr=2),
        ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 1030, 20, corr=2),
        ev("user_annotation", "stencilbench.solve", 1035, 400),
        ev("user_annotation", "drstencil.run_pairs", 1038, 395),
        # apply 1: 30 us, of which 2 + 10 in runtime calls; the device
        # idles from 1050 while the launch is under way
        ev("user_annotation", APPLY, 1040, 30),
        ev("cuda_runtime", "cudaFuncSetAttribute", 1045, 2, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 1050, 10, corr=4),
        ev("kernel", K, 1060, 140, corr=4),
        # another thread's call inside apply 1's interval: not its own
        ev("cuda_runtime", "cudaStreamQuery", 1041, 20, corr=9, tid=2),
        # apply 2: 105 us, 100 of them blocked in the launch; its kernel
        # waits 10 us after the first one ends: the device's own gap
        ev("user_annotation", APPLY, 1075, 105),
        ev("cuda_runtime", "cudaLaunchKernel", 1080, 100, corr=5),
        ev("kernel", K, 1210, 190, corr=5),
        # apply 3 begins after the device ran dry at 1400
        ev("user_annotation", APPLY, 1420, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 1425, 5, corr=6),
        ev("kernel", K, 1450, 150, corr=6),
        ev("gpu_user_annotation", APPLY, 1450, 150),
        ev("cuda_runtime", "cudaDeviceSynchronize", 1600, 300, corr=7),
    ]
    return write(path, events)


def ctx(sl):
    return harness.Context(
        setup_s=1.0, window=None, slice=sl,
        work=work.work_of((96, 80), 25, 48, 3, "float32"),
        peaks=work.card_peaks("NVIDIA H100 80GB HBM3"))


def read(name, c):
    return cells.load_module(cells.ROOT, "metrics", name).read(c)


def test_launch_host_us_is_the_apply_spans_median_self_time(tmp_path):
    c = ctx(synthetic(tmp_path / "t.json"))
    # self times (30 - 2 - 10), (105 - 100), (20 - 5): their median
    assert read("launch_host_us", c) == pytest.approx(15.0)


def test_idle_host_pct_counts_the_stretches_the_program_caused(tmp_path):
    c = ctx(synthetic(tmp_path / "t.json"))
    # counted: the stretch that began mid-launch (10) and the one before a
    # later launch (50); not the slice's start up to the harness's reset
    # copy (30), the device's own 10 us at 1200, or the closing stretch
    assert read("idle_host_pct", c) == pytest.approx(100 * 60 / 1000)
    # the rest of the idle time: the copy, the slice's ends, the device's
    # own gap
    assert read("device_idle_pct", c) == pytest.approx(
        100 * (1 - 480 / 1000))


def test_a_stretch_counts_from_the_start_of_run_pairs(tmp_path):
    """The device runs dry while the harness is still between its reset
    and its solve: only the part after ``run_pairs`` began is the
    program's."""
    events = [ev("user_annotation", trace.SLICE, 0, 100),
              ev("cuda_runtime", "cudaMemcpyAsync", 1, 4, corr=1),
              ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 5, 5,
                 corr=1),
              ev("user_annotation", "drstencil.run_pairs", 30, 20),
              ev("user_annotation", APPLY, 32, 16),
              ev("cuda_runtime", "cudaLaunchKernel", 40, 5, corr=2),
              ev("kernel", K, 45, 40, corr=2)]
    c = ctx(write(tmp_path / "t.json", events))
    # idle 10..45, of which 30..45 under run_pairs
    assert read("idle_host_pct", c) == pytest.approx(15.0)


def test_an_operation_issued_before_the_slice_is_not_the_hosts(tmp_path):
    events = [ev("user_annotation", "drstencil.run_pairs", -60, 30),
              ev("cuda_runtime", "cudaLaunchKernel", -50, 10, corr=1),
              ev("user_annotation", trace.SLICE, 0, 100),
              ev("kernel", K, 20, 20, corr=1)]
    c = ctx(write(tmp_path / "t.json", events))
    assert read("idle_host_pct", c) == pytest.approx(0.0)


def test_an_operation_without_its_call_or_span_is_not_the_hosts(tmp_path):
    events = [ev("user_annotation", trace.SLICE, 0, 100),
              ev("user_annotation", "drstencil.run_pairs", 0, 5),
              ev("cuda_runtime", "cudaLaunchKernel", 1, 2, corr=1),
              ev("kernel", K, 10, 20, corr=1),
              # no call in the trace
              ev("kernel", K, 50, 10, corr=8),
              # a call outside run_pairs, and one on another thread
              ev("cuda_runtime", "cudaMemcpyAsync", 55, 10, corr=9),
              ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 62, 3,
                 corr=9),
              ev("cuda_runtime", "cudaLaunchKernel", 2, 70, corr=10,
                 tid=2),
              ev("kernel", K, 80, 10, corr=10)]
    c = ctx(write(tmp_path / "t.json", events))
    # only the first kernel's 10 us: its launch, in run_pairs, had not
    # returned when the slice began
    assert read("idle_host_pct", c) == pytest.approx(10.0)


def test_no_program_spans_no_correlation_nothing_to_read(tmp_path):
    events = [ev("user_annotation", trace.SLICE, 0, 100),
              ev("user_annotation", "stencilbench.solve", 0, 50),
              ev("cuda_runtime", "cudaLaunchKernel", 1, 2, corr=1),
              ev("kernel", K, 10, 20, corr=1)]
    c = ctx(write(tmp_path / "t.json", events))
    assert read("launch_host_us", c) is None
    assert read("idle_host_pct", c) is None
    for name in ("launch_host_us", "idle_host_pct"):
        assert read(name, ctx(None)) is None


def test_apply_spans_keep_out_of_the_breakdown(tmp_path):
    b = synthetic(tmp_path / "t.json").breakdown()
    labels = [label for label, _ in b["idle_gaps"] + b["device_ops"]]
    assert labels and not [x for x in labels if "drstencil" in x]
    assert APPLY not in dict(b["device_ops"])


def test_plan_setup_s_reads_the_plan_counters(monkeypatch):
    from drstencil_tpu_torch.ops import kernels

    counts = {"disk_hits": 1, "builds": 0, "plan_s": 0.0731}
    monkeypatch.setattr(kernels, "plan_counters", lambda: dict(counts))
    assert read("plan_setup_s", ctx(None)) == 0.0731
    counts.update(disk_hits=0, builds=1, plan_s=4.5)
    assert read("plan_setup_s", ctx(None)) == 4.5
    # no plan made (the CPU's plain versions): nothing to read
    counts.update(disk_hits=0, builds=0, plan_s=0.0)
    assert read("plan_setup_s", ctx(None)) is None


@pytest.mark.parametrize("name", SOLVE_CELLS)
def test_the_solve_cells_report_the_new_metrics(tmp_path, name):
    """Each solve cell reports the three metrics in a traced run, and only
    there; the four-card cell does not (its host issues no run_pairs)."""
    root = copy_bench(str(tmp_path))
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = cells.load_cell(name, root)
    layer = {m[0]: m[1] for m in cell.metrics(trace=True)}
    assert NEW <= set(layer)
    assert (layer["launch_host_us"], layer["idle_host_pct"],
            layer["plan_setup_s"]) == ("us", "%", "s")
    assert not NEW & {m[0] for m in cell.metrics(trace=False)}
    assert not NEW & {m[0] for m in cells.load_cell(SHARDED, root).metrics(
        trace=True)}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {m["name"] for m in ENTRIES} == NEW
    for m in ENTRIES:
        assert m["workloads"] == SOLVE_CELLS
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", m["name"])
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"])
        assert 1 <= len(m["layer"]) <= 200
