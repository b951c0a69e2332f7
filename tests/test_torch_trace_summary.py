"""The card's timeline from a ``torch.profiler`` trace — the port's
``utils/trace_summary`` against the contract of ``tests/test_trace_summary.py``
(aggregation, a missing trace, the CSV), on Kineto-shaped traces: a
synthetic one, a CPU-only one taken here, and one taken on the card."""

import csv
import gzip
import json
import os

import pytest
import torch

from drstencil_tpu_torch.tuning import capture_trace
from drstencil_tpu_torch.utils.profiling import maybe_trace
from drstencil_tpu_torch.utils.trace_summary import (Row, busy_share, main,
                                                     summarize, write_csv)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
# the two-pair trace of the 2d5pt_star winner that capture_trace wrote on
# the card (NVIDIA H100 80GB HBM3)
CARD_TRACE = os.path.join(REPO, "drstencil_tpu_torch", "tuning",
                          "trace_2d5pt_star")
KERNEL = "stencil_kernel(float const*, float*)"


def _events():
    """Kineto's shapes: host ops and runtime calls on the process's pid,
    the card's work on pid 0 with the stream as tid, named by metadata."""
    return [
        {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0,
         "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7 "}},
        # two launches of the same kernel: 1.5 ms + 2.5 ms, 1 ms apart
        {"ph": "X", "cat": "kernel", "name": KERNEL, "pid": 0, "tid": 7,
         "ts": 1000.0, "dur": 1500.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL, "pid": 0, "tid": 7,
         "ts": 3500.0, "dur": 2500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 7, "ts": 100.0, "dur": 500.0},
        # the host's events must be excluded by default
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 4242, "tid": 4242, "ts": 990.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 4242,
         "tid": 4242, "ts": 90.0, "dur": 700.0},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 4242,
         "tid": 4242, "ts": 990.0, "id": 1},
    ]


def _write(tmp_path, events, name="trace.json", gz=False):
    d = tmp_path / "run"
    d.mkdir(exist_ok=True)
    path = d / (name + (".gz" if gz else ""))
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return str(tmp_path)


def test_summarize_aggregates_device_events_only(tmp_path):
    rows = summarize(_write(tmp_path, _events()))
    assert rows == [
        Row(name=KERNEL, thread="stream 7 ", count=2, total_ms=4.0),
        Row(name="Memcpy HtoD", thread="stream 7 ", count=1, total_ms=0.5),
    ]
    assert rows[0].mean_ms == 2.0
    # --all keeps the host rows (the flow event 's' is no complete event)
    assert len(summarize(str(tmp_path), device_only=False)) == 4


@pytest.mark.parametrize("name,gz", [("trace.json", False),
                                     ("trace.json", True),
                                     ("host_1.1700000000.pt.trace.json",
                                      False),
                                     ("host_1.1700000000.pt.trace.json",
                                      True)])
def test_finds_both_names_gzipped_or_not(tmp_path, name, gz):
    rows = summarize(_write(tmp_path, _events(), name, gz))
    assert [r.count for r in rows] == [2, 1]


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        summarize(str(tmp_path))


def test_csv_roundtrip(tmp_path):
    rows = [Row(name="k", thread="stream 7", count=3, total_ms=6.0)]
    out = tmp_path / "deviceMetrics.csv"
    write_csv(rows, str(out), label="cfgA")
    write_csv(rows, str(out), label="cfgB")  # append, header once
    lines = out.read_text().strip().splitlines()
    assert lines[0] == "label,thread,kernel,count,total_ms,mean_ms"
    assert len(lines) == 3
    assert lines[1].split(",")[0] == "cfgA"
    assert lines[2] == "cfgB,stream 7,k,3,6.0,2.0"


def test_busy_share_is_kernel_time_over_their_span(tmp_path):
    got = busy_share(_write(tmp_path, _events()))
    # 4000 µs of kernels over 1000 .. 6000 µs; the copy is not a kernel
    assert got["kernel_events"] == 2
    assert got["kernel_us"] == 4000.0
    assert got["span_us"] == 5000.0
    assert got["busy_share"] == 0.8
    assert got["names"] == [KERNEL]
    no_kernels = [e for e in _events() if e.get("cat") != "kernel"]
    assert busy_share(_write(tmp_path, no_kernels)) == {"kernel_events": 0}


def test_cli_prints_the_table_and_appends_the_csv(tmp_path, capsys):
    trace_dir = _write(tmp_path, _events())
    out_csv = str(tmp_path / "deviceMetrics.csv")
    main([trace_dir, out_csv, "--top", "1"])
    text = capsys.readouterr().out
    assert "stencil_kernel" in text and "Memcpy" not in text
    assert "appended 2 rows" in text
    with open(out_csv, newline="") as f:
        written = list(csv.reader(f))
    assert written[1] == [os.path.basename(trace_dir), "stream 7 ", KERNEL,
                          "2", "4.0", "2.0"]


def test_cpu_only_trace_has_no_device_rows(tmp_path):
    """A trace taken here (no card: ``maybe_trace`` profiles the CPU only)
    has no device rows by default and the host's with ``--all``."""
    trace_dir = str(tmp_path / "cpu")
    with maybe_trace(trace_dir) as active:
        x = torch.ones(64, 64)
        (x @ x).sum().item()
    assert active
    assert summarize(trace_dir) == []
    host = summarize(trace_dir, device_only=False)
    assert host and all(r.count >= 1 for r in host)
    assert busy_share(trace_dir) == {"kernel_events": 0}


def test_checked_in_card_trace_parses():
    """The committed trace from the card keeps parsing: the 2d5pt_star
    winner's kernel counted once per launch of the traced window (one
    warmup pair and two timed pairs: six launches), on one stream."""
    rows = summarize(CARD_TRACE)
    kernel_rows = [r for r in rows if r.name.startswith("stencil_kernel")]
    launches = 2 * (capture_trace.WARMUP_PAIRS
                    + capture_trace.REPEATS * capture_trace.PAIRS)
    assert len(kernel_rows) == 1
    assert kernel_rows[0].count == launches == 6
    assert kernel_rows[0].thread.startswith("stream")
    assert 0.05 < kernel_rows[0].mean_ms < 1.0
    busy = busy_share(CARD_TRACE)
    assert busy["kernel_events"] == launches
    assert 0.0 < busy["busy_share"] <= 1.0
    assert len(summarize(CARD_TRACE, device_only=False)) > len(rows)



def test_capture_trace_ends_with_its_json_verdict(monkeypatch, capsys):
    """``capture_trace``'s last line is one JSON object: the launches the
    wrappers counted, the table's rows and the busy share, read from the
    trace (the card's capture replaced by the committed card trace)."""
    launches = 2 * (capture_trace.WARMUP_PAIRS
                    + capture_trace.REPEATS * capture_trace.PAIRS)
    monkeypatch.setattr(capture_trace, "capture", lambda name, sub: {
        "trace_dir": CARD_TRACE, "active": True,
        "artifacts": [os.path.join(CARD_TRACE, "trace.json")],
        "label": "2d5pt_star:stream_fu6_trap_b2_roll",
        "launches": launches})
    assert capture_trace.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"trace: OK — 1 artifact(s) under "
                               f"{CARD_TRACE}; {launches} kernel launches")
    verdict = json.loads(lines[-1])
    assert verdict["launches"] == launches
    assert verdict["rows"] == [
        {"name": r.name, "thread": r.thread, "count": r.count,
         "total_ms": r.total_ms} for r in summarize(CARD_TRACE)]
    assert sum(r["count"] for r in verdict["rows"]
               if r["name"].startswith("stencil_kernel")) == launches
    assert verdict["busy"] == busy_share(CARD_TRACE)
