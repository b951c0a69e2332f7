"""A trace that asked for the card's activity and recorded none of it is a
failed trace (``utils/profiling.maybe_trace``): ``trace_error.txt`` says
so, ``tuning/capture_trace`` exits 1 and ``tune/session.session_trace``
returns no directory.  The profiler is a stand-in here (no card): it
writes the Chrome trace it is given."""

import json
import os

import pytest
import torch
import torch.profiler

from drstencil_tpu_torch.tune import session as session_mod
from drstencil_tpu_torch.tuning import capture_trace
from drstencil_tpu_torch.utils import profiling
from drstencil_tpu_torch.utils.profiling import maybe_trace, trace_failed

from conftest import BENCH_DIR

HOST_EVENT = {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1,
              "tid": 1, "ts": 0, "dur": 3}
KERNEL_EVENT = {"ph": "X", "cat": "kernel", "name": "stencil_kernel",
                "pid": 0, "tid": 7, "ts": 10, "dur": 5}


class StandInProfile:
    """What ``maybe_trace`` uses of ``torch.profiler.profile``."""

    def __init__(self, events, activities):
        self.events = events
        self.activities = activities

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)

    def key_averages(self):
        class Table:
            def table(self, row_limit):
                return "stand-in table\n"
        return Table()


@pytest.fixture
def card_profiler(monkeypatch):
    """A card is said to be there, so ``maybe_trace`` asks for CUDA
    activity; ``set_events`` chooses what the stand-in records."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    asked = []
    recorded = {"events": []}

    def profile(activities):
        asked.append(list(activities))
        return StandInProfile(recorded["events"], activities)

    monkeypatch.setattr(torch.profiler, "profile", profile)

    def set_events(events):
        recorded["events"] = events
    set_events.asked = asked
    return set_events


@pytest.mark.parametrize("events,failed", [
    ([HOST_EVENT], True), ([], True), ([HOST_EVENT, KERNEL_EVENT], False)],
    ids=["host_only", "empty", "device_rows"])
def test_trace_without_device_events_is_recorded(tmp_path, card_profiler,
                                                 events, failed):
    card_profiler(events)
    trace_dir = str(tmp_path / "tr")
    with maybe_trace(trace_dir) as active:
        pass
    assert active
    assert torch.profiler.ProfilerActivity.CUDA in card_profiler.asked[0]
    # the trace and the table are kept either way: they show what came
    assert os.path.exists(os.path.join(trace_dir, "trace.json"))
    assert os.path.exists(os.path.join(trace_dir, "kernels.txt"))
    assert trace_failed(trace_dir) == failed
    err = os.path.join(trace_dir, profiling.TRACE_ERROR)
    assert os.path.exists(err) == failed
    if failed:
        assert "holds no device event" in open(err).read()


def test_cpu_only_trace_is_not_a_failure(tmp_path):
    """Without a card the profiler is asked for CPU activity only, so a
    trace with no device rows is what it asked for."""
    trace_dir = str(tmp_path / "cpu")
    with maybe_trace(trace_dir) as active:
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum().item()
    assert active and not trace_failed(trace_dir)


class StubProgram:
    """Stands in for ``StencilProgram``: the traced window runs nothing."""

    def __init__(self, spec, cfg, device=None):
        self.cfg = cfg

    def time(self, **kw):
        return None


@pytest.mark.parametrize("events,rc", [([HOST_EVENT], 1),
                                       ([KERNEL_EVENT], 0)],
                         ids=["no_device_rows", "device_rows"])
def test_capture_trace_reports_an_empty_trace(tmp_path, monkeypatch,
                                              card_profiler, capsys, events,
                                              rc):
    card_profiler(events)
    monkeypatch.setattr(capture_trace, "TRACE_ROOT", str(tmp_path))
    monkeypatch.setattr(capture_trace, "StencilProgram", StubProgram)
    assert capture_trace.main([]) == rc
    out = capsys.readouterr().out
    if rc:
        assert "trace: FAILED" in out and "no device event" in out
        assert not out.strip().splitlines()[-1].startswith("{")
    else:
        verdict = json.loads(out.strip().splitlines()[-1])
        assert [r["name"] for r in verdict["rows"]] == ["stencil_kernel"]
        assert verdict["busy"]["kernel_events"] == 1


@pytest.mark.parametrize("events,kept", [([HOST_EVENT], False),
                                         ([KERNEL_EVENT], True)],
                         ids=["no_device_rows", "device_rows"])
def test_session_trace_drops_an_empty_trace(tmp_path, monkeypatch,
                                            card_profiler, events, kept):
    from drstencil_tpu_torch.ops import runner

    card_profiler(events)
    monkeypatch.setattr(runner, "StencilProgram", StubProgram)
    logged = []
    got = session_mod.session_trace(BENCH_DIR, str(tmp_path), "2d5pt_star",
                                    log=logged.append, device="cpu")
    if kept:
        assert got == str(tmp_path / "trace")
    else:
        assert got is None
        assert any(profiling.TRACE_ERROR in m for m in logged)
