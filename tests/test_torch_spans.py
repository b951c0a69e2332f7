"""The port's own spans and counters: ``utils/profiling.span`` (a null
context while no profiler session is active), the spans ``run_pairs`` and
each application record under a CPU ``torch.profiler`` session, and the
plan cache's counters in ``ops/kernels``."""

import contextlib
import json
import os
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.ops.stream import level_plan
from drstencil_tpu_torch.tune.tuned import best_config
from drstencil_tpu_torch.utils import profiling

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
# (stencil, grid small enough for the plain versions, factor mode, kernel)
CASES = [
    ("2d25pt_box", (96, 80), False, "stencil2d_levels"),
    ("3d7pt_star", (28, 24, 20), False, "stencil3d_levels"),
    ("2d25pt_box", (96, 80), True, "stencil2d_factor_levels"),
]


def small_program(name, dims, factor):
    spec = load_stc(os.path.join(ROOT, "benchmarks", f"{name}.stc"))
    spec = type(spec)(name=spec.name, dims=dims, iterations=spec.iterations,
                      taps=spec.taps)
    cfg = best_config(name)
    if factor:
        cfg = cfg.replace(step=1, factor=True, trapezoid=True, tm=None)
    return StencilProgram(spec, cfg, device="cpu")


def annotations(prof, tmp_path):
    """``(name, start, end)`` of the trace's ``user_annotation`` events."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation"]


def test_a_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) was built")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("drstencil.run_pairs")
    assert off is profiling.span("drstencil.apply x plain")
    assert isinstance(off, contextlib.nullcontext)
    with off as got:
        assert got is None


def test_a_span_under_a_profiler_is_a_record_function(monkeypatch):
    made = []

    def record(name):
        made.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(profiling, "record_function", record)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("drstencil.run_pairs"):
            pass
    assert made == ["drstencil.run_pairs"]
    assert profiling.span("after") is profiling.span("the session")


def test_no_record_function_on_the_untraced_path(monkeypatch):
    """An untraced run builds no ``record_function`` at all."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) was built")

    monkeypatch.setattr(profiling, "record_function", refuse)
    prog = small_program("2d25pt_box", (96, 80), False)
    prog.run_pairs(prog.init_state(3), 2)


@pytest.mark.parametrize("name,dims,factor,kernel", CASES)
@pytest.mark.parametrize("pairs", [1, 3])
def test_run_pairs_records_its_applications(tmp_path, name, dims, factor,
                                            kernel, pairs):
    prog = small_program(name, dims, factor)
    want = prog.run_pairs(prog.init_state(7), pairs)
    state = prog.init_state(7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = prog.run_pairs(state, pairs)
    for key in ("a", "b"):
        assert torch.equal(got[key], want[key])
    spans = annotations(prof, tmp_path)
    [parent] = [s for s in spans if s[0] == "drstencil.run_pairs"]
    applies = [s for s in spans if s[0].startswith("drstencil.apply ")]
    assert len(spans) == 1 + 2 * pairs
    assert {s[0] for s in applies} == {f"drstencil.apply {kernel} plain"}
    assert len(applies) == 2 * pairs
    for _, a, b in applies:
        assert parent[1] <= a <= b <= parent[2]


@pytest.fixture
def counters(monkeypatch, tmp_path):
    """Plan counters from zero, plans kept apart under ``tmp_path``, and a
    stand-in ``nvcc`` that writes an empty library and its log."""
    monkeypatch.setattr(kernels, "PLAN_DIR", str(tmp_path / "plans"))
    monkeypatch.setattr(kernels, "_PLANS", {})
    compiled = []

    def fake_nvcc(source, out):
        compiled.append(source)
        time.sleep(0.1)
        with open(out, "wb"):
            pass
        return "ptxas info    : Used 40 registers\n"

    class FakeLib:
        def __init__(self, path):
            self.launch = lambda *args: 0
            self.error_string = lambda err: b""

    monkeypatch.setattr(kernels, "_run_nvcc", fake_nvcc)
    monkeypatch.setattr(kernels.ctypes, "CDLL", FakeLib)
    kernels.reset_plan_counters()
    yield compiled
    kernels.reset_plan_counters()


def plan_taps(name):
    """The grid and level plan of ``name``'s winner at its ``.stc`` size."""
    spec = load_stc(os.path.join(ROOT, "benchmarks", f"{name}.stc"))
    cfg = best_config(name).replace(tm=None)
    an = analyze(spec, step=cfg.step, distance=cfg.distance,
                 merge_forward=cfg.merge_forward)
    return spec.dims, level_plan(an, cfg)


def test_counters_start_at_zero_and_are_a_copy(counters):
    got = kernels.plan_counters()
    assert got == {"disk_hits": 0, "builds": 0, "plan_s": 0.0,
                   "windowed_2d": 0, "windowed_3d": 0, "tma_2d": 0,
                   "tma_3d": 0, "partial_2d": 0, "block_fused": 0,
                   "ring_3d": 0, "flops": 0, "cell_steps": 0,
                   "smem_loads": 0}
    got["builds"] = 9
    assert kernels.plan_counters()["builds"] == 0


def test_plan_of_alone_counts_nothing(counters):
    """Finding or making a plan's text is no build, no load and no
    ``plan_kernel`` call."""
    dims, taps = plan_taps("2d5pt_star")
    first = kernels.plan_of(taps, dims, "float32", False, sms=132)
    for _ in range(3):
        assert kernels.plan_of(taps, dims, torch.float32, False,
                               sms=132) is first
    kernels.plan_of(taps, dims, "bfloat16", False, sms=132)
    assert kernels.plan_counters() == {"disk_hits": 0, "builds": 0,
                                       "plan_s": 0.0, "windowed_2d": 0,
                                       "windowed_3d": 0, "tma_2d": 0,
                                       "tma_3d": 0, "partial_2d": 0,
                                       "block_fused": 0, "ring_3d": 0,
                                       "flops": 0, "cell_steps": 0,
                                       "smem_loads": 0}
    assert not counters


def test_compile_counts_builds(counters):
    dims, taps = plan_taps("2d5pt_star")
    plans = [kernels.plan_of(taps, dims, dtype, False, sms=132)
             for dtype in ("float32", "bfloat16")]
    for p in plans:
        p.compile()
    got = kernels.plan_counters()
    assert got["builds"] == 2 and len(counters) == 2
    assert all(p.build_seconds >= 0.1 for p in plans)
    # compile alone is no plan_kernel call: no plan seconds
    assert got["plan_s"] == 0.0 and got["disk_hits"] == 0


def test_plan_kernel_counts_a_build_then_a_disk_hit(counters, monkeypatch):
    dims, taps = plan_taps("3d7pt_star")
    p = kernels.plan_kernel(taps, dims, "float32", False, sms=132)
    got = kernels.plan_counters()
    assert (got["builds"], got["disk_hits"]) == (1, 0)
    assert got["plan_s"] >= p.build_seconds > 0
    assert p.stem == os.path.basename(p.path)[:-len(".so")]
    assert p.stem == "plan_" + codegen.source_hash(p.text)
    # the loaded plan again: nothing built or loaded anew
    assert kernels.plan_kernel(taps, dims, "float32", False, sms=132) is p
    assert kernels.plan_counters()["disk_hits"] == 0
    # another process finds the library on disk
    monkeypatch.setattr(kernels, "_PLANS", {})
    kernels.plan_kernel(taps, dims, "float32", False, sms=132)
    got = kernels.plan_counters()
    assert (got["builds"], got["disk_hits"]) == (1, 1)
    assert len(counters) == 1


def test_build_plans_counts_each_second_once(counters):
    """Compiles in threads overlap: ``plan_s`` is the call's wall time,
    below the sum of the compiles' seconds."""
    dims, taps = plan_taps("2d5pt_star")
    dims3, taps3 = plan_taps("3d7pt_star")
    requests = [(taps, dims, d, False, 132) for d in ("float32", "bfloat16")]
    requests += [(taps3, dims3, d, False, 132)
                 for d in ("float32", "bfloat16")]
    t0 = time.perf_counter()
    plans = kernels.build_plans(requests)
    wall = time.perf_counter() - t0
    got = kernels.plan_counters()
    assert got["builds"] == 4 and got["disk_hits"] == 0
    assert max(p.build_seconds for p in plans) <= got["plan_s"] <= wall
    assert got["plan_s"] < sum(p.build_seconds for p in plans)
    # again: every plan is in memory and loaded, nothing counted but time
    kernels.build_plans(requests)
    again = kernels.plan_counters()
    assert (again["builds"], again["disk_hits"]) == (4, 0)


def test_plan_seconds_of_overlapping_calls_count_once(counters):
    """Two threads inside timed calls at once add their union's time."""
    inside = threading.Barrier(2)

    def timed():
        with kernels._COUNTERS.timed():
            inside.wait(timeout=10)
            time.sleep(0.05)

    threads = [threading.Thread(target=timed) for _ in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    wall = time.perf_counter() - t0
    assert 0.05 <= kernels.plan_counters()["plan_s"] <= wall


def test_a_card_apply_names_the_plan_it_loaded(counters, monkeypatch,
                                               tmp_path):
    """On a CUDA device the span names the library of the plan that
    ``plan_kernel`` built, as the card's trace shows it."""
    from drstencil_tpu_torch.ops import stream as stream_mod

    card = torch.device("cuda", 0)
    monkeypatch.setattr(stream_mod, "resolve_device", lambda device: card)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    spec = load_stc(os.path.join(ROOT, "benchmarks", "2d5pt_star.stc"))
    cfg = best_config("2d5pt_star").replace(tm=None)
    an = analyze(spec, step=cfg.step, distance=cfg.distance,
                 merge_forward=cfg.merge_forward)
    f = stream_mod.build_stream_kernel(an, cfg, device=card)
    assert len(counters) == 1
    plan = kernels.plan_of(level_plan(an, cfg), tuple(spec.dims), "float32",
                           False, sms=132)
    x = torch.zeros(4, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError, match="kernel built for cuda"):
            f(x, x)
    names = [s[0] for s in annotations(prof, tmp_path)]
    assert names == [f"drstencil.apply stencil2d_levels {plan.stem}"]
    assert kernels.plan_counters()["builds"] == 1
