"""Register windows along axis 0 in the 3D streamed kernel
(``drstencil_tpu_torch/ops/codegen.py``).

A windowed 3D plan's thread owns the same quad on every plane and at every
level, keeps its last planes of the source and of every level but the last in
registers, takes the cells beside its quad from the neighbouring lanes by warp
shuffles, and reads from shared memory only the rows above and below; each
level's ring keeps only the planes those taps read.  Only where an operand
comes from changes, so its text must compute what the ring text computes (the
same plan with ``codegen.WINDOW_REGS`` at 0: the text of every plan whose
windows do not fit) bit for bit.  That is checked under the ``g++`` emulation
(``test_torch_codegen.emulated``) for the suite's star tables in both dtypes,
on a grid of several columns and segments, a shard slab, a grid narrower than
the column and one of odd width, and for other depths and a ring of three
planes; the suite's box and cross tables keep the ring text byte for byte.
Then the ring depth each table gets, the ring path of plans whose windows
exceed the budget, and the plan cache's counter of windowed plans.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import level_plan, state_dtype

from test_torch_codegen import bench_spec, bf16_ulp, emulated

# the plans of the card's 3D winners, at the generator's tile
CONFIGS = {
    "3d7pt_star": KernelConfig(step=4, trapezoid=True),
    "3d13pt_star": KernelConfig(step=2, trapezoid=True),
    "3d27pt_box": KernelConfig(step=2, trapezoid=True),
    "3d9pt_cross": KernelConfig(step=3, distance=2, trapezoid=True),
}
KERNEL_TOL = 1e-5


def plan_for(name, dims, dtype="float32", cfg=None):
    cfg = (cfg or CONFIGS[name]).replace(dtype=dtype)
    spec = bench_spec(name, dims)
    return level_plan(analyze(spec, cfg.step, cfg.distance,
                              cfg.merge_forward), cfg)


def with_tap(plan, tap, coeff=0.125):
    """``plan`` with one more tap, the table kept in sorted order."""
    offsets = np.concatenate([plan.offsets, [tap]]).astype(np.int32)
    order = np.lexsort(offsets.T[::-1])
    coeffs = np.concatenate([plan.coeffs, [np.float32(coeff)]])
    return dataclasses.replace(plan, offsets=offsets[order],
                               coeffs=coeffs[order].astype(np.float32))


def dims_of(build, frame):
    """A grid of several columns and segments, a shard slab (its first
    store range: a frame's worth of rows left to the neighbour), a grid
    narrower than the column in y and x, or one whose width is no multiple
    of 4 (cell-wise access)."""
    return {"grid": ((20, 40, 136), None),
            "shard": ((24 + 2 * frame, 30, 72), (2 * frame, 24 + frame)),
            "narrow": ((16, 10, 36), None),
            "odd": ((16, 20, 70), None)}[build]


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def texts(plan, dims, dtype, shard, monkeypatch):
    """The plan's text, and its ring text (windows off)."""
    text = codegen.cuda_source(plan, dims, dtype, shard)
    with monkeypatch.context() as m:
        m.setattr(codegen, "WINDOW_REGS", 0)
        assert not codegen.geometry(plan, dims).window
        ring = codegen.cuda_source(plan, dims, dtype, shard)
    return text, ring


def run_both(tmp_path, plan, dims, dtype, rows, monkeypatch):
    """Both texts under the emulation on one state: their outputs, and the
    plain version's."""
    shard = rows is not None
    store = [int(v) for v in rows] if shard else []
    windowed, ring = texts(plan, dims, dtype, shard, monkeypatch)
    assert "__shfl_" not in ring
    rng = np.random.default_rng(5)
    tdt = state_dtype(dtype)
    src = torch.from_numpy(rng.uniform(0, 100, dims)).to(tdt)
    fill = torch.from_numpy(rng.uniform(-0.5, 0.5, dims)).to(tdt)
    outs = []
    for label, text in (("windowed", windowed), ("ring", ring)):
        (tmp_path / label).mkdir(parents=True)
        outs.append(emulated(text, tmp_path / label)(src, fill.clone(),
                                                     store))
    want = fill.clone()
    kernels.kernel_for(3, shard).plain(src, want, plan,
                                       *([tuple(store)] if shard else []))
    return outs, want, fill


@pytest.mark.parametrize("build", ["grid", "shard", "narrow", "odd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["3d7pt_star", "3d13pt_star"])
def test_windowed_text_equals_the_ring_text(tmp_path, monkeypatch, name,
                                            dtype, build):
    frame = plan_for(name, (20, 40, 136)).frame
    dims, rows = dims_of(build, frame)
    plan = plan_for(name, dims, dtype)
    g = codegen.geometry(plan, dims)
    assert g.window3d and g.ring == 2
    if build == "grid":
        assert int(np.prod(g.grid)) > 1
    if build == "narrow":
        # more threads than the plane's quads: idle threads on every plane
        assert g.tile[1:] == dims[1:] and g.threads > g.ey * g.ex // 4
    assert g.vec == (build != "odd")
    (got, ring), want, fill = run_both(tmp_path, plan, dims, dtype, rows,
                                       monkeypatch)
    assert torch.equal(bits(got), bits(ring))
    # and both are the plain version's levels
    diff = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    if dtype == "float32":
        assert float(diff.max()) <= KERNEL_TOL * top
    else:
        assert bool((diff <= bf16_ulp(want) + KERNEL_TOL * top).all())
    assert not torch.equal(bits(got), bits(fill))


@pytest.mark.parametrize("step", [1, 2, 3])
def test_other_depths_and_a_ring_of_three(tmp_path, monkeypatch, step):
    """A star at other steps; the same star with one more tap off the
    column at axis-0 offset 1, whose ring keeps offsets 0 and 1 and so
    writes the newest plane of its window, in bf16 on a shard slab."""
    dims = (20, 40, 136)
    plan = plan_for("3d7pt_star", dims,
                    cfg=KernelConfig(step=step, trapezoid=True))
    (got, ring), _, _ = run_both(tmp_path / "star", plan, dims, "float32",
                                 None, monkeypatch)
    assert torch.equal(bits(got), bits(ring))
    odd = with_tap(plan, [1, 0, 1])
    g = codegen.geometry(odd, (26, 30, 72))
    assert g.window3d and (g.ring, g.dhi) == (3, 1)
    assert g.window_write == g.window_len - 1
    (got, ring), want, _ = run_both(tmp_path / "odd", odd, (26, 30, 72),
                                    "bfloat16", (2 * odd.frame, 22),
                                    monkeypatch)
    assert torch.equal(bits(got), bits(ring))
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= bf16_ulp(want) + KERNEL_TOL
                 * float(want.float().abs().max())).all())


@pytest.mark.parametrize("build", ["grid", "shard", "narrow"])
@pytest.mark.parametrize("name", ["3d27pt_box", "3d9pt_cross"])
def test_box_and_cross_tables_keep_the_ring_text(monkeypatch, name, build):
    """Their taps off the column span every axis-0 offset of the reach, so
    windows would free no ring plane: the text is the ring text, byte for
    byte, in both dtypes."""
    frame = plan_for(name, (20, 40, 136)).frame
    dims, rows = dims_of(build, frame)
    for dtype in ("float32", "bfloat16"):
        plan = plan_for(name, dims, dtype)
        assert not codegen.geometry(plan, dims).window
        text, ring = texts(plan, dims, dtype, rows is not None, monkeypatch)
        assert text == ring


def _ring_of(name, cfg=None, dims=(512, 512, 512)):
    return codegen.geometry(plan_for(name, dims, cfg=cfg), dims)


def test_star_tables_get_two_plane_rings_and_a_box_keeps_its_depth():
    """The ring depth is read from the tap table: the planes at the axis-0
    offsets of the taps that leave the column, and the one being written;
    the windows engage where that is fewer planes than the ring text's."""
    for name in ("3d7pt_star", "3d13pt_star"):
        g = _ring_of(name)
        assert g.window3d and g.ring == 2 and g.dhi == 0
        # a star's windows span its reach on both sides; a level writes the
        # middle plane of its window to its ring
        assert g.window_len == 2 * g.reach + 1
        assert g.window_write == g.reach
    for name in ("3d27pt_box", "3d9pt_cross"):
        g = _ring_of(name)
        assert not g.window and g.ring == 2 * g.reach + 2 == 4
        assert g.smem_bytes == 4 * (2 * g.guard + g.levels * g.ring
                                    * g.ey * g.ex)
    # a star with one more tap off the column at axis-0 offset 1: a ring of
    # 3 planes (offsets 0 and 1, and the one being written)
    g = codegen.geometry(with_tap(plan_for("3d7pt_star", (512,) * 3),
                                  [1, 0, 1]), (512, 512, 512))
    assert g.window3d and (g.ring, g.dhi) == (3, 1)
    # ... and with one at offset -1 too, every offset: the ring text
    g = codegen.geometry(with_tap(with_tap(plan_for(
        "3d7pt_star", (512,) * 3), [1, 0, 1]), [-1, 0, 1]), (512, 512, 512))
    assert not g.window and g.ring == 4
    # a star's column is wider than its ring text's: shallower rings
    with pytest.MonkeyPatch.context() as m:
        m.setattr(codegen, "WINDOW_REGS", 0)
        old = _ring_of("3d7pt_star")
    new = _ring_of("3d7pt_star")
    assert (old.ring, new.ring) == (4, 2)
    assert new.tile[1] * new.tile[2] > old.tile[1] * old.tile[2]
    assert new.read_cells() < old.read_cells()
    # one quad a thread, one CTA an SM by its registers
    assert new.threads == codegen._ceil_to(new.ey * new.ex // 4, 32)
    assert new.threads <= codegen.THREADS_3D_WINDOW and new.min_blocks == 1


def test_windows_past_the_budget_keep_the_ring_path(monkeypatch):
    """A plan whose windows exceed ``WINDOW_REGS`` is the ring text."""
    deep = plan_for("3d13pt_star", (512, 512, 512),
                    cfg=KernelConfig(step=5, trapezoid=True))
    # 5 levels of 5 planes: 100 registers a quad
    assert codegen.QUAD * deep.levels * (2 * deep.reach + 1) \
        > codegen.WINDOW_REGS
    g = codegen.geometry(deep, (512, 512, 512))
    assert not g.window and g.ring == 2 * deep.reach + 2
    text, ring = texts(deep, (512, 512, 512), "float32", False, monkeypatch)
    assert text == ring and "__shfl_" not in text
    # the budget decides: one register short of a plan's windows, its ring
    # text, at the column its rings fit
    plan = plan_for("3d7pt_star", (512, 512, 512))
    win = codegen.geometry(plan, (512, 512, 512))
    need = codegen.QUAD * win.levels * win.window_len
    assert win.window3d and need <= codegen.WINDOW_REGS
    monkeypatch.setattr(codegen, "WINDOW_REGS", need - 1)
    g = codegen.geometry(plan, (512, 512, 512))
    assert not g.window and g.ring == 4 and g.tile[1:] == (16, 64)


@pytest.fixture
def counters(monkeypatch, tmp_path):
    """Plan counters from zero, plans kept apart under ``tmp_path``, and a
    stand-in ``nvcc`` that writes an empty library and its log."""
    monkeypatch.setattr(kernels, "PLAN_DIR", str(tmp_path / "plans"))
    monkeypatch.setattr(kernels, "_PLANS", {})

    def fake_nvcc(source, out):
        time.sleep(0.01)
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
    yield
    kernels.reset_plan_counters()


def test_the_plan_counters_count_windowed_plans(counters, monkeypatch):
    spec2 = bench_spec("2d5pt_star")
    win2 = level_plan(analyze(spec2, 4), KernelConfig(step=4, trapezoid=True))
    spec25 = bench_spec("2d25pt_box")
    rings2 = level_plan(analyze(spec25, 5), KernelConfig(step=5,
                                                         trapezoid=True))
    spec3 = bench_spec("3d7pt_star")
    win3 = plan_for("3d7pt_star", spec3.dims)
    deep3 = plan_for("3d13pt_star", spec3.dims,
                     cfg=KernelConfig(step=5, trapezoid=True))
    assert codegen.geometry(win2, spec2.dims).window
    assert not codegen.geometry(rings2, spec25.dims).window
    assert codegen.geometry(win3, spec3.dims).window3d
    assert not codegen.geometry(deep3, spec3.dims).window
    kernels.build_plans([(win2, spec2.dims, "float32", False, 132),
                         (rings2, spec25.dims, "float32", False, 132),
                         (win3, spec3.dims, "float32", False, 132),
                         (win3, spec3.dims, "bfloat16", False, 132),
                         (deep3, spec3.dims, "float32", False, 132)])
    got = kernels.plan_counters()
    assert (got["builds"], got["windowed_2d"], got["windowed_3d"]) == (5, 1, 2)
    # the keys the benchmark's plan_setup_s reads stay
    assert {"disk_hits", "builds", "plan_s"} <= set(got)
    # a loaded plan again counts nothing; another process finds them on disk
    kernels.plan_kernel(win3, spec3.dims, "float32", False, sms=132)
    assert kernels.plan_counters()["windowed_3d"] == 2
    monkeypatch.setattr(kernels, "_PLANS", {})
    kernels.plan_kernel(win3, spec3.dims, "float32", False, sms=132)
    kernels.plan_kernel(deep3, spec3.dims, "float32", False, sms=132)
    got = kernels.plan_counters()
    assert (got["disk_hits"], got["windowed_3d"]) == (2, 3)
