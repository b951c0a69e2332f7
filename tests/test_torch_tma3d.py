"""Source planes by TMA in the windowed 3D text
(``drstencil_tpu_torch/ops/codegen.py``).

A windowed 3D plan whose rows are whole 16-byte pieces in either state type
gets each staged plane as one box of a 3D tensor map, copied into a ring of
slots in shared memory ``AHEAD`` steps before its use and reported on the
slot's mbarrier; the copy engine fills zeros outside the domain, where the
register fetch it replaces reads 0 by hand.  Only where the source's cells
come from changes, so its text must compute what the register-fetch text
computes (the same plan with ``codegen.AHEAD_3D`` at 0) bit for bit.  That is
checked under the ``g++`` emulation (``test_torch_codegen.emulated``, whose
``tests/cuda_emulation/bulk_copy.h`` copies a box as the card does and
refuses one that does not start on 16 bytes) for the suite's star tables in
both dtypes, on a grid of several columns and segments, a shard slab, a grid
narrower than the column, and a window of no more planes than are requested
ahead.  Grids whose rows are not whole 16-byte pieces in bf16 and the ring 3D
tables keep their texts byte for byte, and the 2D texts do not depend on
``AHEAD_3D``.  Then the host's map cache (two maps for a ping-pong pair
however many launches), the plan counter ``tma_3d`` and the wrapper's
``maps_encoded``.
"""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import level_plan, state_dtype

from test_torch_codegen import bench_spec, bf16_ulp, emulated
from test_torch_window3d import KERNEL_TOL, bits, plan_for


def register_text(plan, dims, dtype, shard, monkeypatch):
    """The plan's text with the feed off: each thread fetches its quad of
    the next plane into registers."""
    with monkeypatch.context() as m:
        m.setattr(codegen, "AHEAD_3D", 0)
        assert not codegen.geometry(plan, dims).tma
        return codegen.cuda_source(plan, dims, dtype, shard)


def build(name):
    """(dims, store range) of a build: several columns and segments, a
    shard slab (its first store range), a grid narrower than the column in
    y and x, or a window of three planes at step 1, as many as are
    requested ahead."""
    return {"grid": ((36, 40, 136), None),
            "shard": ((32, 30, 72), (8, 28)),
            "narrow": ((16, 10, 40), None),
            "short": ((3, 16, 40), None)}[name]


CASES = ([(n, dt, b) for n in ("3d7pt_star", "3d13pt_star")
          for dt in codegen.DTYPES for b in ("grid", "shard")]
         + [("3d7pt_star", dt, b) for dt in codegen.DTYPES
            for b in ("narrow", "short")])


@pytest.mark.parametrize("name,dtype,which", CASES,
                         ids=[" ".join(c) for c in CASES])
def test_tma_text_equals_the_register_fetch_text(tmp_path, monkeypatch, name,
                                                 dtype, which):
    dims, rows = build(which)
    cfg = KernelConfig(step=1, trapezoid=True) if which == "short" else None
    plan = plan_for(name, dims, dtype, cfg)
    g = codegen.geometry(plan, dims)
    assert g.tma and g.ahead == codegen.AHEAD_3D
    if which == "grid":
        assert g.grid[0] > 1 and g.grid[-1] > 1
    if which == "narrow":
        assert g.tile[1:] == dims[1:] and g.threads > g.ey * g.ex // 4
    if which == "short":
        assert dims[0] == 2 * plan.frame + 1 <= g.ahead
    shard = rows is not None
    tma = codegen.cuda_source(plan, dims, dtype, shard)
    fetch = register_text(plan, dims, dtype, shard, monkeypatch)
    assert "cp.async.bulk.tensor.3d" in tma and "fetch_plane(" not in tma
    assert "fetch_plane(" in fetch and "tma_" not in fetch
    rng = np.random.default_rng(7)
    tdt = state_dtype(dtype)
    src = torch.from_numpy(rng.uniform(0, 100, dims)).to(tdt)
    fill = torch.from_numpy(rng.uniform(-0.5, 0.5, dims)).to(tdt)
    store = [int(v) for v in rows] if shard else []
    outs = []
    for label, text in (("tma", tma), ("fetch", fetch)):
        (tmp_path / label).mkdir()
        outs.append(emulated(text, tmp_path / label)(src, fill.clone(), store))
    got, want_bits = outs
    assert torch.equal(bits(got), bits(want_bits))
    # and both are the plain version's levels
    want = fill.clone()
    kernels.kernel_for(3, shard).plain(src, want, plan,
                                       *([tuple(store)] if shard else []))
    diff = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    if dtype == "float32":
        assert float(diff.max()) <= KERNEL_TOL * top
    else:
        assert bool((diff <= bf16_ulp(want) + KERNEL_TOL * top).all())
    assert not torch.equal(bits(got), bits(fill))


def test_feed_engages_by_the_plan_alone(monkeypatch):
    """Every windowed 3D plan of the suite's star tables whose grid width
    and staged plane are multiples of 8 cells, full grid and shard slab;
    not a width of 4 modulo 8 (a bf16 row would not be whole 16 bytes) nor
    one with no 16-byte access, nor a ring 3D table, whose texts stay byte
    for byte what they are with the feed off; nor a 2D plan, whose text
    does not depend on the 3D feed."""
    for name in ("3d7pt_star", "3d13pt_star"):
        for dims in ((512, 512, 512), (776, 2048, 2048), (20, 40, 136)):
            g = codegen.geometry(plan_for(name, dims), dims)
            assert g.window3d and g.tma and g.ahead == codegen.AHEAD_3D
        for dims in ((16, 10, 36), (16, 20, 70)):
            plan = plan_for(name, dims)
            g = codegen.geometry(plan, dims)
            assert g.window3d and not g.tma and g.ahead == 0
            for dtype in codegen.DTYPES:
                text = codegen.cuda_source(plan, dims, dtype, False)
                assert text == register_text(plan, dims, dtype, False,
                                             monkeypatch)
    for name in ("3d27pt_box", "3d9pt_cross"):
        dims = (512, 512, 512)
        plan = plan_for(name, dims)
        assert not codegen.geometry(plan, dims).window
        for dtype in codegen.DTYPES:
            for shard in (False, True):
                with monkeypatch.context() as m:
                    m.setattr(codegen, "AHEAD_3D", 0)
                    off = codegen.cuda_source(plan, dims, dtype, shard)
                assert codegen.cuda_source(plan, dims, dtype, shard) == off
    for name, step in (("2d5pt_star", 6), ("2d25pt_box", 3)):
        spec = bench_spec(name)
        plan = level_plan(analyze(spec, step),
                          KernelConfig(step=step, trapezoid=True))
        with monkeypatch.context() as m:
            m.setattr(codegen, "AHEAD_3D", 0)
            off = codegen.cuda_source(plan, spec.dims, "float32", False)
        assert codegen.cuda_source(plan, spec.dims, "float32", False) == off
        # a 2D plan's rows come by the 2D feeds (test_torch_tma2d.py)
        assert "tma_copy_3d" not in off and "tma_encode_3d" not in off


def test_slots_fit_the_ctas_registers_admit():
    """The slots take what the rings leave of the shared memory the CTAs an
    SM holds by their registers: the winners' one CTA an SM keeps four
    slots; a column narrow enough for two CTAs keeps both."""
    dims = (512, 512, 512)
    g = codegen.geometry(plan_for("3d7pt_star", dims), dims)
    assert (g.ahead, g.min_blocks, g.ctas_per_sm) == (3, 1, 1)
    rings = codegen._ceil_to(2 * g.guard + g.levels * g.ring * g.ey * g.ex,
                             32)
    assert g.smem_bytes == 4 * (rings + 4 * g.ey * g.ex) + 8 * 4
    plan = plan_for("3d7pt_star", dims)
    for column in codegen.columns(plan, dims):
        try:
            g = codegen.geometry(plan, dims, column=column)
        except ValueError:      # a column whose rings exceed shared memory
            continue
        if g.tma:
            assert g.smem_bytes <= codegen.SMEM_LIMIT
            assert g.ctas_per_sm >= g.min_blocks
            assert g.ahead + 1 in (2, 4)


MAPS_RUNNER = """
import ctypes, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
n = int(sys.argv[2])
a = np.fromfile(sys.argv[3], dtype=np.uint8)
b = np.zeros_like(a)
lib.launch.argtypes = [ctypes.c_void_p] * 3
lib.maps_encoded.restype = ctypes.c_longlong
for _ in range(n):
    assert lib.launch(a.ctypes.data, b.ctypes.data, None) == 0
    assert lib.launch(b.ctypes.data, a.ctypes.data, None) == 0
print(lib.maps_encoded())
"""


def test_the_map_cache_keeps_two_maps_a_pair(tmp_path):
    """A map holds its buffer's address, so the C entry encodes one a
    buffer and keeps it: a ping-pong pair needs two, however many
    launches."""
    dims = (12, 12, 40)
    plan = plan_for("3d7pt_star", dims, cfg=KernelConfig(step=1,
                                                         trapezoid=True))
    assert codegen.geometry(plan, dims).tma
    text = codegen.cuda_source(plan, dims, "float32", False)
    emulated(text, tmp_path)        # builds tmp_path / kernel.so
    state = tmp_path / "state.bin"
    np.random.default_rng(3).uniform(0, 1, dims).astype(
        np.float32).view(np.uint8).tofile(state)
    counts = []
    for n in (1, 4):
        run = subprocess.run([sys.executable, "-c", MAPS_RUNNER,
                              str(tmp_path / "kernel.so"), str(n),
                              str(state)],
                             capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        counts.append(int(run.stdout))
    assert counts == [2, 2]


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    """Plan counters from zero, plans kept apart under ``tmp_path``, a
    stand-in ``nvcc`` and libraries whose C entry counts the maps a
    launch of a new source buffer would encode."""
    monkeypatch.setattr(kernels, "PLAN_DIR", str(tmp_path / "plans"))
    monkeypatch.setattr(kernels, "_PLANS", {})

    def fake_nvcc(source, out):
        time.sleep(0.01)
        with open(out, "wb"):
            pass
        return "ptxas info    : Used 72 registers\n"

    class FakeLib:
        def __init__(self, path):
            self.sources = set()
            self.error_string = lambda err: b""

            def launch(src, dst, *rest):
                self.sources.add(src)
                return 0

            self.launch = launch
            self.maps_encoded = lambda: len(self.sources)

    monkeypatch.setattr(kernels, "_run_nvcc", fake_nvcc)
    monkeypatch.setattr(kernels.ctypes, "CDLL", FakeLib)
    kernels.reset_plan_counters()
    yield
    kernels.reset_plan_counters()


def test_the_counter_and_the_wrapper_count_tma_plans_and_maps(fake_build):
    spec = bench_spec("3d7pt_star")
    star = plan_for("3d7pt_star", spec.dims)
    box = plan_for("3d27pt_box", spec.dims)
    deep = plan_for("3d13pt_star", spec.dims,
                    cfg=KernelConfig(step=5, trapezoid=True))
    assert codegen.geometry(star, spec.dims).tma
    assert not codegen.geometry(box, spec.dims).window
    assert not codegen.geometry(deep, spec.dims).window
    kernels.build_plans([(star, spec.dims, dt, False, 132)
                         for dt in codegen.DTYPES]
                        + [(box, spec.dims, "float32", False, 132),
                           (deep, spec.dims, "float32", False, 132)])
    got = kernels.plan_counters()
    assert (got["builds"], got["windowed_3d"], got["tma_3d"]) == (4, 2, 2)
    # the wrapper reads its plans' C entries: two maps a ping-pong pair
    plan = kernels.plan_kernel(star, spec.dims, "float32", sms=132)
    assert plan.tma and plan.maps_encoded() == 0
    wrapper = kernels.LevelsKernel("stencil3d_levels", 3,
                                   kernels.stencil3d_levels_ref, "")
    wrapper._plans[("pair",)] = (star, plan)
    for _ in range(10):
        plan.launch(1 << 20, 2 << 20, (), 0)
        plan.launch(2 << 20, 1 << 20, (), 0)
    assert plan.maps_encoded() == wrapper.maps_encoded == 2
    ring = kernels.plan_kernel(box, spec.dims, "float32", sms=132)
    assert not ring.tma and ring.maps_encoded() == 0
