"""The plan counters of the ring 3D text and of the levels kernels'
shared-memory loads (``ops/kernels``): ``ring_3d``, the 3D plans that keep no
register windows, and ``smem_loads``, summed over the launches on CUDA
tensors (``LaunchWork``, from ``codegen.level_loads``).

No card here: the launches run through the wrapper with a stand-in ``nvcc``
and library, and each launch's count is held to a count listed from the
plan's own text: the shared-memory load statements of its level function
(a load that only a warp's end lanes run, for those lanes), times the quads
each level's block computes, CTA by CTA, level by level, step by step.
"""

import math
import re

import pytest
import torch

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.ops.stream import level_plan
from drstencil_tpu_torch.tune.tuned import best_config

from conftest import BENCH_DIR
from test_torch_codegen import bench_spec, constants, level_fn
from test_torch_flop_counter import plan_for
from test_torch_window3d import counters  # noqa: F401 (a fixture)

RING_3D = KernelConfig(step=2, trapezoid=True)


def winner(name):
    """The plan of ``name``'s winner in the port's table, at its ``.stc``
    size."""
    spec = load_stc(f"{BENCH_DIR}/{name}.stc")
    cfg = best_config(name)
    return spec, level_plan(analyze(spec, cfg.step, cfg.distance,
                                    cfg.merge_forward), cfg)


# -- ring_3d ----------------------------------------------------------------------

@pytest.mark.parametrize("name,ring", [
    ("3d27pt_box", 1), ("3d9pt_cross", 1),
    ("3d7pt_star", 0), ("3d13pt_star", 0),
    ("2d25pt_box", 0), ("2d5pt_cross", 0), ("2d9pt_box", 0),
])
def test_ring_3d_counts_the_3d_winners_without_windows(counters,  # noqa: F811
                                                       name, ring):
    spec, plan = winner(name)
    g = codegen.geometry(plan, spec.dims, 132)
    assert (g.ndim == 3 and not g.window) == bool(ring)
    kernels.plan_kernel(plan, spec.dims, "float32", False, sms=132)
    got = kernels.plan_counters()
    assert (got["builds"], got["ring_3d"]) == (1, ring)
    assert got["windowed_3d"] == (g.ndim == 3) - ring


def test_a_factor_plan_is_no_ring_3d_plan(counters):  # noqa: F811
    spec, plan = plan_for("2d25pt_box", KernelConfig(step=2, factor=True),
                          (60, 600))
    kernels.plan_kernel(plan, spec.dims, "float32", False, sms=132)
    got = kernels.plan_counters()
    assert (got["builds"], got["ring_3d"], got["smem_loads"]) == (1, 0, 0)


# -- smem_loads, listed from the text ---------------------------------------------

LEVEL = re.compile(r"// level (\d+) of \d+: rows \[\d+, \d+\) x quads")
# a load from a plane (row) in shared memory: b_m1[at + ...], or a vector of
# it from (b_m1 + at + ...); the partial-sum text's row is `b`
LOAD = re.compile(r"\bb\w*\[at \+|reinterpret_cast<const float[24]?\*>"
                  r"\(b\w* \+ at \+")
EDGE = re.compile(r"lane (<|>=) (\d+) \?")


def text_loads(cuda):
    """(loads every thread runs, ``[lo, hi)`` lanes of each load only some
    lanes run) of the text's level function, one statement a line."""
    _, body = level_fn(cuda)
    each, lanes = 0, []
    for line in body.splitlines():
        if not LOAD.search(line):
            continue
        edge = EDGE.search(line)
        if edge is None:
            each += 1
        elif edge.group(1) == "<":
            lanes.append((0, int(edge.group(2))))
        else:
            lanes.append((int(edge.group(2)), 32))
    return each, lanes


def step_loads(block, each, lanes, c):
    """Loads one CTA runs in a step of the level ``block`` of the text: its
    ring loop's quads, or its windowed threads' quads (with the lanes that
    take each edge load)."""
    ring = re.search(r"for \(int i = threadIdx.x; i < (\d+); i \+= THREADS\)",
                     block)
    if ring:
        return each * int(ring.group(1))
    box = re.search(r"if \((?:row >= (\d+) && row < (\d+) && )?q >= (\d+) && "
                    r"q < (\d+)\) do \{", block)
    r0, r1 = (int(v) for v in box.groups()[:2]) if box.group(1) else (0, 1)
    q0, q1 = (int(v) for v in box.groups()[2:])
    qx = c["EX"] // codegen.QUAD
    total = 0
    for i in range(c["THREADS"]):
        row, q = (i // qx, i % qx) if box.group(1) else (0, i)
        if r0 <= row < r1 and q0 <= q < q1:
            total += each + sum(lo <= i % 32 < hi for lo, hi in lanes)
    return total


def listed(cuda, store):
    """``smem_loads`` of one launch of the text storing the axis-0 range
    ``store`` (the whole interior where None): every CTA of its grid, with
    its segment ``[a0, a1)``; every level of it, every step its guard lets
    through, the loads its block runs."""
    c = constants(cuda)
    grid = [int(v) for v in re.search(r"const dim3 grid\(([\d, ]+)\);",
                                      cuda).group(1).split(",")]
    dims = [c[k] for k in ("D", "M", "N") if k in c]
    H, seg = c["H"], c["SEG"]
    lo, hi = store or (H, dims[0] - H)
    each, lanes = text_loads(cuda)
    found = list(LEVEL.finditer(cuda))
    assert sorted(int(m.group(1)) for m in found) == list(
        range(1, c["LEVELS"] + 1))
    levels = []
    for m, nxt in zip(found, found[1:] + [None]):
        block = cuda[m.start():nxt.start() if nxt else len(cuda)]
        guard = re.search(r"if \(p >= (-?\d+) && p < n0 \+ (\d+)\)", block)
        levels.append((int(guard.group(1)), int(guard.group(2)),
                       step_loads(block, each, lanes, c)))
    total = 0
    for _column in range(math.prod(grid[:-1])):
        for k in range(grid[-1]):
            a0 = lo + k * seg
            a1 = min(a0 + seg, hi)
            if a0 >= a1:
                continue
            for p_first, p_past, per_step in levels:
                for _p in range(p_first, a1 - a0 + p_past):
                    total += per_step
    return total


CASES = {
    # the ring 3D text: the 27-point box, and the cross at reach 2
    "ring_3d": ("3d27pt_box", RING_3D, (30, 20, 24)),
    "ring_3d_cross": ("3d9pt_cross", KernelConfig(step=3, trapezoid=True,
                                                  distance=2),
                      (40, 24, 40)),
    # a windowed 2D plan, its levels in partial sums, and the K7 plan
    "partial_2d": ("2d25pt_box", KernelConfig(step=3, trapezoid=True),
                   (60, 600)),
    "k7": ("2d5pt_cross", KernelConfig(step=8, trapezoid=True, block=2),
           (60, 600)),
    # windowed 3D plans: their own row's cells beside the quad at a warp's
    # two ends from shared memory
    "window_3d": ("3d7pt_star", KernelConfig(step=4, trapezoid=True),
                  (40, 24, 40)),
    "window_3d_13": ("3d13pt_star", KernelConfig(step=2, trapezoid=True),
                     (40, 24, 40)),
    # the 2D ring text, and one coefficient-fused level (K1)
    "ring_2d": ("2d25pt_box", KernelConfig(step=5, trapezoid=True),
                (60, 600)),
    "fused_k1": ("2d5pt_star", KernelConfig(step=2), (40, 200)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_a_launch_counts_the_loads_its_text_runs(counters,  # noqa: F811
                                                 case, dtype):
    name, cfg, dims = CASES[case]
    spec, plan = plan_for(name, cfg, dims)
    g = codegen.geometry(plan, dims, 132)
    kind = {"ring_3d": g.ndim == 3 and not g.window,
            "ring_3d_cross": g.ndim == 3 and not g.window,
            "partial_2d": g.partial, "k7": g.partial and plan.block_fused,
            "window_3d": g.window3d, "window_3d_13": g.window3d,
            "ring_2d": g.ndim == 2 and not g.window,
            "fused_k1": plan.levels == 1}[case]
    assert kind
    wrapper = kernels.kernel_for(len(dims), False)
    src, dst = torch.zeros(dims, dtype=dtype), torch.zeros(dims, dtype=dtype)
    wrapper._launch(src, dst, plan, (), 0)
    cuda = codegen.cuda_source(plan, dims, kernels.DTYPE_NAMES[dtype], False,
                               sms=132)
    want = listed(cuda, None)
    assert want > 0
    assert kernels.plan_counters()["smem_loads"] == want
    # every launch adds its count again
    wrapper._launch(src, dst, plan, (), 0)
    assert kernels.plan_counters()["smem_loads"] == 2 * want


@pytest.mark.parametrize("case,each,lanes", [
    # 9 tap rows, each a float4 and two scalars
    ("ring_3d", 27, ()),
    # the partial-sum row: two 8-byte loads beside the quad
    ("partial_2d", 2, ()),
    # the rows above and below, and the cells beside the quad at lanes 0, 31
    ("window_3d", 2, ((0, 1), (31, 32))),
])
def test_the_quad_step_says_what_its_text_loads(case, each, lanes):
    name, cfg, dims = CASES[case]
    _, plan = plan_for(name, cfg, dims)
    g = codegen.geometry(plan, dims, 132)
    cuda = codegen.cuda_source(plan, dims, "float32", False, sms=132)
    assert text_loads(cuda) == (each, list(lanes))
    loads = (codegen._partial_row(plan)[1] if g.partial
             else codegen._level_quad(plan, g)[3])
    assert loads == codegen.QuadLoads(each, lanes)


@pytest.mark.parametrize("store", [(2, 38), (9, 31), (2, 3), (5, 5)])
def test_a_shard_launch_counts_the_loads_of_its_store_range(
        counters, store):  # noqa: F811
    """The ring plan's shard build on a 40-plane slab, segments of 8 planes:
    a store range over several segments, one cut inside, one plane, none."""
    spec, plan = plan_for("3d27pt_box", RING_3D.replace(tm=8), (40, 20, 24))
    g = codegen.geometry(plan, spec.dims, 132)
    assert g.tile[0] == 8 and not g.window
    cuda = codegen.cuda_source(plan, spec.dims, "float32", True, sms=132)
    want = listed(cuda, store)
    work = kernels.LaunchWork(plan, g)
    assert work.counts(store[1] - store[0])[2] == want
    assert (want > 0) == (store[1] > store[0])
    if store[1] - store[0] > 8:
        assert want > work.counts(8)[2]
    wrapper = kernels.kernel_for(3, True)
    src, dst = torch.zeros(spec.dims), torch.zeros(spec.dims)
    wrapper._launch(src, dst, plan, store, 0)
    assert kernels.plan_counters()["smem_loads"] == want


def test_the_winner_reads_27_loads_a_quad_level():
    """The cell's closed form: 27 loads over four cells a level, times the
    cells the ring plan computes over those it stores, as the flops."""
    spec, plan = winner("3d27pt_box")
    g = codegen.geometry(plan, spec.dims, 132)
    flops, cell_steps, loads = kernels.LaunchWork(plan, g).whole
    taps = len(plan.coeffs)
    assert loads / cell_steps == pytest.approx(
        27 / 4 * flops / cell_steps / (2 * taps - 1), rel=1e-12)
    assert loads / cell_steps == pytest.approx(7.590853858873072, rel=1e-12)


@pytest.mark.parametrize("name,cfg", [
    ("3d27pt_box", RING_3D),
    ("2d25pt_box", KernelConfig(step=3, trapezoid=True)),
    ("3d7pt_star", KernelConfig(step=4, trapezoid=True)),
])
def test_nothing_is_counted_on_the_cpu(counters, name, cfg):  # noqa: F811
    """The plain versions' calls count no loads and no plans."""
    dims = (60, 80) if name.startswith("2d") else (28, 24, 20)
    spec = bench_spec(name, dims)
    prog = StencilProgram(spec, cfg, device="cpu")
    state = {"a": torch.rand(dims), "b": torch.zeros(dims)}
    prog.run_pairs(state, 1)
    got = kernels.plan_counters()
    assert (got["smem_loads"], got["ring_3d"], got["cell_steps"],
            got["disk_hits"] + got["builds"]) == (0, 0, 0, 0)
