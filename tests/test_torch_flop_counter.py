"""The plan counters of the levels kernels' arithmetic (``ops/kernels``):
``block_fused``, the plans whose levels apply a block-step fused operator
(``KernelConfig.block > 1``, block-hybrid K7), and ``flops`` and
``cell_steps``, summed over the launches on CUDA tensors (``LaunchWork``).

No card here: the launches run through the wrapper with a stand-in ``nvcc``
and library, and each launch's counts are held to a count listed from the
plan's own text, CTA by CTA, level by level, row by row.  The block is no
part of a plan's text.  Then the K7 text itself under the ``g++`` emulation
against the base table applied eight times in fp64.
"""

import dataclasses
import json
import math
import os
import re

import numpy as np
import pytest
import torch

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.ops.stream import level_plan

from stencilbench import reference
from test_torch_codegen import bench_spec, constants, emulated
from test_torch_window3d import counters  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K7 = KernelConfig(step=8, trapezoid=True, block=2)
# the fp32 cells' limit of max_rel_err, as the benchmark's cell holds it
with open(os.path.join(ROOT, "stencilbench", "workloads",
                       "2d5pt_cross.solve48.json")) as _f:
    FP32_LIMIT = json.load(_f)["limits"]["max_rel_err"]


def plan_for(name, cfg, dims):
    spec = bench_spec(name, dims)
    return spec, level_plan(analyze(spec, cfg.step, cfg.distance,
                                    cfg.merge_forward), cfg)


# -- block_fused ----------------------------------------------------------------

@pytest.mark.parametrize("name,cfg,fused", [
    ("2d5pt_cross", K7, 1),
    ("2d5pt_cross", KernelConfig(step=8, trapezoid=True, block=4), 1),
    ("3d7pt_star", KernelConfig(step=4, trapezoid=True, block=2), 1),
    ("2d5pt_cross", KernelConfig(step=8, trapezoid=True), 0),
    ("2d25pt_box", KernelConfig(step=3, trapezoid=True), 0),
    ("2d5pt_cross", KernelConfig(step=8), 0),
    ("2d25pt_box", KernelConfig(step=2, factor=True), 0),
])
def test_block_fused_counts_block_step_plans(counters, name,  # noqa: F811
                                             cfg, fused):
    """The plan of ``block 2, step 8`` (and of any block above 1) counts;
    base levels (block 1), one coefficient-fused level (K1) and factor mode
    do not."""
    dims = (60, 600) if name.startswith("2d") else (40, 24, 40)
    spec, plan = plan_for(name, cfg, dims)
    kernels.plan_kernel(plan, spec.dims, "float32", False, sms=132)
    got = kernels.plan_counters()
    assert (got["builds"], got["block_fused"]) == (1, fused)
    assert plan.timesteps == cfg.step


@pytest.mark.parametrize("block", [1, 2, 4])
def test_the_block_is_no_part_of_the_text(block):
    """A table of ``fuse(base, 2)`` says the same text, hash and library
    stem whatever its ``block``; only the plan's key and counters tell."""
    spec, plan = plan_for("2d5pt_cross", K7, (60, 600))
    other = dataclasses.replace(plan, block=block)
    text = codegen.cuda_source(plan, spec.dims, "float32", False)
    assert codegen.cuda_source(other, spec.dims, "float32", False) == text
    assert (kernels.plan_key(other, spec.dims, "float32")
            == kernels.plan_key(plan, spec.dims, "float32")) == (block == 2)
    assert other.block_fused == (block > 1)


# -- flops and cell_steps ---------------------------------------------------------

LEVEL = re.compile(r"// level (\d+) of \d+: rows \[(\d+), (\d+)\) x quads "
                   r"\[(\d+), (\d+)\)")


def listed(cuda, store, timesteps):
    """``flops`` and ``cell_steps`` of one launch of the text, listed: every
    CTA of its grid, with the segment ``[a0, a1)`` it stores; every level of
    it, each output row its guard lets through, times the rows and quads of
    the level's region, times the flops of the level's function (its
    ``fmaf``s over four cells, times two, less one)."""
    c = constants(cuda)
    grid = [int(v) for v in re.search(r"const dim3 grid\(([\d, ]+)\);",
                                      cuda).group(1).split(",")]
    dims = [c[k] for k in ("D", "M", "N") if k in c]
    H, seg = c["H"], c["SEG"]
    lo, hi = store or (H, dims[0] - H)
    found = list(LEVEL.finditer(cuda))
    levels = []
    for m, nxt in zip(found, found[1:] + [None]):
        block = cuda[m.start():nxt.start() if nxt else len(cuda)]
        first = (re.search(r"if \(p < (\d+)\) continue;", block)
                 or re.search(r"if \(p >= (-?\d+) &&", block))
        past = re.search(r"p < n0 \+ (\d+)\)", block)
        fn = re.search(r"\b(level_\w+)\(", block).group(1)
        body = re.search(rf"__device__ __forceinline__ \w+ {fn}\(.*?\n}}",
                         cuda, re.S).group(0)
        flops = 2 * body.count("fmaf(") // codegen.QUAD - 1
        y0, y1, q0, q1 = (int(v) for v in m.groups()[1:])
        levels.append((int(first.group(1)), int(past.group(1)), flops,
                       (y1 - y0) * codegen.QUAD * (q1 - q0)))
    assert sorted(int(m.group(1)) for m in found) == list(
        range(1, c["LEVELS"] + 1))
    flops = 0
    for _column in range(math.prod(grid[:-1])):
        for k in range(grid[-1]):
            a0 = lo + k * seg
            a1 = min(a0 + seg, hi)
            if a0 >= a1:
                continue
            for p_first, p_past, per_cell, cells in levels:
                for _p in range(p_first, a1 - a0 + p_past):
                    flops += per_cell * cells
    plane = math.prod(d - 2 * H for d in dims[1:])
    return {"flops": flops, "cell_steps": (hi - lo) * plane * timesteps}


CASES = {
    # a windowed 2D plan, its levels in partial sums
    "partial_2d": ("2d25pt_box", KernelConfig(step=3, trapezoid=True),
                   (60, 600), None),
    # the block-hybrid plan: fuse(base, 2) as four levels
    "k7": ("2d5pt_cross", K7, (60, 600), None),
    "k7_shard": ("2d5pt_cross", K7, (76, 600), (20, 52)),
    "ring_2d": ("2d25pt_box", KernelConfig(step=5, trapezoid=True),
                (60, 600), None),
    "window_3d": ("3d7pt_star", KernelConfig(step=4, trapezoid=True),
                  (40, 24, 40), None),
    "ring_3d": ("3d27pt_box", KernelConfig(step=2, trapezoid=True),
                (30, 20, 24), None),
    "factor": ("2d25pt_box", KernelConfig(step=2, factor=True),
               (60, 600), None),
    "fused_k1": ("2d5pt_star", KernelConfig(step=2), (40, 200), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_launch_counts_the_cells_its_text_computes(counters,  # noqa: F811
                                                     case):
    name, cfg, dims, store = CASES[case]
    spec, plan = plan_for(name, cfg, dims)
    g = codegen.geometry(plan, dims, 132)
    kind = {"partial_2d": g.partial, "k7": g.partial and plan.block_fused,
            "k7_shard": g.partial, "ring_2d": not g.window,
            "window_3d": g.window3d, "ring_3d": not g.window,
            "factor": g.factor, "fused_k1": plan.levels == 1}[case]
    assert kind
    shard = store is not None
    wrapper = (kernels.stencil2d_factor_levels if g.factor
               else kernels.kernel_for(len(dims), shard))
    src, dst = torch.zeros(dims), torch.zeros(dims)
    wrapper._launch(src, dst, plan, store or (), 0)
    cuda = codegen.cuda_source(plan, dims, "float32", shard, sms=132)
    want = listed(cuda, store, cfg.step)
    got = kernels.plan_counters()
    assert {k: got[k] for k in want} == want
    assert want["flops"] > 0 and want["cell_steps"] > 0
    # every launch adds its counts again
    wrapper._launch(src, dst, plan, store or (), 0)
    got = kernels.plan_counters()
    assert {k: got[k] for k in want} == {k: 2 * v for k, v in want.items()}


@pytest.mark.parametrize("name,cfg", [
    ("2d5pt_cross", K7),
    ("2d25pt_box", KernelConfig(step=3, trapezoid=True)),
    ("3d7pt_star", KernelConfig(step=4, trapezoid=True)),
])
def test_nothing_is_counted_on_the_cpu(counters, name, cfg):  # noqa: F811
    """The plain versions' calls count no flops, cell-steps, plans or
    launches."""
    dims = (60, 80) if name.startswith("2d") else (28, 24, 20)
    spec = bench_spec(name, dims)
    prog = StencilProgram(spec, cfg, device="cpu")
    kernels.reset_launches()
    state = {"a": torch.rand(dims), "b": torch.zeros(dims)}
    prog.run_pairs(state, 1)
    got = kernels.plan_counters()
    assert (got["flops"], got["cell_steps"], got["block_fused"],
            got["disk_hits"] + got["builds"]) == (0, 0, 0, 0)
    assert sum(k.launches for k in kernels.KERNELS) == 0


# -- the K7 text ------------------------------------------------------------------

def base_eight_times(field, taps):
    """The base table applied eight times in fp64, each time on the cells
    whose whole table lies inside: the interior ``[8, dim - 8)``."""
    cur = field.to(torch.float64)
    for _ in range(8):
        inner = [d - 2 for d in cur.shape]
        cur = sum(c * cur[tuple(slice(1 + o, 1 + o + n)
                                for o, n in zip(off, inner))]
                  for off, c in taps.items())
    return cur


@pytest.mark.parametrize("dims", [(56, 1100), (40, 200)])
def test_the_k7_text_is_the_base_table_eight_times(tmp_path, dims):
    """Several strips and segments, and a strip narrower than its warps."""
    spec, plan = plan_for("2d5pt_cross", K7, dims)
    assert plan.block_fused and codegen.geometry(plan, dims).partial
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.uniform(0, 100, dims)).float()
    fill = torch.from_numpy(rng.uniform(-1, 1, dims)).float()
    got = emulated(codegen.cuda_source(plan, dims, "float32", False),
                   tmp_path)(src, fill.clone())
    _, taps = reference.load_stc(f"{ROOT}/benchmarks/2d5pt_cross.stc")
    H = plan.frame
    inner = (slice(H, dims[0] - H), slice(H, dims[1] - H))
    want = base_eight_times(src, taps)
    assert reference.max_rel_err(got[inner], want) < FP32_LIMIT
    outside = torch.ones(dims, dtype=torch.bool)
    outside[inner] = False
    assert torch.equal(got[outside], fill[outside])
