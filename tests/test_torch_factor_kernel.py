"""The factor-mode kernel's per-plan text (``ops/codegen.cuda_source`` on a
``FactorTaps``: ``stencil2d_factor_levels``).

No card and no ``nvcc`` here, so the text is checked as text (the three
tables' literals and ``fmaf`` order, V2's and R's chains joined by one
add, the constants against ``tile_shape`` / ``smem_bytes`` /
``traffic_model``) and as a program under the ``g++`` emulation of
``tests/test_torch_codegen.py``, held against the plain version (fp32 within
1e-5 relative, bf16 within one bf16 ulp, every cell outside the stored
region untouched) on small grids, grids narrower than the strip and widths
that are no multiple of 4; one case runs a whole pair through the emulated
kernel against the JAX package in interpret mode.
"""

import re

import numpy as np
import pytest
import torch

from drstencil_tpu.ops.config import KernelConfig as JConfig
from drstencil_tpu.ops.runner import StencilProgram as JProgram
from drstencil_tpu_torch import emit as emit_mod
from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.ops.stream import level_plan
from drstencil_tpu_torch.utils.profiling import traffic_model

from conftest import small_spec
from test_torch_codegen import (KERNEL_TOL, bench_spec, bf16_ulp, constants,
                                emulated)

FACTORABLE = ["2d25pt_box", "2d9pt_star", "2d9pt_cross"]


def factor_plan(name, step, dims=None, dtype="float32"):
    spec = bench_spec(name, dims)
    an = analyze(spec, step)
    return spec, an, level_plan(an, KernelConfig(step=step, factor=True,
                                                 dtype=dtype))


def chain(cuda, fn, acc):
    """(literal, window expression, tap comment) of ``fn``'s ``fmaf``
    lines into ``acc0``, in order."""
    body = cuda.split(f"float4 {fn}(")[1].split("return make_float4")[0]
    out = []
    for line in body.splitlines():
        found = re.findall(rf"{acc}(\d) = fmaf\((\S+f), ([\w.\[\]]+), "
                           rf"{acc}(\d)\);", line)
        if found:
            assert [(a, b) for a, _, _, b in found] == [
                (str(j), str(j)) for j in range(codegen.QUAD)]
            off = tuple(int(v) for v in re.search(
                r"// \((.*)\)$", line).group(1).split(","))
            out.append((found[0][1], found[0][2], off))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("name", FACTORABLE)
def test_factor_text(name, step, dtype):
    """Each table is one fmaf chain from 0 in its sorted order with its
    float32 literals; an even level adds R's chain to V2's with one add;
    the constants are the geometry's and the models'."""
    spec, an, plan = factor_plan(name, step, dtype=dtype)
    dims = tuple(spec.dims)
    cuda = codegen.cuda_source(plan, dims, dtype, False)
    for fn, acc, (offsets, coeffs) in (("level_v1", "a", plan.v1),
                                       ("level_v2r", "a", plan.v2),
                                       ("level_v2r", "c", plan.r)):
        taps = chain(cuda, fn, acc)
        assert [off for _, _, off in taps] == [tuple(o) for o in
                                               offsets.tolist()]
        assert [emit_mod.literal_value(lit) for lit, _, _ in taps] == [
            float(np.float32(c)) for c in coeffs.tolist()]
    # R reads the level two below from its register window, nothing else
    assert all(expr.startswith("w2[") for _, expr, _ in chain(
        cuda, "level_v2r", "c"))
    assert "return make_float4(a0 + c0, a1 + c1, a2 + c2, a3 + c3);" in cuda
    assert cuda.count("= fmaf(") == codegen.QUAD * plan.taps_per_step
    assert cuda.count("level_v1(") == plan.levels // 2 + 1
    assert cuda.count("level_v2r(") == plan.levels // 2 + 1
    assert "level_quad" not in cuda and "coef" not in cuda
    c = constants(cuda)
    g = codegen.geometry(plan, dims)
    assert g.factor and g.window and g.vec
    assert (c["M"], c["N"], c["H"], c["LEVELS"], c["REACH"]) == (
        *dims, plan.frame, plan.levels, 1)
    assert "constexpr int WINDOW = 4 * REACH + 2;" in cuda
    assert (c["TAIL"], c["RING"]) == (1, 4)
    assert (c["SEG"], c["TX"]) == g.tile == kernels.tile_shape(plan, dims)
    assert c["AHEAD"] == codegen.AHEAD_2D
    assert c["SMEM_BYTES"] == g.smem_bytes == kernels.smem_bytes(plan, dims) \
        == traffic_model(an, KernelConfig(step=step, factor=True,
                                          dtype=dtype)).smem_bytes
    assert (c["THREADS"], c["MIN_BLOCKS"]) == (g.threads, g.min_blocks)
    # at steps 1 and 2 the windows fit WINDOW_REGS: four CTAs per SM
    assert codegen.window_regs(plan) <= codegen.WINDOW_REGS
    assert g.min_blocks == 4
    grid = re.search(r"const dim3 grid\(([\d, ]+)\);", cuda).group(1)
    assert tuple(int(v) for v in grid.split(",")) == g.grid
    assert ("typedef __nv_bfloat16 T;" in cuda) == (dtype == "bfloat16")
    assert 'extern "C" int launch(const void* src, void* dst, void* stream)' \
        in cuda


def test_factor_plans_key_and_refuse_a_shard_build():
    _, _, plan = factor_plan("2d25pt_box", 2)
    _, _, other = factor_plan("2d9pt_star", 2)
    dims = (8192, 8192)
    keys = {kernels.plan_key(p, dims, "float32") for p in (plan, other)}
    assert len(keys) == 2
    assert kernels.plan_key(plan, dims, torch.float32) \
        == kernels.plan_key(plan, dims, "float32")
    assert kernels.plan_of(plan, dims, "float32", False).geometry.factor
    with pytest.raises(codegen.EmitError, match="no shard-local build"):
        codegen.cuda_source(plan, dims, "float32", True)
    # steps 3 and 4: windows beyond WINDOW_REGS, so two CTAs per SM
    _, _, deep = factor_plan("2d25pt_box", 3)
    assert codegen.window_regs(deep) > codegen.WINDOW_REGS
    assert codegen.geometry(deep, dims).min_blocks == 2


def run_emulated(tmp_path, name, step, dims, dtype="float32"):
    """The factor text under the emulation against the plain version on a
    random source and a random destination."""
    spec, _, plan = factor_plan(name, step, dims, dtype)
    launch = emulated(codegen.cuda_source(plan, dims, dtype, False), tmp_path)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.uniform(0, 100, dims)).to(tdt)
    fill = torch.from_numpy(rng.uniform(-0.5, 0.5, dims)).to(tdt)
    want = fill.clone()
    got = launch(src, fill)
    kernels.stencil2d_factor_levels.plain(src, want, plan)
    diff = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    assert not got.float().isnan().any()
    if dtype == "float32":
        assert float(diff.max()) <= KERNEL_TOL * top
    else:
        assert bool((diff <= bf16_ulp(want) + KERNEL_TOL * top).all())
    H = plan.frame
    outside = torch.ones(dims, dtype=torch.bool)
    outside[H:dims[0] - H, H:dims[1] - H] = False
    assert torch.equal(got[outside], fill[outside])
    return codegen.geometry(plan, dims)


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("name", FACTORABLE)
def test_emulated_factor_equals_plain(tmp_path, name, step):
    """Several strips and segments."""
    g = run_emulated(tmp_path, name, step, (40, 1100))
    assert g.grid[0] > 1 and g.grid[1] > 1 and g.ahead


@pytest.mark.parametrize("name,step,dims,dtype", [
    ("2d25pt_box", 2, (40, 1100), "bfloat16"),
    ("2d9pt_cross", 1, (30, 600), "bfloat16"),
    ("2d9pt_star", 2, (24, 200), "float32"),
    ("2d25pt_box", 1, (33, 37), "bfloat16"),
    ("2d9pt_cross", 2, (40, 601), "float32"),
    ("2d25pt_box", 3, (60, 300), "float32"),
    ("2d9pt_star", 4, (48, 130), "float32"),
], ids=["bf16_step2", "bf16_step1", "narrow", "narrow_odd_bf16",
        "odd_width", "step3", "step4"])
def test_emulated_factor_variants_equal_plain(tmp_path, name, step, dims,
                                              dtype):
    g = run_emulated(tmp_path, name, step, dims, dtype)
    if dims[1] < codegen.STRIP_2D[0]:
        # one strip, wider than the grid: idle threads beside the quads
        assert g.grid[0] == 1 and g.threads * 4 > dims[1]
    assert g.vec == (dims[1] % 4 == 0) and bool(g.ahead) == g.vec


def test_emulated_factor_pair_matches_jax_interpret(tmp_path):
    """One pair of the emulated kernel from the program's state against
    the JAX package's factor program in interpret mode (the gate of
    ``tests/test_torch_factor.py``: 1e-4 of max|JAX|)."""
    jspec = small_spec("2d25pt_box")
    jp = JProgram(jspec, JConfig(variant="stream", step=2, tm=24,
                                 factor=True, interpret=True))
    want = jp.final_a(jp.run_pairs(jp.init_state(0), 1))
    prog = StencilProgram(bench_spec("2d25pt_box", jspec.dims),
                          KernelConfig(step=2, factor=True), device="cpu")
    plan = level_plan(prog.an, prog.cfg)
    launch = emulated(codegen.cuda_source(plan, jspec.dims, "float32",
                                          False), tmp_path)
    state = prog.init_state(0)
    b = launch(state["a"], state["b"])
    a = launch(b, state["a"])
    got = a.numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-4, f"rel={rel}"
