"""Factor mode of the port (ir/factor.py, ops/stream.factor_plan, the plain
version of ``stencil2d_factor_levels``) against the JAX package.

The factor tables must be bit-equal to the JAX package's (same numpy, same
seed), so both kernels apply the same V1, V2 and R.  The factored program
on ``device="cpu"`` is held against the JAX program in Pallas interpret
mode on the same numpy state, and against the fp64 golden model within the
tolerances of ``tests/test_factor.py``.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from drstencil_tpu.ir import factor as jfactor
from drstencil_tpu.ir import passes as jpasses
from drstencil_tpu.ops import stream as jstream
from drstencil_tpu.ops.config import KernelConfig as JConfig
from drstencil_tpu.ops.runner import StencilProgram as JProgram
from drstencil_tpu_torch import convert
from drstencil_tpu_torch.ir import factor as tfactor
from drstencil_tpu_torch.ir import passes as tpasses
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops import stream as tstream
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.utils.profiling import traffic_model

from conftest import small_spec

FACTORABLE = ["2d25pt_box", "2d9pt_star", "2d9pt_cross"]
NOT_FACTORABLE = [
    # radius-1 table: not a radius-2 factorization target
    {(0, 0): 1.0, (0, 1): 0.5, (1, 0): 0.5},
    # 3D taps
    {(0, 0, 0): 1.0, (0, 0, 2): 0.5},
    # radius-2 table that is not symmetric in axis 1
    {(0, 0): 1.0, (0, 2): 0.5, (0, -2): 0.25, (2, 0): 0.1},
]


def port_spec(jspec):
    return convert.spec_from_fields(jspec.name, jspec.dims, jspec.iterations,
                                    jspec.taps)


def port_program(name, dims=None, **cfg):
    return StencilProgram(port_spec(small_spec(name, dims)),
                          KernelConfig(variant="stream", factor=True, **cfg),
                          device="cpu")


@pytest.mark.parametrize("name", FACTORABLE)
def test_factor_tables_bit_equal_to_jax(name):
    taps = small_spec(name).taps
    for want, got in zip(jfactor.factor_radius2(taps),
                         tfactor.factor_radius2(taps)):
        np.testing.assert_array_equal(got, want)
    assert tfactor.factor_tap_lists(taps) == jfactor.factor_tap_lists(taps)


@pytest.mark.parametrize("taps", NOT_FACTORABLE,
                         ids=["radius1", "3d", "asymmetric"])
def test_factor_rejects_like_jax(taps):
    assert jfactor.factor_tap_lists(taps) is None
    assert tfactor.factor_tap_lists(taps) is None


@pytest.mark.parametrize("name", FACTORABLE)
@pytest.mark.parametrize("step", [1, 2, 3])
def test_factor_plan_is_the_jax_schedule(name, step):
    """2*step levels of reach H/(2*step) = 1 alternating V1 and V2, the
    residual at reach 2; the tables are the JAX lists rounded to fp32."""
    jspec = small_spec(name)
    an = tpasses.analyze(port_spec(jspec), step)
    plan = tstream.level_plan(an, KernelConfig(step=step, factor=True))
    assert kernels.is_factor(plan)
    assert (plan.levels, plan.reach, plan.frame) == (2 * step, 1, 2 * step)
    for (offs, coefs), jlist in zip((plan.v1, plan.v2, plan.r),
                                    jfactor.factor_tap_lists(jspec.taps)):
        assert [tuple(o) for o in offs.tolist()] == [t[:2] for t in jlist]
        np.testing.assert_array_equal(
            coefs, np.array([t[2] for t in jlist], np.float32))
    assert np.abs(plan.v1[0]).max() <= 1 and np.abs(plan.v2[0]).max() <= 1
    assert np.abs(plan.r[0][:, 0]).max() <= 2 and not plan.r[0][:, 1].any()
    assert plan.taps_per_step == sum(
        len(t) for t in jfactor.factor_tap_lists(jspec.taps))
    assert not tstream.is_deep(an, KernelConfig(step=step, factor=True,
                                                trapezoid=True))


@pytest.mark.parametrize("name", FACTORABLE)
@pytest.mark.parametrize("step", [1, 2, 3])
def test_factored_program_matches_jax_interpret(name, step):
    """One pair from the same numpy state.  fp32 gate: 1e-4 of max|JAX|,
    looser than the other modes' 1e-5 because V1*V2 and R may reach 30x the
    table's scale and cancel (measured here: <= 1.2e-6)."""
    jspec = small_spec(name)
    jp = JProgram(jspec, JConfig(variant="stream", step=step, tm=24,
                                 factor=True, interpret=True))
    want = jp.final_a(jp.run_pairs(jp.init_state(0), 1))
    prog = port_program(name, step=step)
    got = prog.final_a(prog.run_pairs(prog.init_state(0), 1))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-4, f"rel={rel}"


@pytest.mark.parametrize("name", FACTORABLE)
def test_factored_bf16_program_matches_jax_interpret(name):
    """bf16 state, fp32 levels, one rounding per launch in both packages:
    within the bf16 gate, 1e-2 of max|JAX| (two bf16 ulps of the largest
    value; an fp32 difference before the rounding may flip it by one)."""
    jspec = small_spec(name)
    jp = JProgram(jspec, JConfig(variant="stream", step=2, tm=32,
                                 factor=True, dtype="bfloat16",
                                 interpret=True))
    want = np.asarray(jp.final_a(jp.run_pairs(jp.init_state(0), 1)),
                      np.float32)
    prog = port_program(name, step=2, dtype="bfloat16")
    got = prog.final_a(prog.run_pairs(prog.init_state(0), 1))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-2, f"rel={rel}"


@pytest.mark.parametrize("name", FACTORABLE)
@pytest.mark.parametrize("step", [1, 2])
def test_factored_program_matches_golden(name, step):
    """The fp64 golden within tests/test_factor.py's tolerances."""
    prog = port_program(name, step=step)
    max_err, rms = prog.check(seed=0, pairs=1)
    growth = max(1.0, sum(prog.spec.taps.values())) ** (2 * step)
    assert max_err < 5e-3 * growth, f"max_err={max_err}"
    assert rms < 1e-3 * growth


def test_factored_program_step3_and_odd_grid():
    """Step 3 (six levels) on a grid that no tile
    divides, against the golden and the unfactored program."""
    prog = port_program("2d25pt_box", dims=(67, 131), step=3)
    max_err, _ = prog.check(seed=1, pairs=1)
    growth = max(1.0, sum(prog.spec.taps.values())) ** 6
    assert max_err < 5e-3 * growth, max_err
    assert prog.device_check(seed=1, pairs=1) <= 1e-5
    plain = StencilProgram(prog.spec, KernelConfig(step=3, trapezoid=True),
                           device="cpu")
    a = prog.final_a(prog.run_pairs(prog.init_state(1), 1))
    b = plain.final_a(plain.run_pairs(plain.init_state(1), 1))
    assert np.abs(a - b).max() / np.abs(b).max() <= 1e-5


def test_factored_program_keeps_frames_in_place():
    prog = port_program("2d9pt_cross", step=2)
    state = prog.init_state(2)
    a, b = state["a"], state["b"]
    a0 = a.clone()
    prog.run_pairs(state, 1)
    h = prog.an.halo
    frame = torch.ones(a.shape, dtype=torch.bool)
    frame[h:-h, h:-h] = False
    assert torch.equal(a[frame], a0[frame])
    assert not b[frame].any()
    assert b[h:-h, h:-h].any()


REJECTIONS = [
    ("2d5pt_star", dict(step=1), "no well-conditioned radius-2"),
    ("3d7pt_star", dict(step=1), "2D-only"),
    ("2d25pt_box", dict(step=5), "requires step < DEEP_LEVELS"),
    ("2d25pt_box", dict(step=4, trapezoid=True, block=2),
     "block > 1 is incompatible with factor mode"),
    ("2d25pt_box", dict(step=2, trapezoid=True, vfuse=True,
                        lane_mode="roll"),
     "vfuse is incompatible with factor mode"),
]


@pytest.mark.parametrize("name,kw,match", REJECTIONS,
                         ids=["table", "3d", "deep", "block", "vfuse"])
def test_factor_rejections_match_jax(name, kw, match):
    jspec = small_spec(name, (120, 256) if kw.get("step", 1) >= 4 else None)
    jcfg = JConfig(variant="stream", factor=True, interpret=True,
                   tm=80 if jspec.ndim == 3 else 40, **kw)
    jan = jpasses.analyze(jspec, jcfg.step)
    with pytest.raises(ValueError, match=match):
        jstream.build_stream_kernel(jan, jcfg)
    cfg = convert.config_from_dict(asdict(jcfg))
    an = tpasses.analyze(port_spec(jspec), cfg.step)
    with pytest.raises(ValueError, match=match):
        tstream.build_stream_kernel(an, cfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        StencilProgram(port_spec(jspec), cfg, device="cpu")


def test_factor_has_no_shard_local_build():
    """(Named when the shard-local build was refused.)  Factor mode's
    shard-local build is ``stencil2d_factor_levels_shard``: it takes a
    slab with ghost rows and a store range, and its plain version stores
    that range only."""
    spec = port_spec(small_spec("2d25pt_box", (16, 256)))
    an = tpasses.analyze(spec, 2)
    f = tstream.build_stream_kernel(an, KernelConfig(step=2, factor=True),
                                    device="cpu", row_frame=False)
    src = torch.rand((16 + 8, 256))
    dst = torch.zeros_like(src)
    f(src, dst, (8, 20))
    assert dst[8:20, 4:-4].all() and not dst[:8].any() and not dst[20:].any()
    with pytest.raises(ValueError, match="FactorTaps"):
        kernels.stencil2d_factor_levels_shard(
            src, dst, tstream.level_plan(an, KernelConfig(step=2)), (8, 20))


def test_factor_counts_three_buffers_and_its_own_flops():
    """The factor kernel's shared memory (once three haloed tiles, now a
    ring of four rows per level and the staging rows of the streamed
    text) and its own flops."""
    from drstencil_tpu_torch.ops import codegen

    spec = port_spec(small_spec("2d25pt_box"))
    cfg = KernelConfig(step=2, factor=True)
    an = tpasses.analyze(spec, 2)
    plan = tstream.level_plan(an, cfg)
    g = codegen.geometry(plan, spec.dims)
    assert g.factor and g.window and g.ring == 4
    assert kernels.n_buffers(plan, spec.dims) \
        == plan.levels * 4 + codegen.AHEAD_2D + 1
    tile = kernels.tile_shape(plan, spec.dims)
    assert tile == g.tile and tile[1] == spec.dims[1]
    model = traffic_model(an, cfg)
    assert model.smem_bytes == 4 * (2 * g.guard + kernels.n_buffers(
        plan, spec.dims) * g.ex)
    # every segment stages its rows, 2 * frame warm-up rows and the tail
    assert model.read_bytes == 4 * g.ex * (
        spec.dims[0] - 2 * plan.frame + g.n_segments * (2 * plan.frame + 1))
    cells = int(np.prod(spec.dims))
    assert model.flops == 2 * plan.taps_per_step * 2 * cells
    assert plan.taps_per_step <= 9 + 9 + 5
    # the unfactored trapezoid of the same step: 25 taps per level
    assert traffic_model(an, KernelConfig(step=2, trapezoid=True)).flops \
        == 2 * 25 * 2 * cells


def test_factor_wrapper_checks_arguments():
    spec = port_spec(small_spec("2d9pt_star"))
    fplan = tstream.level_plan(tpasses.analyze(spec, 1),
                               KernelConfig(step=1, factor=True))
    lplan = tstream.level_plan(tpasses.analyze(spec, 1), KernelConfig(step=1))
    a = torch.zeros(spec.dims)
    k = kernels.stencil2d_factor_levels
    before = k.launches
    with pytest.raises(ValueError, match="FactorTaps"):
        k(a, a.clone(), lplan)
    with pytest.raises(ValueError, match="LevelTaps"):
        kernels.stencil2d_levels(a, a.clone(), fplan)
    with pytest.raises(ValueError, match="takes no rows"):
        k(a, a.clone(), fplan, (2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        k(a.to("meta"), a.to("meta"), fplan)
    k(a, a.clone(), fplan)
    assert k.launches == before
