"""The port's stream kernel (plain path, device="cpu") against the JAX
package's ``build_stream_kernel`` in Pallas interpret mode.

For every tuned winner, one application on the same numpy state (a random
destination frame included) must agree within 1e-5 of max|JAX| on the
interior and leave the destination's frame bit-for-bit untouched.  The
JAX config is the tuned one with ``tm`` cut to the small grid and
``ch=None``; the Hopper port ignores both.
"""

import json
import os
from dataclasses import asdict

import numpy as np
import pytest
import torch

from drstencil_tpu.ir import passes as jpasses
from drstencil_tpu.ir.spec import StencilSpec as JStencilSpec
from drstencil_tpu.ops import stream as jstream
from drstencil_tpu.ops.config import KernelConfig as JConfig
from drstencil_tpu.tune.tuned import best_config as jbest
from drstencil_tpu_torch import convert
from drstencil_tpu_torch.ir import passes as tpasses
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops import stream as tstream
from drstencil_tpu_torch.ops.config import KernelConfig as TConfig

from conftest import BENCH_DIR, small_spec

WINNERS = [
    "2d13pt_star", "2d25pt_box", "2d5pt_cross", "2d5pt_star", "2d9pt_box",
    "2d9pt_cross", "2d9pt_star", "3d13pt_star", "3d27pt_box", "3d7pt_star",
    "3d9pt_cross",
]
REL_TOL = 1e-5


def test_winners_are_tuned_json():
    with open(os.path.join(BENCH_DIR, "tuned.json")) as f:
        assert sorted(json.load(f)) == WINNERS


def jax_cfg(jcfg: JConfig, ndim: int) -> JConfig:
    return jcfg.replace(tm=32 if ndim == 2 else 80, ch=None, interpret=True)


def to_port(jspec, jcfg):
    spec = convert.spec_from_fields(jspec.name, jspec.dims, jspec.iterations,
                                    jspec.taps)
    return spec, convert.config_from_dict(asdict(jcfg))


def one_application(jspec, jcfg, seed=0):
    """(JAX result, port result, destination before, halo) of one
    application src=a -> dst=b on the same numpy state."""
    rng = np.random.default_rng(seed)
    a0 = rng.uniform(0.0, 100.0, jspec.dims).astype(np.float32)
    b0 = rng.uniform(-1.0, 1.0, jspec.dims).astype(np.float32)
    jan = jpasses.analyze(jspec, jcfg.step, jcfg.distance, jcfg.merge_forward)
    jf, g = jstream.build_stream_kernel(jan, jax_cfg(jcfg, len(jspec.dims)))
    want = np.asarray(jstream.unpad_state(
        jf(jstream.pad_state(a0, g), jstream.make_slabs(b0, g)), g))

    spec, cfg = to_port(jspec, jcfg)
    tan = tpasses.analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
    f = tstream.build_stream_kernel(tan, cfg, device="cpu")
    state = convert.state_from_numpy(a0, b0, device="cpu")
    out = f(state["a"], state["b"])
    assert out is state["b"]  # in place
    return want, convert.state_to_numpy(state)[1], b0, tan.halo


def assert_close_with_frame(want, got, b0, h):
    interior = tuple(slice(h, s - h) for s in want.shape)
    frame = np.ones(want.shape, bool)
    frame[interior] = False
    np.testing.assert_array_equal(got[frame], b0[frame])
    np.testing.assert_array_equal(want[frame], b0[frame])
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= REL_TOL, f"rel={rel}"


@pytest.mark.parametrize("name", WINNERS)
def test_winner_matches_jax_stream_kernel(name):
    assert_close_with_frame(*one_application(small_spec(name), jbest(name)))


@pytest.mark.parametrize("jcfg", [
    # K1: the single fused level at step 1 (the graft entry's mode)
    JConfig(step=1),
    # K1 with coefficient fusion at step 2
    JConfig(step=2, lane_mode="roll"),
    # K7: block-hybrid, two levels of the 2-step fused operator
    JConfig(step=4, trapezoid=True, block=2, lane_mode="roll"),
], ids=["k1_step1", "k1_fused_step2", "k7_block2"])
def test_modes_match_jax_stream_kernel(jcfg):
    assert_close_with_frame(*one_application(small_spec("2d5pt_star"), jcfg))


@pytest.mark.parametrize("jfix", ["outer", "kernel"])
def test_jfix_modes_match_jax_stream_kernel(jfix):
    """Both j-frame strategies give the same frozen frame; on Hopper the
    field is a no-op, so the port agrees with each."""
    jcfg = jbest("3d7pt_star").replace(jfix=jfix)
    assert_close_with_frame(*one_application(small_spec("3d7pt_star"), jcfg))


def _asym_spec(taps, name="asym"):
    return JStencilSpec(name, (64, 256), 4, taps)


STAR = {(0, 0): 0.5, (1, 0): 0.125, (-1, 0): 0.125, (0, 1): 0.125,
        (0, -1): 0.125}


@pytest.mark.parametrize("taps,jcfg,match", [
    (STAR | {(0, 2): 0.1}, JConfig(step=1, tm=32),
     "axis-1 radius"),
    (STAR | {(-2, 0): 0.1}, JConfig(step=1, tm=32),
     "axis-0 negative extent"),
    (STAR, JConfig(step=4, block=2, tm=32), "block > 1 requires trapezoid"),
    (STAR, JConfig(step=4, trapezoid=True, block=3, tm=32),
     "requires step % block"),
    (STAR, JConfig(step=2, vfuse=True, tm=32, lane_mode="roll"),
     "vfuse requires trapezoid"),
    (STAR, JConfig(step=6, trapezoid=True, vfuse=True, tm=32,
                   lane_mode="roll"), "vfuse requires levels"),
    (STAR, JConfig(step=2, trapezoid=True, vfuse=True, tm=32,
                   lane_mode="slice"), "vfuse requires roll lane-mode"),
], ids=["offaxis", "backward", "block_no_trap", "block_3", "vfuse_no_trap",
        "vfuse_deep", "vfuse_slice"])
def test_rejections_match_jax(taps, jcfg, match):
    jspec = _asym_spec(taps)
    jan = jpasses.analyze(jspec, jcfg.step)
    with pytest.raises(ValueError, match=match):
        jstream.build_stream_kernel(jan, jcfg.replace(interpret=True))
    spec, cfg = to_port(jspec, jcfg)
    tan = tpasses.analyze(spec, cfg.step)
    with pytest.raises(ValueError, match=match):
        tstream.build_stream_kernel(tan, cfg, device="cpu")


def test_factor_and_bf16_not_ported():
    """Both are ported now (the name is kept): factor mode plans 2*step
    levels of the factored tables (tests/test_torch_factor.py), and bf16
    state plans the same levels as fp32 (tests/test_torch_bf16.py)."""
    spec, _ = to_port(small_spec("2d9pt_star"), JConfig())
    an = tpasses.analyze(spec, 2)
    plan = tstream.level_plan(an, TConfig(step=2, factor=True))
    assert isinstance(plan, kernels.FactorTaps)
    assert (plan.levels, plan.reach, plan.frame) == (4, 1, an.halo)
    bf16 = tstream.level_plan(an, TConfig(step=2, dtype="bfloat16"))
    assert bf16.levels == tstream.level_plan(an, TConfig(step=2)).levels


def test_coefficient_fused_table_cap():
    """A per-level table past the kernels' fixed cap raises; trapezoid
    levels of the same operator are fine."""
    spec, _ = to_port(small_spec("2d25pt_box"), JConfig())
    an = tpasses.analyze(spec, 6)
    with pytest.raises(ValueError, match="MAX_TAPS|exceed the kernels"):
        tstream.level_plan(an, TConfig(step=6))
    plan = tstream.level_plan(an, TConfig(step=6, trapezoid=True))
    assert (plan.levels, plan.reach, plan.frame) == (6, 2, 12)
    assert len(plan.coeffs) == 25


@pytest.mark.parametrize("name", WINNERS)
def test_level_plan_of_winners(name):
    """Level schedule: L levels of reach H/L; the tap table in sorted
    order (the JAX to_rowlane order kept N-D); the window's rings fit the
    227 KB of shared memory, at the test's size and at the ``.stc`` size."""
    jspec = small_spec(name)
    spec, cfg = to_port(jspec, jbest(name))
    an = tpasses.analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
    plan = tstream.level_plan(an, cfg)
    jan = jpasses.analyze(jspec, cfg.step, cfg.distance)
    assert plan.levels == jstream.n_levels(jan, jbest(name))
    assert tstream.is_deep(an, cfg) == jstream.is_deep(jan, jbest(name))
    assert plan.levels * plan.reach == an.halo == plan.frame
    offs = [tuple(o) for o in plan.offsets.tolist()]
    assert offs == sorted(offs)
    assert np.abs(plan.offsets).max() <= plan.reach
    from drstencil_tpu_torch.ir.spec import load_stc

    full = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
    for dims in (spec.dims, full.dims):
        tile = kernels.tile_shape(plan, dims)
        assert len(tile) == spec.ndim and min(tile) >= 1
        assert kernels.smem_bytes(plan, dims) <= kernels.SMEM_LIMIT


def _box_plan(ndim, levels, reach):
    """``levels`` levels of a full box of ``reach`` (any coefficients)."""
    offsets = np.array(list(np.ndindex(*(2 * reach + 1,) * ndim)),
                       dtype=np.int32) - reach
    return kernels.LevelTaps(offsets=offsets,
                             coeffs=np.ones(len(offsets), np.float32),
                             levels=levels, reach=reach,
                             frame=levels * reach)


def test_tile_shrinks_to_fit_shared_memory():
    """The streamed kernels' column shrinks until the levels' rings fit
    (two CTAs per SM where they can); so does the factor kernel's strip,
    the same text's."""
    from drstencil_tpu_torch.ops import codegen

    wide = codegen.geometry(_box_plan(2, 6, 2), (8192, 8192))
    assert wide.tile[1] == codegen.STRIP_2D[0] - 2 * wide.hx
    assert wide.smem_bytes <= codegen.SMEM_TARGET
    first = codegen.geometry(_box_plan(3, 1, 1), (512, 512, 512))
    assert first.tile[1:] == codegen.COLUMNS_3D[0]
    deep = codegen.geometry(_box_plan(3, 6, 2), (512, 512, 512))
    assert deep.tile[1:] != codegen.COLUMNS_3D[0]
    assert deep.smem_bytes <= kernels.SMEM_LIMIT
    assert kernels.smem_bytes(_box_plan(3, 6, 2), (512, 512, 512)) \
        == deep.smem_bytes
    with pytest.raises(ValueError, match="too wide"):
        kernels.tile_shape(_box_plan(3, 100, 2), (512, 512, 512))
    assert kernels.tile_shape(_factor_plan(6), (8192, 8192))[1] \
        == codegen.STRIP_2D[0] - 2 * 8
    tile = kernels.tile_shape(_factor_plan(48), (8192, 8192))
    assert tile[1] < codegen.STRIP_2D[0] - 2 * 48
    assert kernels.smem_bytes(_factor_plan(48), (8192, 8192)) \
        <= kernels.SMEM_LIMIT
    with pytest.raises(ValueError, match="too wide"):
        kernels.tile_shape(_factor_plan(200), (8192, 8192))


def _factor_plan(levels):
    """A factor plan of ``levels`` levels of reach 1 (tables of ones)."""
    v = (np.array([(d, s) for d in (-1, 0, 1) for s in (-1, 0, 1)],
                  np.int32), np.ones(9, np.float32))
    r = (np.array([(d, 0) for d in (-2, -1, 0, 1, 2)], np.int32),
         np.ones(5, np.float32))
    return kernels.FactorTaps(v1=v, v2=v, r=r, levels=levels, reach=1,
                              frame=levels)


def test_wrapper_checks_arguments():
    spec, cfg = to_port(small_spec("2d5pt_star"), JConfig(step=1))
    plan = tstream.level_plan(tpasses.analyze(spec, 1), cfg)
    k = kernels.stencil2d_levels
    a = torch.zeros(spec.dims)
    before = k.launches
    with pytest.raises(ValueError, match="2D"):
        k(torch.zeros(4, 4, 4), torch.zeros(4, 4, 4), plan)
    with pytest.raises(ValueError, match="differ in shape"):
        k(a, torch.zeros(8, 8), plan)
    # neither CPU nor CUDA: raise, never fall back to the plain version
    with pytest.raises(ValueError, match="CUDA"):
        k(a.to("meta"), a.to("meta"), plan)
    # the plain version on CPU tensors is not a launch
    k(a, a.clone(), plan)
    assert k.launches == before


def test_plain_versions_are_the_levels_recurrence():
    """The plain version equals L explicit applications of the level
    operator on the zero-padded source, interior copied."""
    rng = np.random.default_rng(3)
    spec, cfg = to_port(small_spec("3d7pt_star", (12, 13, 14)),
                        jbest("3d7pt_star"))
    plan = tstream.level_plan(tpasses.analyze(spec, cfg.step), cfg)
    src = rng.uniform(0, 1, spec.dims)
    cur = np.pad(src, plan.frame)
    for _ in range(plan.levels):
        nxt = np.zeros_like(cur)
        r = plan.reach
        inner = tuple(slice(r, s - r) for s in cur.shape)
        for off, c in zip(plan.offsets.tolist(), plan.coeffs.tolist()):
            nxt[inner] += c * cur[tuple(slice(r + o, s - r + o)
                                        for o, s in zip(off, cur.shape))]
        cur = nxt
    h = plan.frame
    want = np.zeros(spec.dims)
    interior = tuple(slice(h, s - h) for s in spec.dims)
    want[interior] = cur[tuple(slice(h + h, h + s - h) for s in spec.dims)]
    got = kernels.stencil3d_levels_ref(
        torch.tensor(src, dtype=torch.float32), torch.zeros(spec.dims), plan)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 1e-6


def test_build_stream_kernel_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, cfg = to_port(small_spec("2d5pt_star"), JConfig(step=1))
    an = tpasses.analyze(spec, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstream.build_stream_kernel(an, cfg)
    f = tstream.build_stream_kernel(an, cfg, device="cpu")
    with pytest.raises(ValueError, match="kernel built for"):
        f(torch.zeros(spec.dims, device="meta"),
          torch.zeros(spec.dims, device="meta"))
