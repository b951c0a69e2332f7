"""bf16 state in the port (kernels' plain versions, device="cpu") against
the JAX package's bf16 ``StencilProgram`` in Pallas interpret mode, on the
same numpy state.

Both packages keep bf16 in memory, compute every level in fp32 and round
once per launch, so the port's result may differ from the JAX one only by
fp32 associativity flipping a rounding: one bf16 ulp, at most 2^-7 of the
value.
"""

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drstencil_tpu.ops.runner import StencilProgram as JProgram
from drstencil_tpu.ops.stream import unpad_state
from drstencil_tpu.tune import tuned as jtuned
from drstencil_tpu.tune.tuner import CHECK_TOL as JCHECK_TOL
from drstencil_tpu_torch import convert
from drstencil_tpu_torch.ir import passes as tpasses
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops import stream as tstream
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.tune.tuner import CHECK_TOL
from drstencil_tpu_torch.utils.profiling import traffic_model

from conftest import small_spec

WINNERS = [
    "2d13pt_star", "2d25pt_box", "2d5pt_cross", "2d5pt_star", "2d9pt_box",
    "2d9pt_cross", "2d9pt_star", "3d13pt_star", "3d27pt_box", "3d7pt_star",
    "3d9pt_cross",
]
ONE_ULP = 2.0 ** -7  # one bf16 ulp relative to a value just above 2^e
# tests/test_kernels.py::test_bfloat16_state, stated for values ~100 and
# scaled with max|gold| for the operators that grow the state
MAX_TOL, RMS_TOL = 2.0, 0.5


def jax_bf16(name, jspec):
    return jtuned.best_config(name).replace(
        tm=32 if jspec.ndim == 2 else 80, ch=None, interpret=True,
        dtype="bfloat16")


def port_bf16(name, dims=None):
    jspec = small_spec(name, dims)
    spec = convert.spec_from_fields(jspec.name, jspec.dims, jspec.iterations,
                                    jspec.taps)
    cfg = convert.config_from_dict(asdict(jtuned.best_config(name)))
    return StencilProgram(spec, cfg.replace(dtype="bfloat16"), device="cpu")


def test_check_tol_is_the_jax_packages():
    assert CHECK_TOL == JCHECK_TOL


@pytest.mark.parametrize("name", ["2d9pt_box", "3d27pt_box"])
def test_init_state_bit_equal_to_jax(name):
    jspec = small_spec(name)
    jp = JProgram(jspec, jax_bf16(name, jspec))
    js = jp.init_state(3)
    prog = port_bf16(name)
    ts = prog.init_state(3)
    assert ts["a"].dtype == torch.bfloat16
    for k in ("a", "b"):
        want = np.asarray(unpad_state(js[k], jp.geom)).astype(np.float32)
        np.testing.assert_array_equal(ts[k].float().numpy(), want)


@pytest.mark.parametrize("name", WINNERS)
def test_final_a_matches_jax_bf16_program(name):
    """After one pair within one bf16 ulp of max|JAX|, after the whole
    protocol within the tuner's bf16 gate."""
    jspec = small_spec(name)
    jp = JProgram(jspec, jax_bf16(name, jspec))
    prog = port_bf16(name)
    assert prog.num_pairs() == jp.num_pairs()
    js, ts = jp.init_state(0), prog.init_state(0)
    for pairs_done in range(1, prog.num_pairs() + 1):
        js, ts = jp.run_pairs(js, 1), prog.run_pairs(ts, 1)
        want = np.asarray(jp.final_a(js), np.float32)
        got = prog.final_a(ts)
        assert got.dtype == np.float32
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= (ONE_ULP if pairs_done == 1
                       else CHECK_TOL["bfloat16"]), (pairs_done, rel)


@pytest.mark.parametrize("name,dims", [
    ("2d5pt_star", None),
    ("3d7pt_star", None),
    ("2d13pt_star", None),
    # deep: step-1 gold composed 6x (it rounds every step, the kernel
    # once per launch), compared past an inset of 36 cells
    ("2d25pt_box", (96, 128)),
])
def test_device_check_on_cpu(name, dims):
    assert port_bf16(name, dims).device_check(pairs=1) <= CHECK_TOL["bfloat16"]


@pytest.mark.parametrize("name", WINNERS)
def test_check_against_fp64_golden(name):
    prog = port_bf16(name)
    max_err, rms = prog.check(seed=0)
    a = prog.final_a(prog.run_pairs(prog.init_state(0), prog.num_pairs()))
    h = prog.an.halo
    scale = max(1.0, np.abs(a[tuple(slice(h, s - h) for s in a.shape)]).max()
                / 100.0)
    assert max_err < MAX_TOL * scale, f"max_err={max_err} scale={scale}"
    assert rms < RMS_TOL * scale


def test_golden_starts_from_the_rounded_state():
    """check() rounds the fp64 initial state to bf16 before the golden, as
    the JAX runner does: a zero-pair check is exact."""
    assert port_bf16("2d5pt_star").check(pairs=0) == (0.0, 0.0)


def _plan(name, cfg_kw=None):
    jspec = small_spec(name)
    spec = convert.spec_from_fields(jspec.name, jspec.dims, jspec.iterations,
                                    jspec.taps)
    cfg = convert.config_from_dict(asdict(jtuned.best_config(name)))
    cfg = cfg.replace(**(cfg_kw or {}))
    an = tpasses.analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
    return spec, cfg, an, tstream.level_plan(an, cfg)


@pytest.mark.parametrize("name", ["2d9pt_star", "2d25pt_box", "3d9pt_cross"])
def test_plain_version_rounds_once(name):
    """The bf16 plain version is the fp32 plain version on the upcast
    source, rounded to bf16 once at the store."""
    spec, _, _, plan = _plan(name)
    rng = np.random.default_rng(1)
    src = torch.tensor(rng.uniform(0, 100, spec.dims), dtype=torch.bfloat16)
    got = kernels.kernel_for(spec.ndim)(src, torch.zeros_like(src), plan)
    want = kernels._levels_ref(src.float(), torch.zeros(spec.dims), plan)
    assert torch.equal(got, want.to(torch.bfloat16))


def test_bf16_plan_equals_fp32_plan():
    *_, p32 = _plan("3d7pt_star")
    *_, p16 = _plan("3d7pt_star", {"dtype": "bfloat16"})
    assert (p16.levels, p16.reach, p16.frame) == (
        p32.levels, p32.reach, p32.frame)
    np.testing.assert_array_equal(p16.offsets, p32.offsets)
    np.testing.assert_array_equal(p16.coeffs, p32.coeffs)
    assert p16.coeffs.dtype == np.float32  # the tap table stays fp32


def test_mixed_dtype_kernel_call_raises():
    spec, _, _, plan = _plan("2d5pt_star")
    k = kernels.stencil2d_levels
    a32 = torch.zeros(spec.dims)
    a16 = torch.zeros(spec.dims, dtype=torch.bfloat16)
    before = k.launches
    for src, dst in ((a32, a16), (a16, a32),
                     (a32.double(), a32.double()),
                     (a32.to("meta"), a16.to("meta"))):
        with pytest.raises(TypeError, match="one dtype"):
            k(src, dst, plan)
    assert k.launches == before


def test_stream_kernel_checks_the_state_dtype():
    spec, cfg, an, _ = _plan("2d5pt_star", {"dtype": "bfloat16"})
    f = tstream.build_stream_kernel(an, cfg, device="cpu")
    a32 = torch.zeros(spec.dims)
    with pytest.raises(TypeError, match="kernel built for torch.bfloat16"):
        f(a32, a32.clone())
    with pytest.raises(ValueError, match="dtype 'float16'"):
        tstream.level_plan(an, cfg.replace(dtype="float16"))
    with pytest.raises(ValueError, match="dtype 'float16'"):
        StencilProgram(spec, cfg.replace(dtype="float16"), device="cpu")


def test_convert_carries_a_jax_bf16_state_bit_for_bit():
    rng = np.random.default_rng(2)
    ja = jnp.asarray(rng.uniform(0, 100, (6, 7, 8)), jnp.bfloat16)
    jb = jnp.asarray(rng.uniform(-1, 1, (6, 7, 8)), jnp.bfloat16)
    state = convert.state_from_numpy(np.asarray(ja, np.float32),
                                     np.asarray(jb, np.float32),
                                     device="cpu", dtype="bfloat16")
    assert state["a"].dtype == torch.bfloat16
    ra, rb = convert.state_to_numpy(state)
    assert ra.dtype == np.float32
    for back, orig in ((ra, ja), (rb, jb)):
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(back, jnp.bfloat16)).view(np.uint16),
            np.asarray(orig).view(np.uint16))
    assert convert.state_to_numpy(state, np.float64)[0].dtype == np.float64


def test_xla_variant_on_bf16_state():
    prog = port_bf16("2d5pt_cross")
    gold = StencilProgram(prog.spec, KernelConfig(
        variant="xla", step=2, dtype="bfloat16"), device="cpu")
    state = gold.init_state(0)
    assert state["a"].dtype == torch.bfloat16
    max_err, _ = gold.check()
    assert max_err < MAX_TOL


@pytest.mark.parametrize("name", ["2d5pt_star", "3d7pt_star"])
def test_traffic_model_halves_with_bf16(name):
    """The bound is 2·item·cells bytes and 2·taps·levels·cells flops;
    bf16 halves the bytes and leaves the fp32 operations."""
    spec, _, an, plan = _plan(name)
    _, cfg16, an16, _ = _plan(name, {"dtype": "bfloat16"})
    t32 = traffic_model(an, _plan(name)[1])
    t16 = traffic_model(an16, cfg16)
    cells = int(np.prod(spec.dims))
    assert t32.bound_bytes == 8 * cells == 2 * t16.bound_bytes
    assert t32.flops == t16.flops == 2 * len(plan.coeffs) * plan.levels * cells
    assert t32.read_bytes == 2 * t16.read_bytes >= 4 * cells
    assert t32.write_bytes == 2 * t16.write_bytes
    assert t32.smem_bytes == t16.smem_bytes <= kernels.SMEM_LIMIT
    # the smoke's bound at the card's peaks (H100 SXM: 3350 GB/s, 67 TF)
    ms, by = t32.bound_ms(3350.0, 67.0)
    assert by == "bytes" and ms == pytest.approx(8 * cells / 3350e9 * 1e3)
