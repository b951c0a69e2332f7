"""Factor mode on the sharded path: ``stencil2d_factor_levels_shard``, the
port of the TPU kernel's ``factor=True, row_frame=False`` build.

(a) The port's ``sharded_stream_pair`` on four CPU shards against the JAX
package's sharded factor pair in interpret mode on its virtual CPU mesh,
from the same numpy state, and against the fp64 golden (the gates of
``tests/test_torch_parallel.py``); (b) against the port's own
single-device factor program, bit for bit; (c) the new kernel text under
the ``g++`` emulation of ``tests/test_torch_codegen.py`` against its plain
version on ghosted slabs, for the store ranges of the first, an interior
and the last shard and an empty one, everything outside the range
untouched; (d) the JAX package's rejections, word for word.
"""

from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from drstencil_tpu.ops.config import KernelConfig as JConfig
from drstencil_tpu.parallel import halo as jhalo
from drstencil_tpu.parallel import stream_shard as jshard
from drstencil_tpu_torch import convert
from drstencil_tpu_torch.ir import golden
from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops import stream as tstream
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.parallel import stream_shard

from conftest import small_spec
from test_torch_codegen import KERNEL_TOL, bench_spec, bf16_ulp, emulated
from test_torch_parallel import (cpu_mesh, jax_sharded_pairs,
                                 port_sharded_pairs, port_spec)

FACTORABLE = ["2d25pt_box", "2d9pt_star", "2d9pt_cross"]
# every factor table at steps 1 and 2, and the 25-point box at step 3 (as
# tests/test_factor.py runs it)
CASES = [(n, s) for n in FACTORABLE for s in (1, 2)] + [("2d25pt_box", 3)]
CASE_IDS = [f"{n}_step{s}" for n, s in CASES]
DIMS = (64, 256)
N_SHARDS = 4


def jax_config(step, dtype="float32"):
    return JConfig(variant="stream", step=step, tm=16, factor=True,
                   dtype=dtype, interpret=True)


def start_state(spec, seed):
    a0, b0 = golden.random_state(spec, seed=seed, dtype=np.float64)
    return a0.astype(np.float32), b0.astype(np.float32)


# -- (a) against the JAX package and the fp64 golden ----------------------------

@pytest.mark.parametrize("name,step", CASES, ids=CASE_IDS)
def test_sharded_factor_matches_jax_and_golden(name, step):
    """Two pairs on four shards: within 1e-5 of max|JAX| of the JAX
    package's sharded factor kernel (fp32 sums in another order), and
    within 3e-6 of max|gold| of the fp64 golden model."""
    jcfg = jax_config(step)
    spec = port_spec(name, DIMS)
    cfg = convert.config_from_dict(asdict(jcfg))
    assert cfg.factor and cfg.step == step
    a0f, b0f = start_state(spec, 0)
    pairs = 2
    got, g = port_sharded_pairs(spec, cfg, a0f, b0f, pairs)
    assert g.halo == 2 * step
    want = jax_sharded_pairs(small_spec(name, DIMS), jcfg, a0f, b0f, pairs)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel <= 1e-5, f"vs JAX: rel={rel}"

    an = analyze(spec, step=step)
    ga, gb = a0f.astype(np.float64), b0f.astype(np.float64)
    for _ in range(pairs):
        gb = golden.apply_interior(ga, gb, an.fused, an.halo)
        ga = golden.apply_interior(gb, ga, an.fused, an.halo)
    me, _ = golden.check_error(got, ga, an.halo)
    scale = max(1.0, float(np.max(np.abs(ga))))
    assert me / scale < 3e-6, f"max_err={me} (scale {scale:.3g})"


def test_sharded_factor_bf16_matches_jax():
    """bf16 state on four shards: equal to the port's single-device bf16
    factor program, and within the bf16 gate (1e-2 of max|JAX|) of the JAX
    package's sharded bf16 factor kernel."""
    import jax.numpy as jnp

    name, step = "2d25pt_box", 2
    jcfg = jax_config(step, "bfloat16")
    spec = port_spec(name, DIMS)
    cfg = convert.config_from_dict(asdict(jcfg))
    a0, b0 = golden.random_state(spec, seed=5, dtype=np.float64)
    # a bf16-representable state, so both packages start bit-equal
    a0f = torch.tensor(a0).to(torch.bfloat16).float().numpy()
    b0f = torch.tensor(b0).to(torch.bfloat16).float().numpy()
    got, g = port_sharded_pairs(spec, cfg, a0f, b0f, 1)
    assert g.dtype == torch.bfloat16

    prog = StencilProgram(spec, cfg, device="cpu")
    state = convert.state_from_numpy(a0f, b0f, device="cpu",
                                     dtype="bfloat16")
    np.testing.assert_array_equal(got, prog.final_a(prog.run_pairs(state, 1)))

    mesh = jhalo.make_mesh(N_SHARDS, devices=jax.devices("cpu"))
    pair, jg, sharding = jshard.sharded_stream_pair(
        small_spec(name, DIMS), jcfg, mesh)
    sa = jshard.shard_state(a0f, jg, N_SHARDS)
    sb = jshard.shard_state(b0f, jg, N_SHARDS)
    put = lambda x: jax.device_put(jnp.asarray(x, jnp.bfloat16), sharding)
    a, _ = pair(put(sa[0]), put(sb[0]), tuple(put(s) for s in sa[1:]),
                tuple(put(s) for s in sb[1:]))
    want = jshard.unshard_state(np.asarray(a.astype(jnp.float32)), jg,
                                N_SHARDS)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-2, f"rel={rel}"


# -- (b) against the port's single-device factor program ------------------------

@pytest.mark.parametrize("name,step", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_factor_equals_single_device(name, step, n):
    """Every stored cell runs the same operations on the same values as the
    single-device factor program's: equal bit for bit after two pairs, and
    the exchange's copies and bytes equal to the model's."""
    spec = port_spec(name, DIMS)
    cfg = KernelConfig(step=step, factor=True)
    prog = StencilProgram(spec, cfg, device="cpu")
    single = prog.final_a(prog.run_pairs(prog.init_state(3), 2))
    a0f, b0f = start_state(spec, 3)
    got, g = port_sharded_pairs(spec, cfg, a0f, b0f, 2, n)
    np.testing.assert_array_equal(got, single)
    model = stream_shard.halo_traffic_model(analyze(spec, step=step), step, n)
    assert g.exchange.copies == 4 * model["copies_per_apply_mesh"]
    assert g.exchange.bytes == 4 * model["bytes_per_apply_mesh"]


def test_factor_halo_model_equals_the_unfactored_plans():
    """Factor mode's frame is the fused halo: the exchange copies the same
    rows as the unfactored trapezoid of the same step."""
    spec = port_spec("2d25pt_box", DIMS)
    for step in (1, 2, 3):
        fac = stream_shard.build_sharded_stream(
            spec, KernelConfig(step=step, factor=True), cpu_mesh())[1]
        plain = stream_shard.build_sharded_stream(
            spec, KernelConfig(step=step, trapezoid=step > 1), cpu_mesh())[1]
        assert (fac.halo, fac.slab_dims) == (plain.halo, plain.slab_dims)
        assert fac.halo == analyze(spec, step=step).halo == 2 * step
        assert [fac.store_rows(k) for k in range(N_SHARDS)] == [
            plain.store_rows(k) for k in range(N_SHARDS)]


def test_sharded_factor_routes_through_the_shard_kernel(monkeypatch):
    """The sharded path calls ``stencil2d_factor_levels_shard`` once per
    shard and application with that shard's store range; the plain version
    on CPU tensors counts no launch."""
    spec = port_spec("2d9pt_star", DIMS)
    pair, g = stream_shard.sharded_stream_pair(
        spec, KernelConfig(step=2, factor=True), cpu_mesh())
    k = kernels.stencil2d_factor_levels_shard
    seen = []
    plain = k.plain
    monkeypatch.setattr(k, "plain", lambda src, dst, taps, rows: (
        seen.append(tuple(rows)), plain(src, dst, taps, rows))[1])
    before = (k.launches, kernels.stencil2d_factor_levels.launches)
    a0f, b0f = start_state(spec, 1)
    state = convert.sharded_state_from_numpy(a0f, b0f, g)
    pair(state["a"], state["b"])
    rows = [g.store_rows(k_) for k_ in range(N_SHARDS)]
    assert seen == rows + rows
    assert rows == [(8, 20), (4, 20), (4, 20), (4, 16)]
    assert (k.launches, kernels.stencil2d_factor_levels.launches) == before


def test_shard_factor_wrapper_checks_rows():
    spec = port_spec("2d25pt_box", (16, 256))
    f = tstream.build_stream_kernel(analyze(spec, 2),
                                    KernelConfig(step=2, factor=True),
                                    device="cpu", row_frame=False)
    slab = torch.rand((16 + 8, 256))
    for bad in ((3, 20), (4, 21)):
        with pytest.raises(ValueError, match="ghost rows"):
            f(slab, slab.clone(), bad)
    with pytest.raises(ValueError, match="is not"):
        f(torch.zeros(spec.dims), torch.zeros(spec.dims), (4, 12))
    dst = torch.rand(slab.shape)
    kept = dst.clone()
    f(slab, dst, (9, 9))             # an empty range stores nothing
    assert torch.equal(dst, kept)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stencil2d_factor_levels_shard(
            slab.to("meta"), slab.to("meta"),
            tstream.level_plan(analyze(spec, 2),
                               KernelConfig(step=2, factor=True)), (4, 20))


# -- (c) the new text under the g++ emulation ------------------------------------

def shard_text_case(name, step, local, width, dtype):
    """(plan, slab dims, text) of the shard build on a slab of ``local``
    rows with its ghost rows."""
    spec = bench_spec(name, (N_SHARDS * local, width))
    plan = tstream.level_plan(analyze(spec, step),
                              KernelConfig(step=step, factor=True,
                                           dtype=dtype))
    dims = (local + 2 * plan.frame, width)
    return plan, dims, codegen.cuda_source(plan, dims, dtype, True)


def check_ranges(launch, plan, dims, dtype, ranges, seed=4):
    """The emulated kernel against the plain shard version on a random slab
    (ghost rows included) and a random destination, for each store range:
    fp32 within 1e-5 relative, bf16 within one bf16 ulp, and every cell
    outside the range and the off-axis frame bit-unchanged."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.uniform(0, 100, dims)).to(tdt)
    fill = torch.from_numpy(rng.uniform(-0.5, 0.5, dims)).to(tdt)
    H = plan.frame
    for lo, hi in ranges:
        want = fill.clone()
        kernels.stencil2d_factor_levels_shard.plain(src, want, plan, (lo, hi))
        got = launch(src, fill, [lo, hi])
        outside = torch.ones(dims, dtype=torch.bool)
        outside[lo:max(lo, hi), H:dims[1] - H] = False
        assert torch.equal(got[outside], fill[outside]), (lo, hi)
        if lo >= hi:
            assert torch.equal(got, fill)
            continue
        assert not got.float().isnan().any()
        diff = (got.float() - want.float()).abs()
        top = float(want.float().abs().max())
        if dtype == "float32":
            assert float(diff.max()) <= KERNEL_TOL * top, (lo, hi)
        else:
            assert bool((diff <= bf16_ulp(want) + KERNEL_TOL * top).all())


def shard_ranges(H, local):
    """The first shard's, an interior shard's (every local row: its last
    window's tail row lies past the slab), the last shard's and an empty
    store range."""
    return [(2 * H, H + local), (H, H + local), (H, local),
            (H + 3, H + 3)]


@pytest.mark.parametrize("name,step,local,width,dtype", [
    ("2d25pt_box", 2, 40, 1100, "float32"),
    ("2d9pt_star", 1, 30, 600, "float32"),
    ("2d9pt_cross", 2, 24, 1100, "bfloat16"),
    ("2d25pt_box", 3, 36, 300, "float32"),
    ("2d25pt_box", 1, 20, 200, "bfloat16"),
    ("2d9pt_star", 2, 24, 601, "float32"),
    ("2d9pt_cross", 1, 12, 37, "bfloat16"),
], ids=["box_step2", "star_step1", "cross_step2_bf16", "box_step3",
        "narrow_bf16", "odd_width", "narrow_odd_bf16"])
def test_emulated_shard_factor_equals_plain(tmp_path, name, step, local,
                                            width, dtype):
    plan, dims, cuda = shard_text_case(name, step, local, width, dtype)
    g = codegen.geometry(plan, dims)
    assert g.factor and g.tail == 1 and g.vec == (width % 4 == 0)
    if width < codegen.STRIP_2D[0]:
        assert g.grid[0] == 1 and g.threads * 4 > width
    check_ranges(emulated(cuda, tmp_path), plan, dims, dtype,
                 shard_ranges(plan.frame, local))


def test_emulated_shard_factor_segments_start_anywhere(tmp_path):
    """Several segments per range, starting on rows the single-device
    kernel never starts on, and a range whose last segment ends at the
    slab's last stored row."""
    plan, dims, cuda = shard_text_case("2d25pt_box", 2, 60, 520, "float32")
    H = plan.frame
    g = codegen.geometry(plan, dims)
    assert g.n_segments > 1
    check_ranges(emulated(cuda, tmp_path), plan, dims, "float32",
                 [(H + 1, dims[0] - H), (H + 5, H + 6), (H + 17, H + 50)])


def test_emulated_sharded_pair_equals_single_device(tmp_path):
    """One pair on four shards with every shard-local application run by
    the emulated shard text (the exchange is ``HaloExchange``'s): equal bit
    for bit to one pair of the emulated single-device factor text, which
    runs the same ``fmaf`` chains on the same values; and within 1e-5 of
    the plain program."""
    name, step = "2d25pt_box", 2
    spec = port_spec(name, DIMS)
    cfg = KernelConfig(step=step, factor=True)
    apply_fn, g = stream_shard.build_sharded_stream(spec, cfg, cpu_mesh())
    plan = tstream.level_plan(analyze(spec, step), cfg)
    local_plan = tstream.level_plan(
        stream_shard.local_analysis(spec, cfg, N_SHARDS), cfg)
    assert plan.frame == local_plan.frame == g.halo
    (tmp_path / "shard").mkdir()
    (tmp_path / "single").mkdir()
    shard = emulated(codegen.cuda_source(local_plan, g.slab_dims, "float32",
                                         True), tmp_path / "shard")
    whole = emulated(codegen.cuda_source(plan, DIMS, "float32", False),
                     tmp_path / "single")
    prog = StencilProgram(spec, cfg, device="cpu")
    state = prog.init_state(2)
    b = whole(state["a"], state["b"])
    want = whole(b, state["a"])
    a = stream_shard.shard_state(state["a"], g)
    b = stream_shard.shard_state(state["b"], g)
    for src, dst in ((a, b), (b, a)):
        g.exchange(src)
        for k in range(N_SHARDS):
            dst[k] = shard(src[k], dst[k], list(g.store_rows(k)))
    got = stream_shard.unshard_state(a, g)
    np.testing.assert_array_equal(got, want.numpy())
    plain = prog.final_a(prog.run_pairs(prog.init_state(2), 1))
    assert np.abs(got - plain).max() <= KERNEL_TOL * np.abs(plain).max()


# -- (d) the JAX package's rejections ----------------------------------------------

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
def test_sharded_factor_rejections_match_jax(name, kw, match):
    """What the JAX package's sharded entry refuses in factor mode, the
    port's refuses with the same words."""
    dims = (32, 24, 256) if name.startswith("3d") else (
        (160, 256) if kw.get("step", 1) >= 4 else DIMS)
    jspec = small_spec(name, dims)
    jcfg = JConfig(variant="stream", factor=True, interpret=True,
                   tm=80 if jspec.ndim == 3 else 40, **kw)
    jmesh = jhalo.make_mesh(N_SHARDS, devices=jax.devices("cpu"))
    with pytest.raises(ValueError, match=match):
        jshard.sharded_stream_pair(jspec, jcfg, jmesh)
    cfg = convert.config_from_dict(asdict(jcfg))
    with pytest.raises(ValueError, match=match):
        stream_shard.sharded_stream_pair(port_spec(name, dims), cfg,
                                         cpu_mesh())
