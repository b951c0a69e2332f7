"""The port's multi-device path (drstencil_tpu_torch.parallel) on meshes of
CPU devices, against the JAX package on its virtual CPU mesh, the fp64
golden model and the port's own single-device program.

A mesh here names ``"cpu"`` several times; the shard-local kernels run as
their plain versions.  The cases are those of ``tests/test_parallel.py``.
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drstencil_tpu.ir import golden as jgolden
from drstencil_tpu.ir.passes import analyze as janalyze
from drstencil_tpu.ops.config import KernelConfig as JConfig
from drstencil_tpu.parallel import halo as jhalo
from drstencil_tpu.parallel import stream_shard as jshard
from drstencil_tpu_torch import convert
from drstencil_tpu_torch.ir import golden
from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops import stream as tstream
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.parallel import halo, stream_shard
from drstencil_tpu_torch.parallel.model import winner_rows
from drstencil_tpu_torch.tune import tuned

from conftest import small_spec


def port_spec(name, dims=None):
    j = small_spec(name, dims)
    return convert.spec_from_fields(j.name, j.dims, j.iterations, j.taps)


def cpu_mesh(n=4):
    return halo.make_mesh(n, devices=["cpu"] * n)


# ---- the plain decomposition (parallel/halo) -------------------------------

@pytest.mark.parametrize("name", ["2d5pt_star", "2d9pt_box", "3d7pt_star"])
def test_sharded_matches_golden(name):
    """fp64 state, two pairs: the decomposition is exact up to fp64
    summation order (1e-9, the JAX test's gate)."""
    spec = port_spec(name)
    an = analyze(spec, step=1)
    mesh = cpu_mesh()
    pair = halo.sharded_pair(an, mesh)
    a0, b0 = golden.random_state(spec, seed=0, dtype=np.float64)
    a, b = mesh.put(a0), mesh.put(b0)
    for _ in range(2):
        a, b = pair(a, b)
    want = golden.run_golden(spec, step=1, pairs=2)["a"]
    me, _ = golden.check_error(mesh.gather(a).numpy(), want, an.halo)
    assert me < 1e-9, f"max_err={me}"


def test_sharded_step2():
    spec = port_spec("2d9pt_star")
    an = analyze(spec, step=2)
    mesh = cpu_mesh()
    pair = halo.sharded_pair(an, mesh)
    a0, b0 = golden.random_state(spec, seed=1, dtype=np.float64)
    a, b = pair(mesh.put(a0), mesh.put(b0))
    want = golden.run_golden(spec, step=2, seed=1, pairs=1)["a"]
    me, _ = golden.check_error(mesh.gather(a).numpy(), want, an.halo)
    assert me < 1e-9


def test_eight_device_mesh():
    spec = port_spec("2d5pt_star", (64, 256))
    an = analyze(spec, step=1)
    mesh = cpu_mesh(8)
    pair = halo.sharded_pair(an, mesh)
    a0, b0 = golden.random_state(spec, seed=0, dtype=np.float64)
    a, b = pair(mesh.put(a0), mesh.put(b0))
    want = golden.run_golden(spec, step=1, pairs=1)["a"]
    me, _ = golden.check_error(mesh.gather(a).numpy(), want, an.halo)
    assert me < 1e-9


def test_plain_decomposition_matches_jax():
    """The same fp64 state through both packages' plain decompositions."""
    name, seed = "2d9pt_box", 2
    jspec = small_spec(name)
    jan = janalyze(jspec, step=1)
    jmesh = jhalo.make_mesh(4, devices=jax.devices("cpu"))
    jpair, sharding = jhalo.sharded_pair(jan, jmesh)
    a0, b0 = jgolden.random_state(jspec, seed=seed, dtype=np.float64)
    ja, _ = jpair(jax.device_put(jnp.asarray(a0), sharding),
                  jax.device_put(jnp.asarray(b0), sharding))
    spec = port_spec(name)
    mesh = cpu_mesh()
    a, _ = halo.sharded_pair(analyze(spec, step=1), mesh)(
        mesh.put(a0), mesh.put(b0))
    np.testing.assert_allclose(mesh.gather(a).numpy(), np.asarray(ja),
                               rtol=0, atol=1e-9)


def test_indivisible_axis_raises():
    an = analyze(port_spec("2d5pt_star", (66, 256)), step=1)
    with pytest.raises(ValueError, match="not divisible"):
        halo.make_sharded_apply(an, cpu_mesh())
    with pytest.raises(ValueError, match="not divisible"):
        halo.make_sharded_apply_2d(
            an, halo.make_mesh_2d((4, 2), devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="not divisible"):
        cpu_mesh().put(np.zeros((66, 8)))


def test_local_slab_smaller_than_halo_raises():
    an = analyze(port_spec("2d9pt_cross", (8, 256)), step=2)  # halo 4
    with pytest.raises(ValueError, match="local slab 2 rows < halo 4"):
        halo.make_sharded_apply(an, cpu_mesh())
    with pytest.raises(ValueError, match="smaller than the halo"):
        halo.make_sharded_apply_2d(
            an, halo.make_mesh_2d((4, 2), devices=["cpu"] * 8))


@pytest.mark.parametrize("shape,name,dims,seed", [
    ((2, 2), "2d9pt_box", None, 4),
    ((4, 2), "3d7pt_star", (16, 16, 128), 5),
], ids=["2x2_2d", "4x2_3d"])
def test_2d_mesh_decomposition(shape, name, dims, seed):
    mesh = halo.make_mesh_2d(shape, devices=["cpu"] * 8)
    spec = port_spec(name, dims)
    an = analyze(spec, step=1)
    f = halo.make_sharded_apply_2d(an, mesh)
    a0, _ = golden.random_state(spec, seed=seed, dtype=np.float64)
    # a destination with a frame worth keeping
    b0 = np.random.default_rng(seed).uniform(-1.0, 1.0, spec.dims)
    b = f(mesh.put(a0), mesh.put(b0))
    want = golden.apply_interior(a0, b0, an.fused, an.halo)
    np.testing.assert_allclose(mesh.gather(b).numpy(), want, rtol=0,
                               atol=1e-9)


def test_mesh_devices():
    mesh = halo.make_mesh(3, devices=["cpu"] * 5)
    assert mesh.size == 3 and mesh.shape == (3,)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        halo.make_mesh(4, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        halo.make_mesh_2d((4, 2), devices=["cpu"] * 4)
    x = np.arange(4 * 6 * 2).reshape(4, 6, 2)
    m2 = halo.make_mesh_2d((2, 3), devices=["cpu"] * 6)
    shards = m2.put(x)
    assert [tuple(s.shape) for s in shards] == [(2, 2, 2)] * 6
    np.testing.assert_array_equal(shards[4].numpy(), x[2:, 2:4])
    np.testing.assert_array_equal(m2.gather(shards).numpy(), x)


def test_mesh_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 4 devices, have 0"):
        halo.make_mesh(4)
    with pytest.raises(ValueError, match="need 4 devices, have 0"):
        halo.make_mesh_2d((2, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        halo.make_mesh(2, devices=["cuda:0", "cuda:0"])
    spec = port_spec("2d5pt_star")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stream_shard.sharded_stream_pair(
            spec, KernelConfig(step=1),
            halo.Mesh((torch.device("cuda", 0),) * 4, (4,)))


# ---- the sharded streaming kernel (parallel/stream_shard) ------------------

STREAM_CASES = [
    ("2d5pt_star", JConfig(variant="stream", step=1, tm=16, interpret=True)),
    ("2d9pt_box", JConfig(variant="stream", step=2, tm=16, trapezoid=True,
                          interpret=True)),
    ("2d25pt_box", JConfig(variant="stream", step=2, tm=16, ch=8,
                           trapezoid=True, lane_mode="roll",
                           interpret=True)),
    ("3d7pt_star", JConfig(variant="stream", step=1, tm=56, interpret=True)),
    ("2d13pt_star", JConfig(variant="stream", step=2, tm=24, trapezoid=True,
                            lane_mode="roll", interpret=True)),
    ("3d27pt_box", JConfig(variant="stream", step=1, tm=56, interpret=True)),
    # 3D + trapezoid: level tiles compose with the exchange
    ("3d7pt_star", JConfig(variant="stream", step=2, tm=72, trapezoid=True,
                           interpret=True)),
]
STREAM_IDS = ["2d5pt_star", "2d9pt_box", "2d25pt_box", "3d7pt_star",
              "2d13pt_star", "3d27pt_box", "3d7pt_star_trap"]


def stream_dims(name):
    return (16, 16, 256) if name.startswith("3d") else (64, 256)


def jax_sharded_pairs(jspec, jcfg, a0f, b0f, pairs, n=4):
    mesh = jhalo.make_mesh(n, devices=jax.devices("cpu"))
    pair, g, sharding = jshard.sharded_stream_pair(jspec, jcfg, mesh)
    sa = jshard.shard_state(a0f, g, n)
    sb = jshard.shard_state(b0f, g, n)
    a = jax.device_put(jnp.asarray(sa[0]), sharding)
    b = jax.device_put(jnp.asarray(sb[0]), sharding)
    slabs_a = tuple(jax.device_put(jnp.asarray(s), sharding) for s in sa[1:])
    slabs_b = tuple(jax.device_put(jnp.asarray(s), sharding) for s in sb[1:])
    for _ in range(pairs):
        a, b = pair(a, b, slabs_a, slabs_b)
    return jshard.unshard_state(np.asarray(a), g, n)


def port_sharded_pairs(spec, cfg, a0f, b0f, pairs, n=4):
    pair, g = stream_shard.sharded_stream_pair(spec, cfg, cpu_mesh(n))
    state = convert.sharded_state_from_numpy(a0f, b0f, g)
    for _ in range(pairs):
        pair(state["a"], state["b"])
    return convert.sharded_state_to_numpy(state, g)[0], g


@pytest.mark.parametrize("name,jcfg", STREAM_CASES, ids=STREAM_IDS)
def test_sharded_stream_matches_jax_and_golden(name, jcfg):
    """Two pairs on four shards from the same global numpy state: within
    1e-5 of max|JAX| of the JAX package's sharded Pallas kernel in
    interpret mode (fp32 sums in another order), and within 3e-6 of
    max|gold| of the fp64 golden (the JAX test's gate)."""
    jspec = small_spec(name, stream_dims(name))
    spec = port_spec(name, stream_dims(name))
    cfg = convert.config_from_dict(asdict(jcfg))
    a0, b0 = golden.random_state(spec, seed=0, dtype=np.float64)
    a0f, b0f = a0.astype(np.float32), b0.astype(np.float32)
    pairs = 2
    got, _ = port_sharded_pairs(spec, cfg, a0f, b0f, pairs)
    want = jax_sharded_pairs(jspec, jcfg, a0f, b0f, pairs)
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel <= 1e-5, f"vs JAX: rel={rel}"

    an = analyze(spec, step=cfg.step)
    ga, gb = a0f.astype(np.float64), b0f.astype(np.float64)
    for _ in range(pairs):
        gb = golden.apply_interior(ga, gb, an.fused, an.halo)
        ga = golden.apply_interior(gb, ga, an.fused, an.halo)
    me, _ = golden.check_error(got, ga, an.halo)
    scale = max(1.0, float(np.max(np.abs(ga))))
    assert me / scale < 3e-6, f"max_err={me} (scale {scale:.3g})"


@pytest.mark.parametrize("name,jcfg", STREAM_CASES, ids=STREAM_IDS)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_stream_equals_single_device(name, jcfg, n):
    """Every stored cell runs the same operations on the same values as
    the single-device kernel's, so the sharded result is held to it cell
    for cell, well inside a 1e-6 relative gate; n = 1 included."""
    spec = port_spec(name, stream_dims(name))
    cfg = convert.config_from_dict(asdict(jcfg))
    prog = StencilProgram(spec, cfg, device="cpu")
    single = prog.final_a(prog.run_pairs(prog.init_state(3), 2))
    a0, b0 = golden.random_state(spec, seed=3, dtype=np.float64)
    got, g = port_sharded_pairs(spec, cfg, a0.astype(np.float32),
                                b0.astype(np.float32), 2, n)
    assert g.n_shards == n and g.local_rows == spec.dims[0] // n
    diff = np.abs(got - single).max() / max(1.0, np.abs(single).max())
    assert diff <= 1e-6, f"rel diff {diff}"
    np.testing.assert_array_equal(got, single)


def test_sharded_stream_bf16():
    """bf16 state on four shards: equal to the single-device bf16 program
    (the same fp32 sums rounded once), and within the bf16 gate of the JAX
    package's sharded bf16 kernel."""
    name = "2d9pt_star"
    jcfg = JConfig(variant="stream", step=2, tm=16, trapezoid=True,
                   dtype="bfloat16", interpret=True)
    spec = port_spec(name, (64, 256))
    cfg = convert.config_from_dict(asdict(jcfg))
    a0, b0 = golden.random_state(spec, seed=5, dtype=np.float64)
    # a bf16-representable state, so both packages start bit-equal
    a0f = torch.tensor(a0).to(torch.bfloat16).float().numpy()
    b0f = b0.astype(np.float32)
    got, g = port_sharded_pairs(spec, cfg, a0f, b0f, 1)
    assert g.dtype == torch.bfloat16

    prog = StencilProgram(spec, cfg, device="cpu")
    state = convert.state_from_numpy(a0f, b0f, device="cpu",
                                     dtype="bfloat16")
    np.testing.assert_array_equal(got, prog.final_a(prog.run_pairs(state, 1)))

    mesh = jhalo.make_mesh(4, devices=jax.devices("cpu"))
    pair, jg, sharding = jshard.sharded_stream_pair(
        small_spec(name, (64, 256)), jcfg, mesh)
    sa = jshard.shard_state(a0f, jg, 4)
    sb = jshard.shard_state(b0f, jg, 4)
    put = lambda x: jax.device_put(jnp.asarray(x, jnp.bfloat16), sharding)
    a, _ = pair(put(sa[0]), put(sb[0]), tuple(put(s) for s in sa[1:]),
                tuple(put(s) for s in sb[1:]))
    want = jshard.unshard_state(np.asarray(a.astype(jnp.float32)), jg, 4)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-2, f"rel={rel}"


def test_ghost_rows_and_frames():
    """Ghost rows at the two global edges stay zero, inner ghost rows hold
    the neighbours' edge rows of the source, and a destination's global
    frame is kept."""
    spec = port_spec("2d9pt_cross", (64, 256))
    cfg = KernelConfig(step=4, trapezoid=True)      # halo 8, local 16
    apply_fn, g = stream_shard.build_sharded_stream(spec, cfg, cpu_mesh())
    h, rows = g.halo, g.local_rows
    assert (h, rows, g.slab_dims) == (8, 16, (32, 256))
    assert [g.store_rows(k) for k in range(4)] == [
        (16, 24), (8, 24), (8, 24), (8, 16)]
    rng = np.random.default_rng(0)
    a0 = rng.uniform(0, 100, spec.dims).astype(np.float32)
    b0 = rng.uniform(-1, 1, spec.dims).astype(np.float32)
    a, b = stream_shard.shard_state(a0, g), stream_shard.shard_state(b0, g)
    assert a[0].shape == g.slab_dims and not a[2][:h].any()
    apply_fn(a, b)
    assert not a[0][:h].any() and not a[3][h + rows:].any()
    for k in range(3):
        assert torch.equal(a[k][h + rows:], a[k + 1][h:2 * h])
        assert torch.equal(a[k + 1][:h], a[k][rows:h + rows])
    # b's ghost rows were never written: the exchange moved only a's rows
    assert all(not s[:h].any() and not s[h + rows:].any() for s in b)
    got = stream_shard.unshard_state(b, g)
    frame = np.ones(spec.dims, bool)
    frame[h:-h, h:-h] = False
    np.testing.assert_array_equal(got[frame], b0[frame])
    assert (got[~frame] != b0[~frame]).all()


def test_shard_state_round_trip_and_checks():
    spec = port_spec("3d7pt_star", (16, 16, 256))
    _, g = stream_shard.build_sharded_stream(spec, KernelConfig(step=1),
                                             cpu_mesh())
    x = np.random.default_rng(1).uniform(0, 1, spec.dims).astype(np.float32)
    slabs = stream_shard.shard_state(x, g)
    assert [tuple(s.shape) for s in slabs] == [(6, 16, 256)] * 4
    np.testing.assert_array_equal(stream_shard.unshard_state(slabs, g), x)
    with pytest.raises(ValueError, match="is not"):
        stream_shard.shard_state(x[:8], g)
    state = convert.sharded_state_from_numpy(x, np.zeros_like(x), g)
    ra, rb = convert.sharded_state_to_numpy(state, g)
    np.testing.assert_array_equal(ra, x)
    assert not rb.any()


def test_sharded_stream_rejections():
    spec = port_spec("2d5pt_star", (66, 256))
    with pytest.raises(ValueError, match="not divisible by 4 shards"):
        stream_shard.build_sharded_stream(spec, KernelConfig(step=1),
                                          cpu_mesh())
    small = port_spec("2d9pt_cross", (16, 256))     # halo 8 > local 4
    with pytest.raises(ValueError, match="local slab 4 rows < row halo 8"):
        stream_shard.build_sharded_stream(
            small, KernelConfig(step=4, trapezoid=True), cpu_mesh())
    with pytest.raises(ValueError, match="1-axis mesh"):
        stream_shard.build_sharded_stream(
            port_spec("2d5pt_star"), KernelConfig(step=1),
            halo.make_mesh_2d((2, 2), devices=["cpu"] * 4))


def test_shard_kernel_wrapper_checks_rows():
    spec = port_spec("2d5pt_star", (16, 256))
    an = analyze(spec, step=2)
    f = tstream.build_stream_kernel(an, KernelConfig(step=2), device="cpu",
                                    row_frame=False)
    slab = torch.zeros((16 + 4, 256))
    with pytest.raises(ValueError, match="ghost rows"):
        f(slab, slab.clone(), (1, 18))
    with pytest.raises(ValueError, match="ghost rows"):
        f(slab, slab.clone(), (2, 19))
    with pytest.raises(ValueError, match="is not"):
        f(torch.zeros(spec.dims), torch.zeros(spec.dims), (2, 18))
    k = kernels.stencil2d_levels_shard
    before = k.launches
    f(slab, slab.clone(), (2, 18))
    f(slab, slab.clone(), (4, 2))       # an empty range stores nothing
    assert k.launches == before         # the plain version is not a launch
    assert kernels.kernel_for(3, shard=True) is kernels.stencil3d_levels_shard


def test_halo_traffic_accounting():
    """The model's bytes equal what the exchange copied: 2(n-1) copies per
    apply, each of halo * prod(dims[1:]) * itemsize bytes."""
    for name, dims, cfg in [
        ("2d9pt_star", (64, 256), KernelConfig(step=2, trapezoid=True)),
        ("3d7pt_star", (16, 16, 256), KernelConfig(step=2, trapezoid=True,
                                                   dtype="bfloat16")),
    ]:
        spec = port_spec(name, dims)
        n = 4
        apply_fn, g = stream_shard.build_sharded_stream(spec, cfg,
                                                        cpu_mesh(n))
        item = g.dtype.itemsize
        model = stream_shard.halo_traffic_model(
            analyze(spec, step=cfg.step), cfg.step, n, itemsize=item)
        a = stream_shard.shard_state(np.ones(spec.dims, np.float32), g)
        b = stream_shard.shard_state(np.zeros(spec.dims, np.float32), g)
        apply_fn(a, b)
        assert g.exchange.copies == 2 * (n - 1) \
            == model["copies_per_apply_mesh"]
        assert g.exchange.bytes == model["bytes_per_apply_mesh"]
        assert model["bytes_per_copy"] == g.halo * int(
            np.prod(dims[1:])) * item
        assert model["bytes_per_apply"] == 2 * model["bytes_per_copy"]
        apply_fn(b, a)
        assert g.exchange.bytes == 2 * model["bytes_per_apply_mesh"]


def test_halo_traffic_model_times():
    spec = port_spec("2d5pt_star", (64, 256))
    an = analyze(spec, step=2)
    m = stream_shard.halo_traffic_model(an, 2, 4)
    assert m["link_bytes_per_s"] == 4.5e11 and m["latency_s"] == 0.0
    assert "weak_scaling_efficiency" not in m
    assert m["halo_ms_per_apply"] == pytest.approx(
        2 * m["bytes_per_copy"] / 4.5e11 * 1e3)
    m = stream_shard.halo_traffic_model(an, 2, 4, ms_per_step_single=0.5,
                                        latency_s=1e-5)
    assert m["halo_ms_per_step"] == pytest.approx(
        (m["bytes_per_copy"] / 4.5e11 + 1e-5) * 1e3)
    assert m["weak_scaling_efficiency"] == pytest.approx(
        0.5 / (0.5 + m["halo_ms_per_step"]))


def test_weak_scaling_model_rows(monkeypatch, tmp_path):
    """A model row for every tuned winner, dtype-aware bytes, and no
    efficiency unless the card's own time is given: the ``score`` fields of
    ``tuned.json`` are TPU times and are never read."""
    monkeypatch.setattr(tuned, "TUNED_GPU_PATH",
                        str(tmp_path / "tuned_gpu.json"))
    rows = winner_rows(8)
    assert {m["name"] for m in rows} == set(tuned.tuned_entries())
    for m in rows:
        assert m["bytes_per_apply"] == 2 * m["halo"] * m["row_cells"] \
            * m["itemsize"]
        assert m["bytes_per_apply_mesh"] == 7 * m["bytes_per_apply"]
        assert m["halo_ms_per_step"] > 0.0
        assert "weak_scaling_efficiency" not in m
        assert "ms_per_step_single" not in m
    rows = winner_rows(8, ms_per_step={"2d5pt_star": 0.25}, latency_s=5e-6)
    for m in rows:
        if m["name"] == "2d5pt_star":
            assert m["ms_per_step_single"] == 0.25
            assert 0.0 < m["weak_scaling_efficiency"] < 1.0
        else:
            assert "weak_scaling_efficiency" not in m
    # the port's own winners table, where the tuner has written one
    tuned.record_best("3d7pt_star", KernelConfig(step=3),
                      {"ms_per_step": 1.3})
    by_name = {m["name"]: m for m in winner_rows(4)}
    assert by_name["3d7pt_star"]["ms_per_step_single"] == 1.3
    assert by_name["3d7pt_star"]["config"] == "stream_fu3"
    assert 0.0 < by_name["3d7pt_star"]["weak_scaling_efficiency"] < 1.0


def test_model_main_prints_every_winner(capsys, monkeypatch, tmp_path):
    from drstencil_tpu_torch.parallel import model

    monkeypatch.setattr(tuned, "TUNED_GPU_PATH",
                        str(tmp_path / "tuned_gpu.json"))
    model.main()
    out = capsys.readouterr().out
    assert all(name in out for name in tuned.tuned_entries())
    assert "not measured" in out
