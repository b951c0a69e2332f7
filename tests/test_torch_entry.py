"""The port's entry points (drstencil_tpu_torch.entry) on the CPU, beside
the repository's JAX entry (``__graft_entry__.py``)."""

import os

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from drstencil_tpu.ir import golden as jgolden
from drstencil_tpu.ir.spec import StencilSpec, load_stc
from drstencil_tpu_torch import entry as tentry
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.parallel import halo, stream_shard


def test_entry_runs_one_pair_on_cpu():
    fn, (a, b) = tentry.entry(device="cpu")
    assert tuple(a.shape) == tentry.ENTRY_DIMS == (1024, 1024)
    assert a.device.type == "cpu" and a.dtype == torch.float32
    a0 = a.clone()
    out_a, out_b = fn(a, b)
    assert out_a is a and out_b is b
    assert torch.isfinite(a).all() and b[1:-1, 1:-1].any()
    assert not torch.equal(a, a0)
    # the frame of step 1 (one cell) is frozen
    assert torch.equal(a[0], a0[0]) and torch.equal(a[:, -1], a0[:, -1])


def test_entry_state_is_the_jax_entrys():
    """The entry's example state is the numpy state the JAX entry starts
    from (``golden.random_state`` of the same spec and seed), so both
    entries' pairs are comparable; the JAX entry's 1024² interpret-mode
    pair itself is too slow to run here."""
    base = load_stc(os.path.join(os.path.dirname(jentry.__file__),
                                 "benchmarks", "2d5pt_star.stc"))
    jspec = StencilSpec(base.name, (1024, 1024), base.iterations, base.taps)
    a0, b0 = jgolden.random_state(jspec, 0, dtype=np.float64)
    _, (a, b) = tentry.entry(device="cpu")
    np.testing.assert_array_equal(a.numpy(), a0.astype(np.float32))
    assert not b.any() and not b0.any()


@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_dryrun_multichip_on_cpu_devices(n):
    before = [k.launches for k in kernels.KERNELS]
    out = tentry.dryrun_multichip(n, devices=["cpu"] * n)
    assert out["n_devices"] == n and out["devices"] == ["cpu"] * n
    assert np.isfinite(out["plain_max"]) and out["plain_max"] > 0
    assert np.isfinite(out["stream_max"]) and out["stream_max"] > 0
    assert [k.launches for k in kernels.KERNELS] == before


def test_dryrun_equals_the_single_device_program():
    """The dry run's sharded config against the same config on one device."""
    n = 4
    spec = tentry._bench_spec("2d5pt_star", (16 * n, 256))
    cfg = KernelConfig(variant="stream", step=2, tm=16, trapezoid=True)
    pair, g = stream_shard.sharded_stream_pair(
        spec, cfg, halo.make_mesh(n, devices=["cpu"] * n))
    a0 = np.random.default_rng(1).uniform(0.0, 100.0, spec.dims).astype(
        np.float32)
    a = stream_shard.shard_state(a0, g)
    b = stream_shard.shard_state(np.zeros_like(a0), g)
    pair(a, b)
    prog = StencilProgram(spec, cfg, device="cpu")
    sa, sb = torch.tensor(a0), torch.zeros(spec.dims)
    prog.pair_fn()(sa, sb)
    np.testing.assert_array_equal(stream_shard.unshard_state(a, g),
                                  sa.numpy())


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()
    with pytest.raises(ValueError, match="need 4 devices, have 0"):
        tentry.dryrun_multichip(4)
    with pytest.raises(ValueError, match="need 8 devices, have 0"):
        tentry.main(["--dryrun"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.main([])


def test_main_on_named_devices(capsys):
    tentry.main(["--dryrun", "3", "--devices", "cpu"])
    assert capsys.readouterr().out == "dryrun_multichip: ok\n"
    tentry.main(["--dryrun", "2", "--devices", "cpu,cpu"])
    assert capsys.readouterr().out == "dryrun_multichip: ok\n"
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        tentry.main(["--dryrun", "4", "--devices", "cpu,cpu"])


def test_kernel_times_needs_the_card(monkeypatch):
    from drstencil_tpu_torch.utils import kernel_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel_times.main(["tree", "2d5pt_star"])
    assert set(kernel_times.DEFAULT_STENCILS) <= set(
        os.path.splitext(f)[0] for f in os.listdir(kernel_times.BENCH_DIR))
