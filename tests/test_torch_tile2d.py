"""The port's plain-tile experiment (``drstencil_tpu_torch/tuning/
exp_tile2d.py``, kernel ``tile2d_fused``) on the CPU against
``tuning/exp_tile2d.py`` in Pallas interpret mode, mirroring
``tests/test_tile2d.py``.

Both packages get the same numpy state in the same ``(R + 2 * tm, C)``
padded layout.  One application from zero pads is determined on the whole
data block (boundary rows from the zero pads, columns wrapped), so there
the two must agree within 1e-5 of max|JAX| everywhere (fp32 sums in the
same order; XLA may contract multiply-adds).  After a pair, the JAX side's
never-written pad blocks hold whatever its output buffer held, so the pair
is held against the fp64 golden at the experiment's own inset of 3 halos.
"""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drstencil_tpu.ir import golden
from drstencil_tpu_torch import convert
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.tuning import exp_tile2d

from conftest import small_spec

CASES = [
    ("2d5pt_star", 2, 32),
    ("2d9pt_box", 2, 32),    # radius-1 box: all column-shift groups
    ("2d25pt_box", 2, 32),   # h=4, 81 fused taps
]
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_exp():
    sys.path.insert(0, ".")
    return importlib.import_module("tuning.exp_tile2d")


def port_spec(name):
    jspec = small_spec(name)
    return jspec, convert.spec_from_fields(jspec.name, jspec.dims,
                                           jspec.iterations, jspec.taps)


@pytest.mark.parametrize("name,step,tm", CASES)
def test_one_application_matches_jax_on_the_whole_block(jax_exp, name, step,
                                                        tm):
    jspec, spec = port_spec(name)
    a0, _ = golden.random_state(jspec, 0, dtype=np.float64)
    a0 = a0.astype(np.float32)

    jpair, jpad, junpad, jan = jax_exp.build_tile_program(
        jspec, step=step, tm=tm, interpret=True)
    # the pair's b is one application, b = call(a), from a's zero pads
    ja = jpad(jnp.asarray(a0))
    _, jb = jax.jit(jpair)(ja, jpad(jnp.zeros_like(ja[:a0.shape[0]])))
    want = np.asarray(junpad(jb))

    pair, pad, unpad, an = exp_tile2d.build_tile_program(spec, step, tm,
                                                         device="cpu")
    assert an.halo == jan.halo and an.fused == jan.fused
    a = convert.padded_state_from_numpy(a0, tm, "cpu")
    fill = torch.full_like(a, -7.0)
    b = fill.clone()
    taps = kernels.tile2d_taps(an.fused, an.halo)
    kernels.tile2d_fused(a, b, taps, tm)
    got = convert.padded_state_to_numpy(b, tm)
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    # pad rows bit-unchanged, in the destination and in the source
    R = spec.dims[0]
    assert torch.equal(b[:tm], fill[:tm]) and torch.equal(b[tm + R:],
                                                          fill[tm + R:])
    assert not a[:tm].any() and not a[tm + R:].any()


@pytest.mark.parametrize("name,step,tm", CASES)
def test_tile_pair_matches_golden(name, step, tm):
    _, spec = port_spec(name)
    pair, pad, unpad, an = exp_tile2d.build_tile_program(spec, step, tm,
                                                         device="cpu")
    h = an.halo
    a0, b0 = golden.random_state(spec, 0, dtype=np.float64)
    a = pad(torch.from_numpy(a0.astype(np.float32)))
    b = pad(torch.from_numpy(b0.astype(np.float32)))
    pair(a, b)
    ga, gb = a0.copy(), b0.copy()
    gb = golden.apply_interior(ga, gb, an.fused, h)
    ga = golden.apply_interior(gb, ga, an.fused, h)
    # boundary divergence creeps h rows/cols per application from the
    # unwritten pads + interior-update band: compare inset 3h
    ins = 3 * h
    got = unpad(a).numpy()[ins:-ins, ins:-ins]
    want = ga[ins:-ins, ins:-ins]
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0)
    assert err < 1e-5, f"tile kernel diverges from golden: {err}"


def test_pad_unpad_round_trip_and_layout():
    _, spec = port_spec("2d5pt_star")
    R, C = spec.dims
    _, pad, unpad, _ = exp_tile2d.build_tile_program(spec, 2, 32, "cpu")
    x = torch.arange(R * C, dtype=torch.float32).reshape(R, C)
    assert pad(x).shape == (R + 64, C)
    assert torch.equal(unpad(pad(x)), x)
    buf = convert.padded_state_from_numpy(x.numpy(), 32, "cpu")
    assert torch.equal(buf, pad(x))
    np.testing.assert_array_equal(convert.padded_state_to_numpy(buf, 32),
                                  x.numpy())


def test_taps_are_grouped_as_the_jax_kernel_groups_them():
    _, spec = port_spec("2d9pt_box")
    _, _, _, an = exp_tile2d.build_tile_program(spec, 2, 32, "cpu")
    taps = kernels.tile2d_taps(an.fused, an.halo)
    assert [dj for dj, _ in taps.groups] == [-2, -1, 0, 1, 2]
    assert taps.ntaps == len(an.fused) == 25
    for dj, rows in taps.groups:
        assert [di for di, _ in rows] == sorted(di for di, _ in rows)
        for di, c in rows:
            assert c == an.fused[(di, dj)]


@pytest.mark.parametrize("tm,message", [
    (24, "must divide"), (12, "must divide"),
])
def test_bad_tm_is_rejected(tm, message):
    _, spec = port_spec("2d5pt_star")
    with pytest.raises(ValueError, match=message):
        exp_tile2d.build_tile_program(spec, 2, tm, "cpu")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, spec = port_spec("2d5pt_star")
    _, pad, _, an = exp_tile2d.build_tile_program(spec, 2, 32, "cpu")
    taps = kernels.tile2d_taps(an.fused, an.halo)
    a = pad(torch.zeros(spec.dims))
    with pytest.raises(TypeError, match="float32"):
        kernels.tile2d_fused(a.double(), a.double(), taps, 32)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.tile2d_fused(a[:64 + 8], a[:64 + 8].clone(), taps, 4)
    with pytest.raises(ValueError, match="one shape"):
        kernels.tile2d_fused(a, a[:-1], taps, 32)
    before = kernels.tile2d_fused.launches
    kernels.tile2d_fused(a, a.clone(), taps, 32)
    assert kernels.tile2d_fused.launches == before   # the CPU path counts none


def test_sweep_is_the_jax_experiments(jax_exp):
    assert exp_tile2d.SWEEP == jax_exp.SWEEP


def test_measuring_needs_the_card():
    _, spec = port_spec("2d5pt_star")
    with pytest.raises(RuntimeError, match="measure"):
        exp_tile2d.measure_tile(spec, 2, 32, device="cpu")
