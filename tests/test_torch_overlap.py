"""The port's overlap probe (``drstencil_tpu_torch/tuning/exp_overlap.py``,
kernel ``overlap_probe``) on the CPU against ``tuning/exp_overlap.py`` in
Pallas interpret mode, at a small size.

The JAX file runs its sweep when it is imported, so its ``level`` and
``make`` are loaded from its source without running it: the function
definitions are compiled from the file's AST with small constants in place
of its module-level sizes, and ``pl.pallas_call`` is given
``interpret=True``.  The file itself is not edited.

The probe writes rows ``[0, TM - 4 * HK)`` of each ``TM``-row output block
and nothing else, so only those rows are compared (within 1e-5 of max|JAX|:
the same fp32 operations in the same order, XLA may contract multiply-adds)
and the others must keep the fill they had.
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.tuning import exp_overlap

JAX_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                        "tuning", "exp_overlap.py")
R, N, TM, HK = 200, 256, 48, 8      # two full strips and a ragged tail
REL_TOL = 1e-5


class _InterpretPallas:
    """``pl`` with ``pallas_call`` run in interpret mode."""

    def __getattr__(self, name):
        if name == "pallas_call":
            return functools.partial(pl.pallas_call, interpret=True)
        return getattr(pl, name)


@pytest.fixture(scope="module")
def jax_make():
    """``make`` of ``tuning/exp_overlap.py`` at the small size."""
    with open(JAX_FILE) as f:
        tree = ast.parse(f.read())
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in ("level", "make")]
    assert [d.name for d in defs] == ["level", "make"]
    g = {"jax": jax, "jnp": jnp, "np": np, "pl": _InterpretPallas(),
         "pltpu": pltpu, "R": R, "N": N, "TM": TM, "HK": HK,
         "GRID": R // TM, "CH": 8}
    exec(compile(ast.Module(body=defs, type_ignores=[]), JAX_FILE, "exec"), g)
    return g["make"]


def test_file_sizes_are_the_modules_defaults():
    with open(JAX_FILE) as f:
        src = f.read()
    assert "R, N = 8192, 8192" in src and "TM, HK = 96, 8" in src
    assert (exp_overlap.R, exp_overlap.N) == (8192, 8192)
    assert (exp_overlap.TM, exp_overlap.HK) == (96, 8)


@pytest.mark.parametrize("variant", ["A", "B", "C"])
@pytest.mark.parametrize("depth", [1, 2])
def test_probe_matches_jax_on_the_written_rows(jax_make, variant, depth):
    call, shape = jax_make(variant)
    pcall, pshape = exp_overlap.make(variant, depth, "cpu", R=R, N=N, TM=TM,
                                     HK=HK)
    assert tuple(shape) == tuple(pshape)
    x = np.random.default_rng(3).uniform(0.0, 100.0, shape).astype(np.float32)
    want = np.asarray(call(jnp.asarray(x)))

    fill = -3.0
    out = torch.full((R, N), fill)
    got, carry = pcall(torch.from_numpy(x), out)
    assert got is out
    got = got.numpy()
    n_strips, rows = R // TM, TM - 4 * HK
    written = np.zeros(R, dtype=bool)
    for i in range(n_strips):
        written[i * TM:i * TM + rows] = True
    assert written.sum() == n_strips * rows
    top = np.abs(want[written]).max()
    assert np.abs(got[written] - want[written]).max() <= REL_TOL * top
    assert np.all(got[~written] == fill)        # never written
    if variant == "C":
        n_ctas = carry.shape[0]
        assert carry.shape == (n_ctas, HK, kernels.PROBE_TILE)
        # every CTA's carry is half of the first HK rows of its last tile
        tiles = n_strips * (N // kernels.PROBE_TILE)
        assert n_ctas == tiles
        np.testing.assert_array_equal(
            carry[0].numpy(), x[:HK, :kernels.PROBE_TILE] * 0.5)
    else:
        assert carry is None


def test_level_is_the_files_weights():
    """One level on a delta: the 5 x 5 weights of exp_overlap.py:45-49."""
    x = torch.zeros(1, 12, 16)
    x[0, 6, 8] = 1.0
    y = kernels.probe_level_ref(x, 8)[0]
    w = np.array([[0.02, 0.05, 0.1, 0.05, 0.02],
                  [0.05, 0.1, 0.2, 0.1, 0.05],
                  [0.1, 0.2, 0.3, 0.2, 0.1]], dtype=np.float32)
    # out[r, c] = sum_d,s W[d][s] x[r + d, c + s]: the delta at (6, 8) lands
    # on out[6 - d, 8 - s]; rows 0 and 4 share p2's weights, 1 and 3 p1's
    by_d = {0: w[:, 0], 4: w[:, 0], 1: w[:, 1], 3: w[:, 1], 2: w[:, 2]}
    for d in range(5):
        for s in range(-2, 3):
            np.testing.assert_allclose(
                float(y[6 - d, 8 - s]), by_d[d][2 - abs(s)], rtol=1e-6)
    assert float(y.sum()) == pytest.approx(
        sum(2 * by_d[d][0] + 2 * by_d[d][1] + by_d[d][2] for d in range(5)),
        rel=1e-5)


def test_columns_wrap():
    x = torch.zeros(1, 12, 128)
    x[0, 2, 0] = 1.0
    y = kernels.probe_level_ref(x, 8)[0]
    assert float(y[0, 126]) > 0 and float(y[0, 2]) > 0 and \
        float(y[0, 3]) == 0


@pytest.mark.parametrize("kw,message", [
    (dict(TM=44), "multiples of 8"),
    (dict(N=200), f"multiple of {kernels.PROBE_TILE}"),
    (dict(HK=1), "hk >= 2"),
])
def test_bad_sizes_are_rejected(kw, message):
    sizes = dict(R=R, N=N, TM=TM, HK=HK)
    sizes.update(kw)
    call, shape = exp_overlap.make("A", 1, "cpu", **sizes)
    with pytest.raises(ValueError, match=message):
        call(torch.zeros(shape), torch.zeros((sizes["R"], sizes["N"])))


def test_wrong_input_shape_and_variant():
    call, shape = exp_overlap.make("B", 2, "cpu", R=R, N=N, TM=TM, HK=HK)
    with pytest.raises(ValueError, match="variant B reads"):
        call(torch.zeros((R, N)), torch.zeros((R, N)))
    with pytest.raises(ValueError, match="not one of"):
        exp_overlap.make("D", 2, "cpu")
    before = kernels.overlap_probe.launches
    call(torch.zeros(shape), torch.zeros((R, N)))
    assert kernels.overlap_probe.launches == before


def test_measuring_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp_overlap.measure("A", 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp_overlap.main([])
