"""The port's IR (drstencil_tpu_torch.ir) against the JAX package's.

Both parse the same `.stc` files, fuse the same tables and draw the same
numpy initial state; fused tables must be bit-equal, since plan grouping
and every later comparison rests on them.
"""

import os

import numpy as np
import pytest
import torch

from drstencil_tpu.ir import golden as jgolden
from drstencil_tpu.ir import passes as jpasses
from drstencil_tpu.ir import spec as jspec
from drstencil_tpu.ops import xla_ref as jxla_ref
from drstencil_tpu_torch.ir import golden as tgolden
from drstencil_tpu_torch.ir import passes as tpasses
from drstencil_tpu_torch.ir import spec as tspec
from drstencil_tpu_torch.ops import xla_ref as txla_ref

from conftest import BENCH_DIR, small_spec

STC_NAMES = sorted(f[:-4] for f in os.listdir(BENCH_DIR) if f.endswith(".stc"))


def load_both(name):
    path = os.path.join(BENCH_DIR, name + ".stc")
    return jspec.load_stc(path), tspec.load_stc(path)


def test_all_eleven_stencils_present():
    assert len(STC_NAMES) == 11


@pytest.mark.parametrize("name", STC_NAMES)
def test_load_stc_matches(name):
    j, t = load_both(name)
    assert (t.name, t.dims, t.iterations) == (j.name, j.dims, j.iterations)
    assert t.sorted_taps() == j.sorted_taps()
    assert t.radius() == j.radius()
    assert t.to_stc() == j.to_stc()


@pytest.mark.parametrize("step", [1, 2, 3])
@pytest.mark.parametrize("name", STC_NAMES)
def test_fuse_bit_equal(name, step):
    j, t = load_both(name)
    jf = jpasses.fuse(j.taps, step)
    tf = tpasses.fuse(t.taps, step)
    # same keys in the same insertion order, bit-equal coefficients
    assert list(tf.keys()) == list(jf.keys())
    for off in jf:
        assert np.float64(tf[off]).tobytes() == np.float64(jf[off]).tobytes()
    assert tpasses.order_of(tf) == jpasses.order_of(jf)
    assert tpasses.default_distance(tf) == jpasses.default_distance(jf)


def _analyze_or_error(mod, spec, step):
    try:
        return mod.analyze(spec, step=step)
    except mod.AnalysisError as e:
        return str(e)


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("name", STC_NAMES)
def test_analyze_and_analysis_errors_match(name, step):
    """Same partition where both succeed; AnalysisError with the same
    message where the JAX package raises it (2D cross stencils at step 1
    have no axis-0 reuse)."""
    j, t = load_both(name)
    ja = _analyze_or_error(jpasses, j, step)
    ta = _analyze_or_error(tpasses, t, step)
    if isinstance(ja, str):
        assert ta == ja
        # the gold's relaxed analysis tolerates it on both sides
        assert tpasses.analyze(t, step, require_partition=False).part is None
        return
    assert (ta.order, ta.distance, ta.halo) == (ja.order, ja.distance, ja.halo)
    assert ta.part.forward == ja.part.forward
    assert ta.part.backward == ja.part.backward
    assert (ta.part.low, ta.part.high) == (ja.part.low, ja.part.high)


def test_cross_step1_raises_analysis_error():
    _, t = load_both("2d5pt_cross")
    with pytest.raises(tpasses.AnalysisError, match="No data to reuse"):
        tpasses.analyze(t, step=1)
    assert issubclass(tpasses.AnalysisError, ValueError)


@pytest.mark.parametrize("call", [
    lambda m, taps: m.fuse(taps, 0),
    lambda m, taps: m.partition(taps, 0),
])
def test_pass_argument_errors_match(call):
    _, t = load_both("2d5pt_star")
    with pytest.raises(jpasses.AnalysisError) as je:
        call(jpasses, t.taps)
    with pytest.raises(tpasses.AnalysisError) as te:
        call(tpasses, t.taps)
    assert str(te.value) == str(je.value)


def test_parse_errors_match():
    bad = "M 8\nN 8\niteratioins 4\nstencil\n0 0 1.0\n"
    with pytest.raises(jspec.StcError) as je:
        jspec.parse_stc(bad)
    with pytest.raises(tspec.StcError) as te:
        tspec.parse_stc(bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", ["2d9pt_box", "3d7pt_star"])
def test_random_state_and_golden_apply_equal(name):
    js = small_spec(name)
    ts = tspec.StencilSpec(js.name, js.dims, js.iterations, dict(js.taps))
    ja, jb = jgolden.random_state(js, seed=5)
    ta, tb = tgolden.random_state(ts, seed=5)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    fused = tpasses.fuse(ts.taps, 2)
    h = tpasses.order_of(fused)
    np.testing.assert_array_equal(
        tgolden.apply_interior(ta, tb, fused, h),
        jgolden.apply_interior(ja, jb, fused, h))
    jr = jgolden.run_golden(js, step=2, seed=1, pairs=1)
    tr = tgolden.run_golden(ts, step=2, seed=1, pairs=1)
    np.testing.assert_array_equal(tr["a"], jr["a"])


@pytest.mark.parametrize("name", ["2d13pt_star", "3d27pt_box"])
def test_torch_gold_matches_xla_gold(name):
    """The port's plain-torch gold operator against the JAX package's XLA
    gold, fp32 both: same taps, same order, one rounding at the store."""
    js = small_spec(name)
    ts = tspec.StencilSpec(js.name, js.dims, js.iterations, dict(js.taps))
    ja = jpasses.analyze(js, step=2, require_partition=False)
    ta = tpasses.analyze(ts, step=2, require_partition=False)
    a0, _ = jgolden.random_state(js, seed=2, dtype=np.float32)
    b0 = np.full(js.dims, 7.0, np.float32)
    want = np.asarray(jxla_ref.apply_interior(ja)(a0, b0))
    got = txla_ref.apply_interior(ta)(
        torch.from_numpy(a0), torch.from_numpy(b0.copy())).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale <= 1e-6
    h = ta.halo
    frame = np.ones(js.dims, bool)
    frame[tuple(slice(h, s - h) for s in js.dims)] = False
    assert (got[frame] == 7.0).all()
