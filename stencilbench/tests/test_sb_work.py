"""The request arithmetic and the count the kernels' roofline rests on."""

import pytest

from stencilbench import cells, reference, work
from drstencil_tpu_torch.tune.tuned import CARD_PEAKS

PAIRS_48 = {1: 24, 2: 12, 3: 8, 4: 6, 5: 5, 6: 4, 7: 4, 8: 3}


@pytest.mark.parametrize("step", sorted(PAIRS_48))
def test_pairs_and_computed_timesteps(step):
    pairs = work.pairs_per_request(48, step)
    assert pairs == PAIRS_48[step]
    computed = work.computed_timesteps(48, step)
    assert computed == pairs * 2 * step >= 48
    assert computed - 48 < 2 * step
    # 48 is a whole number of pairs for every step of the winners table
    assert (computed == 48) == (48 % (2 * step) == 0)


@pytest.mark.parametrize("config,taps,gflop,gbyte", [
    ("2d25pt_box", 25, 157.8, 0.537), ("3d7pt_star", 7, 83.75, 1.074),
    ("2d25pt_box-bf16", 25, 157.8, 0.2684),
    ("3d7pt_star-bf16", 7, 83.75, 0.537)])
def test_roofline_count_per_request(config, taps, gflop, gbyte):
    conf = cells.load_json(cells.ROOT, "configs", config)
    dims, table = reference.load_stc(f"{cells.ROOT}/configs/{conf['stc']}")
    assert len(table) == taps and list(dims) == conf["dims"]
    for step in (1, 3, 4, 6):   # the count does not depend on the plan
        w = work.work_of(dims, len(table), 48, step, conf["dtype"])
        assert w.flops / 1e9 == pytest.approx(gflop, rel=1e-3)
        assert w.bytes / 1e9 == pytest.approx(gbyte, rel=1e-3)
        least = w.least_seconds(work.card_peaks("NVIDIA H100 80GB HBM3"))
        assert least == pytest.approx(w.flops / 67e12)   # flops bind


def test_peaks_are_the_ports_data_sheet_table():
    for fragment, (gbps, tflops) in CARD_PEAKS:
        assert work.card_peaks(f"NVIDIA {fragment}") == (gbps * 1e9,
                                                         tflops * 1e12)
    assert work.card_peaks("NVIDIA H100 PCIe") == (2000e9, 51e12)
    assert work.card_peaks("some other card") is None


def test_field_comes_from_the_seed():
    a = work.make_field((8, 6), 2**31 + 7, "cpu")
    assert a.equal(work.make_field((8, 6), 2**31 + 7, "cpu"))
    assert not a.equal(work.make_field((8, 6), 2**31 + 8, "cpu"))
    assert float(a.min()) >= 0 and float(a.max()) < 100
