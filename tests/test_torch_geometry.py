"""The CTA's tile as knobs: ``KernelConfig.tm`` (the segment of axis 0 a
CTA walks) and ``ch`` (its column) through ``ops/codegen.geometry``, the
plan key, the tuner's space, the CLI and the emitter, and the SM count.

- With ``tm=None, ch=None`` every plan's text is the one the generator
  wrote before the knobs existed: ``torch_geometry_manifest.json`` holds
  the SHA-256 of those texts (at ``codegen.SM_COUNT``) for every winner of
  ``benchmarks/tuned.json`` and of the card's first winners table in both
  dtypes, full grid and shard slab, factor mode's plans and
  ``tile2d_fused``'s, with the configs they were made from.
- Texts of other tiles compile under the ``g++`` emulation
  (``tests/cuda_emulation``, as in ``test_torch_codegen.py``) and give the
  default tile's output bit for bit: every cell runs the same sorted
  ``fmaf`` chain whatever the tile.
- On the CPU the tile changes nothing, and the port agrees with the JAX
  package's interpret-mode kernel run with its own ``tm``.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from dataclasses import asdict

import numpy as np
import pytest
import torch

from drstencil_tpu.ops.runner import StencilProgram as JProgram
from drstencil_tpu.tune import tuned as jtuned
from drstencil_tpu_torch import cli as cli_mod
from drstencil_tpu_torch import convert, emit as emit_mod
from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import StencilSpec, load_stc
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops import stream as stream_mod
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.ops.stream import level_plan
from drstencil_tpu_torch.tune import space
from drstencil_tpu_torch.tune import tuned as tuned_mod
from drstencil_tpu_torch.tune.tuner import Tuner
from drstencil_tpu_torch.tuning.exp_tile2d import SWEEP

from conftest import BENCH_DIR, small_spec
from test_torch_codegen import emulated

HERE = os.path.dirname(os.path.abspath(__file__))
MANIFEST = json.load(open(os.path.join(HERE, "torch_geometry_manifest.json")))
KERNEL_TOL = 1e-5
# the card's fp32 winners of the two cases the geometry phase of
# chip_smoke.py sweeps, as the first winners table recorded them
WINDOWED_2D = ("2d5pt_star", KernelConfig(step=6, trapezoid=True, block=2,
                                          lane_mode="roll"))
BOX_3D = ("3d27pt_box", KernelConfig(step=2, trapezoid=True))


def bench_spec(name, dims=None):
    spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
    if dims is None:
        return spec
    return StencilSpec(spec.name, tuple(dims), spec.iterations, spec.taps)


def plan_for(spec, cfg):
    return level_plan(analyze(spec, cfg.step, cfg.distance,
                              cfg.merge_forward), cfg)


def sha(text):
    return hashlib.sha256(text.encode()).hexdigest()


def tiles(spec, cfg):
    """``cfg`` at the generator's tile, then every tile the space emits
    beside it."""
    return [cfg] + [c.cfg for c in space.tile_candidates(spec, cfg)]


@pytest.fixture
def no_card_tables(monkeypatch, tmp_path):
    """The port's table pointed at a missing file: ``best_config`` falls
    back to the TPU winners."""
    monkeypatch.setattr(tuned_mod, "TUNED_GPU_PATH",
                        str(tmp_path / "tuned_gpu.json"))


# -- the text that nothing asked to change ------------------------------------

@pytest.mark.parametrize("item", MANIFEST["items"],
                         ids=[i["key"] for i in MANIFEST["items"]])
def test_default_tile_text_is_unchanged(item):
    spec = bench_spec(item["stencil"])
    if item["key"].startswith("tile2d"):
        an = analyze(spec, step=item["step"], require_partition=False)
        taps = kernels.tile2d_taps(an.fused, an.halo)
        text = codegen.tile2d_source(taps, spec.dims[0], spec.dims[1],
                                     item["tm"], sms=codegen.SM_COUNT)
    else:
        cfg = KernelConfig.from_dict(item["config"])
        assert cfg.tm is None and cfg.ch is None
        text = codegen.cuda_source(plan_for(spec, cfg), tuple(item["dims"]),
                                   cfg.dtype, item["shard"],
                                   sms=codegen.SM_COUNT)
    assert sha(text) == item["sha256"]


def test_manifest_covers_both_tables_dtypes_and_builds():
    keys = {i["key"] for i in MANIFEST["items"]}
    names = sorted(tuned_mod.tuned_entries())
    for table in ("tpu", "gpu"):
        for name in names:
            for dtype in codegen.DTYPES:
                assert f"{table} {name} {dtype}" in keys
                assert f"{table} {name} {dtype} shard" in keys
    assert sum(k.startswith("factor") for k in keys) == 12
    assert sum(k.startswith("tile2d") for k in keys) == sum(
        len(v) for v in SWEEP.values())


# -- what tm and ch name ------------------------------------------------------

def test_tm_is_the_segment_and_ch_the_column():
    spec = bench_spec(WINDOWED_2D[0])
    plan = plan_for(spec, WINDOWED_2D[1])
    g = codegen.geometry(plan, spec.dims)
    assert g.tile == (264, 496)
    # ch: a STRIP_2D strip's output width (hx = 8 halo columns a side)
    assert codegen.columns(plan, spec.dims) == tuple(
        ex - 16 for ex in codegen.STRIP_2D if ex - 16 >= codegen.QUAD)
    g2 = codegen.geometry(dataclasses.replace(plan, segment=100, column=240),
                          spec.dims)
    assert g2.tile == (100, 240) and g2.ex == 256
    assert g2.n_segments == -(-(8192 - 12) // 100)
    # a segment past the interior is the interior
    assert codegen.geometry(plan, spec.dims, segment=10 ** 6).tile[0] \
        == 8192 - 12
    # 3D: TY * TX of a COLUMNS_3D pair, cut to the grid
    spec3 = bench_spec(BOX_3D[0])
    plan3 = plan_for(spec3, BOX_3D[1])
    assert codegen.columns(plan3, spec3.dims) == tuple(
        ty * tx for ty, tx in codegen.COLUMNS_3D)
    assert codegen.geometry(plan3, spec3.dims, column=24 * 64).tile[1:] \
        == (24, 64)
    small = codegen.geometry(plan3, (20, 10, 40), column=32 * 64)
    assert small.tile[1:] == (10, 40)


def test_invalid_tiles_are_rejected():
    spec = bench_spec(WINDOWED_2D[0])
    plan = plan_for(spec, WINDOWED_2D[1])
    g = codegen.geometry(plan, spec.dims)
    with pytest.raises(ValueError, match="names no strip"):
        codegen.geometry(plan, spec.dims, column=500)
    with pytest.raises(ValueError, match="shorter than the 15 planes"):
        codegen.geometry(plan, spec.dims, segment=g.warmup - 1)
    # ... unless it covers the whole interior
    assert codegen.geometry(plan, (20, 600), segment=8).tile[0] == 8
    # rings past 227 KB: the widest 3D column of a deep trapezoid
    spec3 = bench_spec("3d13pt_star")
    deep = plan_for(spec3, KernelConfig(step=8, trapezoid=True))
    with pytest.raises(ValueError, match="shared memory"):
        codegen.geometry(deep, spec3.dims, column=32 * 64)
    # the space's filter turns every rejection into None
    for cfg in (KernelConfig(step=6, trapezoid=True, block=2, ch=500),
                KernelConfig(step=6, trapezoid=True, block=2, tm=3),
                KernelConfig(step=6, trapezoid=True, block=2, tm=0),
                KernelConfig(step=6, trapezoid=True, block=2, ch=-8)):
        assert space.smem_estimate(spec, cfg) is None
    assert space.smem_estimate(spec3, KernelConfig(
        step=8, trapezoid=True, ch=2048)) is None
    with pytest.raises(ValueError, match="positive int"):
        level_plan(analyze(spec, 1), KernelConfig(tm=0))
    # the CPU path refuses what the card would
    with pytest.raises(ValueError, match="names no strip"):
        StencilProgram(bench_spec("2d5pt_star", (64, 256)),
                       KernelConfig(step=2, ch=7), device="cpu")


@pytest.mark.parametrize("case", [WINDOWED_2D, BOX_3D],
                         ids=["2d_windowed", "3d_box"])
def test_each_tile_is_its_own_kernel(case):
    """Every valid (tm, ch) gives its own plan key, text and hash; configs
    that differ only in the tile never share a cached kernel."""
    name, cfg = case
    spec = bench_spec(name)
    cfgs = tiles(spec, cfg)
    assert len(cfgs) >= 3
    plans = [plan_for(spec, c) for c in cfgs]
    assert [(p.segment, p.column) for p in plans] == [(c.tm, c.ch)
                                                      for c in cfgs]
    keys = {kernels.plan_key(p, spec.dims, "float32") for p in plans}
    texts = [codegen.cuda_source(p, spec.dims, "float32", False)
             for p in plans]
    hashes = {codegen.source_hash(t) for t in texts}
    geoms = {codegen.geometry(p, spec.dims) for p in plans}
    assert len(keys) == len(hashes) == len(geoms) == len(cfgs)
    built = {id(kernels.plan_of(p, spec.dims, "float32", False))
             for p in plans}
    assert len(built) == len(cfgs)
    for p, text in zip(plans, texts):
        g = kernels.geometry(p, spec.dims)
        assert f"constexpr int SEG = {g.tile[0]}, " in text
        assert kernels.tile_shape(p, spec.dims) == g.tile


# -- the SM count -------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA device of 114 SMs (an H100 PCIe's) as the runtime reports
    it."""
    class Props:
        multi_processor_count = 114

    asked = []

    def props(index):
        asked.append(index)
        return Props()

    kernels._device_sms.cache_clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    yield asked
    kernels._device_sms.cache_clear()


def test_sm_count_without_a_card_is_the_text_constant():
    assert not torch.cuda.is_available()
    assert kernels.sm_count() == kernels.sm_count("cpu") == codegen.SM_COUNT
    assert codegen.SM_COUNT == 132


def test_sm_count_is_read_from_the_card(fake_card):
    spec = bench_spec(WINDOWED_2D[0])
    plan = plan_for(spec, WINDOWED_2D[1])
    assert kernels.sm_count() == kernels.sm_count("cuda:0") == 114
    assert fake_card == [0]             # read once, then cached
    assert kernels.sm_count("cpu") == codegen.SM_COUNT
    on_card = kernels.plan_key(plan, spec.dims, "float32")
    assert on_card[-1] == 114
    assert on_card != kernels.plan_key(plan, spec.dims, "float32",
                                       sms=codegen.SM_COUNT)
    # fewer SMs: the wave-optimal segment is longer, the text another
    g114, g132 = (codegen.geometry(plan, spec.dims, s) for s in (114, 132))
    assert kernels.geometry(plan, spec.dims) == g114
    assert g114.tile[0] > g132.tile[0]
    assert codegen.source_hash(codegen.cuda_source(
        plan, spec.dims, "float32", False, sms=114)) != codegen.source_hash(
        codegen.cuda_source(plan, spec.dims, "float32", False))
    # an asked segment does not depend on it
    assert codegen.geometry(dataclasses.replace(plan, segment=200),
                            spec.dims, 114).tile[0] == 200


def test_the_library_builds_for_the_cards_sm_count(fake_card, monkeypatch):
    """``build_stream_kernel`` on a CUDA device builds the plan for the
    count the device reports; the wrappers' plan caches are per device."""
    asked = []

    def fake_plan_kernel(taps, dims, dtype, shard=False, sms=None):
        asked.append((tuple(dims), shard, sms))

    monkeypatch.setattr(kernels, "plan_kernel", fake_plan_kernel)
    spec = bench_spec("2d5pt_star", (64, 256))
    an = analyze(spec, 2)
    stream_mod.build_stream_kernel(an, KernelConfig(step=2, trapezoid=True),
                                   device="cuda:0")
    stream_mod.build_stream_kernel(an, KernelConfig(step=2, trapezoid=True),
                                   device="cuda:0", row_frame=False)
    assert asked == [((64, 256), False, 114), ((68, 256), True, 114)]
    tile = kernels.tile2d_plan(kernels.tile2d_taps(an.fused, an.halo),
                               (64 + 32, 256), 16)
    assert tile.geometry == codegen.tile2d_geometry(
        kernels.tile2d_taps(an.fused, an.halo), 64, 256, 16, 114)


def test_emitted_programs_are_written_for_sm_count(fake_card):
    """An emitted program's text is the library's for ``SM_COUNT``, whatever
    card the emitter runs beside, and says so in its header."""
    spec = bench_spec("2d5pt_star")
    text = emit_mod.emit(spec, step=2, trapezoid=True)
    plan = plan_for(spec, KernelConfig(step=2, trapezoid=True))
    cuda = text.split("CUDA_SOURCE = r'''\n")[1].split("'''")[0]
    assert cuda.strip("\n") == codegen.cuda_source(
        plan, spec.dims, "float32", False, spec.name,
        KernelConfig(step=2, trapezoid=True).label(), sms=132)
    assert "segments sized for 132 SMs" in text


# -- emulated texts: every tile gives the default's bits ----------------------

EMU_CASES = {
    # a windowed 2D plan: a short last segment, narrower strips
    "2d_windowed": ("2d5pt_star", (60, 1100), WINDOWED_2D[1], "float32",
                    [(20, None), (None, 240), (25, 112), (16, 48)]),
    # a strip wider than the grid (the 512-cell strip of a plan whose
    # default is 256 wide there), and a narrower one
    "2d_wide_strip": ("2d13pt_star", (64, 420),
                      KernelConfig(step=8, trapezoid=True), "float32",
                      [(None, 464), (None, 80)]),
    "2d_odd_width": ("2d9pt_star", (40, 203),
                     KernelConfig(step=3, trapezoid=True), "float32",
                     [(15, 48), (None, 112)]),
    "3d_box": ("3d27pt_box", (20, 40, 136), BOX_3D[1], "float32",
               [(7, None), (None, 24 * 64), (11, 8 * 32)]),
    "3d_bf16": ("3d7pt_star", (21, 30, 72),
                KernelConfig(step=3, trapezoid=True), "bfloat16",
                [(10, 4 * 32), (None, 16 * 64)]),
    "2d_bf16_fused": ("2d9pt_box", (40, 600), KernelConfig(step=2),
                      "bfloat16", [(9, 248)]),
}


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_emulated_tiles_give_the_default_bits(tmp_path, case):
    name, dims, cfg, dtype, values = EMU_CASES[case]
    spec = bench_spec(name, dims)
    tdt = stream_mod.state_dtype(dtype)
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.uniform(0, 100, dims)).to(tdt)
    fill = torch.from_numpy(rng.uniform(-0.5, 0.5, dims)).to(tdt)
    base = plan_for(spec, cfg.replace(dtype=dtype))
    want = fill.clone()
    kernels.kernel_for(len(dims)).plain(src, want, base)
    outs, geoms = [], []
    for i, (tm, ch) in enumerate([(None, None)] + values):
        plan = dataclasses.replace(base, segment=tm, column=ch)
        geoms.append(codegen.geometry(plan, dims))
        d = tmp_path / str(i)
        d.mkdir()
        launch = emulated(codegen.cuda_source(plan, dims, dtype, False), d)
        outs.append(launch(src, fill.clone()))
    assert len(set(geoms)) == len(geoms)        # every tile its own
    top = float(want.float().abs().max())
    for g, got in zip(geoms, outs):
        assert torch.equal(got.view(torch.int16 if dtype == "bfloat16"
                                    else torch.int32),
                           outs[0].view(torch.int16 if dtype == "bfloat16"
                                        else torch.int32)), g.tile
        diff = float((got.float() - want.float()).abs().max())
        if dtype == "float32":
            assert diff <= KERNEL_TOL * top
    if case == "2d_windowed":
        assert geoms[1].interior % geoms[1].tile[0]      # a short last one
    if case == "2d_wide_strip":
        assert geoms[1].ex == 420 + 2 * geoms[1].hx < 512
        assert geoms[0].ex < geoms[1].ex


# -- the CPU path and the JAX package -----------------------------------------

@pytest.mark.parametrize("name,jtm", [("2d5pt_star", 32), ("2d9pt_cross", 32),
                                      ("3d7pt_star", 80)])
def test_cpu_program_is_the_same_at_any_tile(name, jtm, no_card_tables):
    """``StencilProgram(device="cpu")`` at every tile the space emits gives
    the default tile's result, which matches the JAX package's
    interpret-mode kernel run with its own ``tm``."""
    jspec = small_spec(name)
    spec = convert.spec_from_fields(jspec.name, jspec.dims, jspec.iterations,
                                    jspec.taps)
    cfg = tuned_mod.best_config(name)
    jcfg = jtuned.best_config(name).replace(tm=jtm, ch=None, interpret=True)
    jp = JProgram(jspec, jcfg)
    want = jp.final_a(jp.run_pairs(jp.init_state(0), 1))
    results = []
    for c in tiles(spec, cfg):
        prog = StencilProgram(spec, c, device="cpu")
        results.append(prog.final_a(prog.run_pairs(prog.init_state(0), 1)))
    assert len(results) >= 2
    for got in results:
        np.testing.assert_array_equal(got, results[0])
    rel = np.abs(results[0] - want).max() / np.abs(want).max()
    assert rel <= KERNEL_TOL, rel


# -- no TPU tile size reaches the Hopper geometry -----------------------------

@pytest.mark.parametrize("name", sorted(tuned_mod.tuned_entries()))
def test_tpu_tables_reach_hopper_with_the_generators_tile(name,
                                                           no_card_tables,
                                                           monkeypatch,
                                                           tmp_path):
    entry = tuned_mod.tuned_entries()[name]["config"]
    cfg = tuned_mod.best_config(name)
    assert (cfg.tm, cfg.ch) == (None, None)
    assert cfg == KernelConfig.from_dict(entry).replace(tm=None, ch=None)
    assert convert.config_from_dict(entry) == cfg
    spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
    plan = plan_for(spec, cfg)
    assert (plan.segment, plan.column) == (None, None)
    # the tuner's prior is measured first, at the generator's tile
    prior = Tuner(spec, str(tmp_path / "t"), device="cpu").candidates(1)[0]
    assert (prior.cfg.tm, prior.cfg.ch) == (None, None)
    # the curated defaults, for names neither table has
    monkeypatch.setattr(tuned_mod, "TUNED_PATH", str(tmp_path / "no.json"))
    for curated in tuned_mod._DEFAULTS:
        assert tuned_mod.best_config(curated).tm is None


def test_chip_smokes_tpu_cases_have_the_generators_tile(monkeypatch):
    """``chip_smoke.py`` runs the TPU config of each kernel mode no card
    winner runs (here: none runs K1, K3 or K4), without its TPU tile."""
    sys.path.insert(0, os.path.dirname(HERE))
    import chip_smoke

    monkeypatch.setattr(tuned_mod, "best_config", lambda name: KernelConfig(
        step=2, trapezoid=True))
    names = sorted(tuned_mod.tuned_entries())
    specs = {n: load_stc(os.path.join(BENCH_DIR, n + ".stc")) for n in names}
    cases = chip_smoke.lost_mode_cases(names, specs)
    assert len(cases) == len(chip_smoke.MODES)
    assert any(tuned_mod.tuned_entries()[n]["config"]["tm"]
               for n, _ in cases.values())
    for _, cfg in cases.values():
        assert (cfg.tm, cfg.ch) == (None, None)


def test_the_cards_table_keeps_its_tiles(tmp_path, monkeypatch):
    """A winner of the card's table keeps the tm / ch it was measured with,
    through ``record_best`` and ``best_config``."""
    monkeypatch.setattr(tuned_mod, "TUNED_GPU_PATH",
                        str(tmp_path / "tuned_gpu.json"))
    cfg = KernelConfig(step=6, trapezoid=True, block=2, lane_mode="roll",
                       tm=132, ch=240)
    tuned_mod.record_best("2d5pt_star", cfg, {"ms_per_step": 0.01})
    assert tuned_mod.best_config("2d5pt_star") == cfg
    (tmp_path / "l").mkdir()
    (tmp_path / "l" / "s.ledger.json").write_text(json.dumps({
        cfg.label(): {"status": "ok", "ms_per_step": 0.5,
                      "config": asdict(cfg)}}))
    tuned_mod.reconcile_from_ledgers(str(tmp_path / "l"))
    assert tuned_mod.best_config("s") == cfg


# -- the space ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["2d5pt_star", "2d25pt_box", "3d7pt_star",
                                  "3d27pt_box"])
def test_space_sweeps_the_tile_of_fp32_streams_only(name):
    spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
    cands = list(space.default_space(spec))
    labels = [c.cfg.label() for c in cands]
    assert len(labels) == len(set(labels))
    by_kernel = {}
    for c in cands:
        if c.cfg.tm is not None or c.cfg.ch is not None:
            assert (c.cfg.variant, c.cfg.dtype) == ("stream", "float32")
            assert (c.cfg.tm is None) != (c.cfg.ch is None)
        if c.cfg.variant == "stream":
            g = kernels.geometry(plan_for(spec, c.cfg), spec.dims)
            assert c.tile == g.tile and c.smem_bytes == g.smem_bytes
            key = (c.cfg.replace(tm=None, ch=None).label(), g)
            # no kernel measured twice under two labels
            assert key not in by_kernel, (c.cfg.label(), by_kernel.get(key))
            by_kernel[key] = c.cfg.label()
    defaults = [c for c in cands if c.cfg.variant == "stream"
                and c.cfg.dtype == "float32" and c.cfg.tm is None
                and c.cfg.ch is None]
    for d in defaults:
        mine = [c for c in cands if c.cfg.replace(tm=None, ch=None) == d.cfg
                and c is not d]
        assert 1 <= len(mine) <= 2 + space.NARROWER[spec.ndim]
        # the default's segment halved / doubled, the next narrower column
        for c in mine:
            if c.cfg.ch is not None:
                assert c.tile[-1] < d.tile[-1] or c.tile[1:] < d.tile[1:]


# -- the CLI ------------------------------------------------------------------

def test_cli_bx_and_ch_reach_the_emitted_text(tmp_path):
    stc = os.path.join(BENCH_DIR, "2d5pt_star.stc")
    out = tmp_path / "o.py"
    assert cli_mod.main([stc, "--step", "2", "--trapezoid", "--bx", "300",
                         "--ch", "248", "-o", str(out)]) == 0
    text = out.read_text(encoding="utf-8")
    assert "constexpr int SEG = 300, TX = 248;" in text
    assert "config=stream_fu2_tm300_ch248_trap" in text
    assert cli_mod.main([stc, "--step", "2", "--trapezoid", "-o",
                         str(out)]) == 0
    assert "constexpr int SEG = 300" not in out.read_text(encoding="utf-8")
    r = subprocess.run([sys.executable, "-m", "drstencil_tpu_torch.cli", stc,
                        "--ch", "7", "-o", str(tmp_path / "bad.py")],
                       capture_output=True, text=True,
                       cwd=os.path.dirname(HERE))
    assert r.returncode == 1 and "names no strip" in r.stderr
    assert not (tmp_path / "bad.py").exists()


def test_report_sets_each_tile_against_its_default(tmp_path, monkeypatch):
    """``tune.report`` tables each tile candidate's sweep time over its
    default tile's: by the segment's side of the default and for the
    narrower columns; the finalists' medians do not enter it."""
    from drstencil_tpu_torch.tune import report

    base = KernelConfig(step=6, trapezoid=True, block=2, lane_mode="roll")
    spec = bench_spec(WINDOWED_2D[0])
    seg = space.smem_estimate(spec, base).tile[0]

    def ok(cfg, ms, **kw):
        return cfg.label(), dict(status="ok", ms_per_step=ms,
                                 config=asdict(cfg), **kw)

    ledger = dict([
        ok(base, 1.0, ms_per_step_sweep=2.0),       # a finalist's median
        ok(base.replace(tm=seg // 2), 1.9),
        ok(base.replace(tm=seg * 2), 3.0),
        ok(base.replace(ch=240), 1.8),
        ok(base.replace(ch=112), 2.2),
        ok(KernelConfig(step=2, tm=50), 1.0),       # no default measured
    ])
    (tmp_path / "2d5pt_star.ledger.json").write_text(json.dumps(ledger))
    lines = report.tile_table(str(tmp_path), ["2d5pt_star", "2d9pt_star"])
    assert len(lines) == 3
    assert lines[2] == ("| 2d5pt_star | 4 | 2 | -5.0% | +50.0% | +0.0% | "
                        f"{base.replace(ch=240).label()} -10.0% |")
    assert report.tile_table(str(tmp_path), ["2d9pt_star"]) == []
