"""The port's autotuner path (space, tuner, worker, session, finalists,
report, tuned table) on the CPU, mirroring ``tests/test_tune.py``.

``time()`` needs the card, so sweeps here replace it with a stub that
returns a fixed time per config label (``fake_time``), and name the card
an H100; ``device_check`` runs for real on the kernels' plain versions.
"""

import csv
import hashlib
import json
import os
import sys
import textwrap
from dataclasses import asdict

import numpy as np
import pytest
import torch

from drstencil_tpu.ir.spec import load_stc as jload_stc
from drstencil_tpu.tune.space import default_space as jdefault_space
from drstencil_tpu_torch import convert
from drstencil_tpu_torch.ir.spec import load_stc, parse_stc
from drstencil_tpu_torch.ops import runner as runner_mod
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.kernels import SMEM_LIMIT
from drstencil_tpu_torch.tune import finalists, report, session, space
from drstencil_tpu_torch.tune import tuned as tuned_mod
from drstencil_tpu_torch.tune import tuner as tuner_mod
from drstencil_tpu_torch.tune.tuner import Tuner
from drstencil_tpu_torch.utils.profiling import maybe_trace

from conftest import BENCH_DIR, small_spec

H100 = "NVIDIA H100 80GB HBM3"
TINY = "M 32\nN 256\niterations 4\nstencil\n0 0 0.5\n1 0 0.25\n-1 0 0.25\n"


def port_spec(name, dims=None):
    jspec = small_spec(name, dims)
    return convert.spec_from_fields(jspec.name, jspec.dims, jspec.iterations,
                                    jspec.taps)


def fake_time(self, warmup_pairs=3, pairs=None, seed=0, repeats=3):
    """A deterministic per-label time in place of the card's: bf16 configs
    read 0.6x their fp32 twin, deeper steps a little faster."""
    label = self.cfg.replace(dtype="float32").label()
    ms = 1.0 + int(hashlib.sha256(label.encode()).hexdigest()[:4], 16) / 65536
    ms /= 1.0 + 0.1 * self.an.step
    if self.cfg.dtype == "bfloat16":
        ms *= 0.6
    cells = float(np.prod(self.spec.dims))
    sec = ms * 1e-3
    return runner_mod.RunResult(
        label=f"{self.spec.name}:{self.cfg.label()}", seconds_per_pair=sec,
        pairs=repeats * (pairs or 8), warmup_pairs=warmup_pairs,
        gstencil_per_s=cells * 2 * self.an.step / sec / 1e9,
        achieved_gbps=4 * cells * self.dtype.itemsize / sec / 1e9)


@pytest.fixture
def on_fake_card(monkeypatch, tmp_path):
    """CPU measurements with the stub time, an H100's name, and the port's
    winners table in tmp_path."""
    monkeypatch.setattr(runner_mod.StencilProgram, "time", fake_time)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100)
    monkeypatch.setattr(tuned_mod, "TUNED_GPU_PATH",
                        str(tmp_path / "tuned_gpu.json"))
    return tmp_path


def sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# -- search space -------------------------------------------------------------

def project(cfg):
    """A config on the axes that change the Hopper kernel."""
    return (cfg.variant, cfg.step, cfg.distance, cfg.trapezoid, cfg.block,
            cfg.dtype)


# Where the port's space differs from the JAX space projected onto those
# axes, at the .stc size.  Every difference is a 3D trapezoid at a deep
# step: the JAX VMEM model (124 MB budget) rejects every tm of its tall
# layout there (the fused row halo grows with step x M), while the Hopper
# CTA tile shrinks until its haloed buffers fit 227 KB of shared memory.
# bf16 halves the JAX VMEM bytes, so at step 6 only the fp32 twin is lost.
PORT_ONLY = {
    "3d7pt_star": {("stream", 6, 0, True, 1, "float32"),
                   ("stream", 8, 0, True, 1, "float32"),
                   ("stream", 8, 0, True, 1, "bfloat16")},
    "3d9pt_cross": {("stream", 6, 0, True, 1, "float32"),
                    ("stream", 8, 0, True, 1, "float32"),
                    ("stream", 8, 0, True, 1, "bfloat16")},
}


@pytest.mark.parametrize("name", ["2d5pt_star", "2d9pt_cross", "2d25pt_box",
                                  "3d7pt_star", "3d9pt_cross"])
def test_space_is_the_jax_space_projected(name):
    path = os.path.join(BENCH_DIR, name + ".stc")
    jax_proj = {project(c.cfg) for c in jdefault_space(jload_stc(path))}
    # the candidates at the generator's tile (the tile axes mean other
    # things in the two spaces: tests/test_torch_geometry.py)
    port = [project(c.cfg) for c in space.default_space(load_stc(path))
            if c.cfg.tm is None and c.cfg.ch is None]
    assert len(port) == len(set(port))
    assert set(port) - jax_proj == PORT_ONLY.get(name, set())
    assert jax_proj <= set(port)


WINNERS = sorted(tuned_mod.tuned_entries())


@pytest.mark.parametrize("name", WINNERS)
def test_space_labels_unique_and_collapsed(name):
    spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
    cands = list(space.default_space(spec))
    labels = [c.cfg.label() for c in cands]
    assert len(set(labels)) == len(labels)
    kinds = {(c.cfg.variant, c.cfg.dtype) for c in cands}
    assert kinds == {("stream", "float32"), ("stream", "bfloat16"),
                     ("xla", "float32")}
    for c in cands:
        if c.cfg.variant == "stream":
            # the TPU-only knobs sit at their one representative
            assert c.cfg == space.representative(c.cfg, spec.ndim)
            assert 0 < c.smem_bytes <= SMEM_LIMIT and len(c.tile) == spec.ndim
        else:
            assert (c.smem_bytes, c.tile) == (0, ())


@pytest.mark.parametrize("name", WINNERS)
def test_tpu_winners_are_in_the_space(name, monkeypatch, tmp_path):
    """Each tuned.json winner's Hopper representative is a candidate, so
    the prior-first rule never has to add it from outside the space.  The
    port's table is pointed at a missing file, so ``best_config`` is the
    fallback to the TPU winners (the card's own winners are checked in
    ``test_torch_tuned_gpu.py``)."""
    monkeypatch.setattr(tuned_mod, "TUNED_GPU_PATH",
                        str(tmp_path / "tuned_gpu.json"))
    spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
    rep = space.representative(tuned_mod.best_config(name), spec.ndim)
    assert rep in [c.cfg for c in space.default_space(spec)]


def test_space_distance_fallback_on_odd_step_diagonal():
    """Pure-diagonal 3D stencils keep odd steps through the largest valid
    distance, as the JAX space does."""
    spec = port_spec("3d9pt_cross")
    cands = list(space.default_space(spec))
    dist = {c.cfg.step: c.cfg.distance for c in cands}
    assert dist[3] == 2 and dist[5] == 4 and dist[2] == 0
    assert 1 not in dist
    # every explicit-distance candidate builds
    for c in cands:
        if c.cfg.distance:
            prog = runner_mod.StencilProgram(spec, c.cfg, device="cpu")
            assert prog.an.distance == c.cfg.distance


def test_smem_estimate_filter():
    spec = load_stc(os.path.join(BENCH_DIR, "3d13pt_star.stc"))
    # frame 24 (radius 2, step 12): even the thinnest column's rings of
    # haloed fp32 planes exceed 227 KB
    assert space.smem_estimate(
        spec, KernelConfig(step=12, trapezoid=True)) is None
    # frame 16 (step 8) still fits, with a column shrunk to do so
    thin = space.smem_estimate(spec, KernelConfig(step=8, trapezoid=True))
    assert thin.smem_bytes <= SMEM_LIMIT and thin.tile[1:] < (32, 64)
    # factor mode is 2D-only: rejected, not raised
    assert space.smem_estimate(
        spec, KernelConfig(step=2, factor=True)) is None
    box = load_stc(os.path.join(BENCH_DIR, "2d25pt_box.stc"))
    # on a 2D radius-2 table it is valid: a 512-wide strip (504 outputs +
    # 2 * 4 halo columns), four levels each keeping a ring of 4 rows, the
    # 9 staging rows of the cp.async ring, and a guard quad at each end
    cand = space.smem_estimate(box, KernelConfig(step=2, factor=True))
    assert cand.tile[1] == 512 - 2 * 4
    assert cand.smem_bytes == 4 * ((4 * 4 + 9) * 512 + 2 * 4)
    # ... and still not swept by the default space
    assert not any(c.cfg.factor for c in space.default_space(box))
    # coefficient fusion at step 6: 625 taps per level > MAX_TAPS
    assert space.smem_estimate(box, KernelConfig(step=6)) is None
    # the deep trapezoid: a 512-wide strip (488 outputs + 2 * 12 halo
    # columns), six levels each keeping a ring of 2 * 2 + 2 rows, and a
    # guard quad at each end
    cand = space.smem_estimate(box, KernelConfig(step=6, trapezoid=True))
    assert cand.tile[1] == 512 - 2 * 12 and cand.tile[0] >= 2 * 12 + 6
    assert cand.smem_bytes == 4 * (6 * 6 * 512 + 2 * 4)
    # no reuse at step 1 for a diagonal stencil
    cross = load_stc(os.path.join(BENCH_DIR, "2d5pt_cross.stc"))
    assert space.smem_estimate(cross, KernelConfig(step=1)) is None


@pytest.mark.parametrize("name,first", [
    ("2d5pt_star", "stream_fu4_trap_roll"),
    ("2d9pt_cross", "stream_fu4_trap_roll"),
    ("3d7pt_star", "stream_fu3_trap"),
    ("3d9pt_cross", "stream_fu3_d2_trap"),
])
def test_prior_first_is_the_collapsed_tpu_prior(name, first, on_fake_card):
    """The TPU-tuned prior (tm, ch, vfuse, lane mode, jfix) is measured
    first, as its Hopper representative."""
    t = Tuner(port_spec(name), str(on_fake_card / "out"), device="cpu")
    cands = t.candidates(max_configs=3)
    assert cands[0].cfg.label() == first
    assert len(cands) == 3


# -- tuner ---------------------------------------------------------------------

def test_sweep_builds_its_kernels_ahead(on_fake_card, monkeypatch):
    """Before a sweep's first config is measured, the per-plan kernels of
    all its stream candidates go to ``kernels.build_plans`` in one call
    (on a card; on the CPU nothing is built), and a failed build is left
    to its config's turn."""
    from drstencil_tpu_torch.ops import kernels
    from drstencil_tpu_torch.tune import tuner as tuner_mod

    calls = []

    def fake_build(requests):
        calls.append(list(requests))
        raise RuntimeError("nvcc failed (1) on plan.cu")

    monkeypatch.setattr(kernels, "build_plans", fake_build)
    spec = port_spec("2d5pt_star", (32, 256))
    t = Tuner(spec, str(on_fake_card / "cpu"), pairs=1, device="cpu")
    cands = t.candidates()
    t.prebuild(cands, log=lambda m: None)
    assert calls == []                      # the CPU runs the plain versions

    monkeypatch.setattr(tuner_mod.stream_mod, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    logged = []
    t.prebuild(cands, log=logged.append)
    (requests,) = calls
    stream = [c for c in cands if c.cfg.variant == "stream"]
    assert len(requests) == len(stream) < len(cands)
    for (plan, dims, dtype, shard), cand in zip(requests, stream):
        assert (tuple(dims), dtype, shard) == (spec.dims, cand.cfg.dtype,
                                               False)
        assert kernels.tile_shape(plan, dims) == cand.tile
    assert any("build failed" in m for m in logged)
    assert any(f"{len(stream)} kernels built or found" in m for m in logged)


def test_sweep_and_resume(on_fake_card):
    out = str(on_fake_card / "out")
    tuned_sha = sha(tuned_mod.TUNED_PATH)
    spec = port_spec("2d5pt_star", (32, 256))
    t = Tuner(spec, out, pairs=1, device="cpu")
    res = t.sweep(max_configs=4, log=lambda *_: None)
    assert res.best_cfg is not None and res.tried == 4 and res.errors == 0
    with open(t.ledger_path) as f:
        ledger = json.load(f)
    assert len(ledger) == 4
    assert all(e["status"] == "ok" and e["device"] == H100
               and e["max_dev_diff"] <= tuner_mod.CHECK_TOL[
                   e["config"]["dtype"]]
               for e in ledger.values() if e["config"]["variant"] != "xla")
    with open(t.metrics_path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 4
    assert {"smem_bytes", "tile", "modeled_gbps"} <= set(rows[0])
    assert os.path.exists(t.duration_path)

    # resume: nothing measured twice.  The first sweep's winner is now the
    # prior, measured first; the short sweep's other places go to configs
    # not measured yet, if the winner displaced one of them
    t2 = Tuner(spec, out, pairs=1, device="cpu")
    fresh = [c.cfg.label() for c in t2.candidates(4)
             if c.cfg.label() not in ledger]
    res2 = t2.sweep(max_configs=4, log=lambda *_: None)
    assert res2.tried == len(fresh) <= 1 and res2.errors == 0
    assert sorted(t2.ledger) == sorted(list(ledger) + fresh)
    assert t2.candidates(1)[0].cfg == res.best_cfg
    scored = min(Tuner._scored(e) for e in t2.ledger.values()
                 if e["status"] == "ok")
    assert res2.best_cfg == scored[2]
    res = res2

    # the winner went to the port's table, never to tuned.json
    best = tuned_mod.tuned_entries(tuned_mod.TUNED_GPU_PATH)[spec.name]
    assert best["config"] == asdict(res.best_cfg)
    assert best["score"]["device"] == H100
    assert sha(tuned_mod.TUNED_PATH) == tuned_sha
    assert tuned_mod.best_config(spec.name) == res.best_cfg


def test_3d_sweep_logs_every_config(on_fake_card):
    spec = port_spec("3d7pt_star", (16, 16, 64))
    t = Tuner(spec, str(on_fake_card), pairs=1, device="cpu")
    # the prior (fu3 trap) is measured first whatever the filter
    res = t.sweep(label_filter="*_fu3*", log=lambda *_: None)
    # fp32 and bf16 streams, with and without trapezoid, plus the xla gold
    assert res.tried == 5 and res.errors == 0
    with open(t.duration_path) as f:
        per_config = [l for l in f if "[" in l]
    assert len(per_config) == 5


def test_error_config_skipped_and_logged(on_fake_card):
    class BoomTuner(Tuner):
        def _measure(self, cand):
            raise RuntimeError("launch failed")

    t = BoomTuner(port_spec("2d5pt_star"), str(on_fake_card), device="cpu")
    res = t.sweep(max_configs=2, log=lambda *_: None)
    assert res.errors == 2 and res.best_cfg is None
    with open(t.ledger_path) as f:
        ledger = json.load(f)
    assert [e["status"] for e in ledger.values()] == ["error", "error"]
    assert not os.path.exists(tuned_mod.TUNED_GPU_PATH)


def test_check_failed_is_not_timed(on_fake_card, monkeypatch):
    monkeypatch.setattr(runner_mod.StencilProgram, "device_check",
                        lambda self, pairs=1: 1.0)
    entry = tuner_mod.measure_config(
        port_spec("2d5pt_star"), KernelConfig(step=2, dtype="bfloat16"),
        device="cpu")
    assert entry["status"] == "check_failed" and "ms_per_step" not in entry


def test_measure_config_needs_the_card():
    with pytest.raises(RuntimeError, match="measures the card"):
        tuner_mod.measure_config(port_spec("2d5pt_star"),
                                 KernelConfig(step=1), device="cpu")


def test_keep_artifacts_waits_for_the_emitter(on_fake_card):
    """The emitter is there, so ``keep_artifacts`` writes one program per
    attempted stream config (and none for the xla gold) before measuring
    it; without it only the winner's is kept, as in the JAX tuner."""
    spec = port_spec("2d5pt_star", (32, 256))
    out = str(on_fake_card / "kept")
    t = Tuner(spec, out, pairs=1, device="cpu", keep_artifacts=True)
    t.sweep(max_configs=5, log=lambda *_: None)
    streams = [k for k, e in t.ledger.items()
               if e["config"]["variant"] == "stream"]
    assert streams
    assert sorted(os.listdir(os.path.join(out, "cu"))) == sorted(
        f"2d5pt_star__{label}.py" for label in streams)

    out = str(on_fake_card / "winner_only")
    t = Tuner(spec, out, pairs=1, device="cpu")
    res = t.sweep(max_configs=5, log=lambda *_: None)
    assert os.listdir(os.path.join(out, "cu")) == [
        f"2d5pt_star__{res.best_cfg.label()}.py"]


@pytest.mark.parametrize("flag", [True, False])
def test_keep_artifacts_flag_reaches_the_tuner(monkeypatch, tmp_path, flag):
    seen = {}

    def fake_sweep(self, max_configs=None, label_filter=None, log=print):
        seen["keep"] = self.keep_artifacts
        return tuner_mod.SweepResult(None, float("inf"), 0, 0)

    monkeypatch.setattr(Tuner, "sweep", fake_sweep)
    tuner_mod.main([os.path.join(BENCH_DIR, "2d5pt_star.stc"), "--out-dir",
                    str(tmp_path)] + (["--keep-artifacts"] if flag else []))
    assert seen["keep"] is flag


def test_artifact_is_the_emitters_program_with_check(tmp_path):
    spec = port_spec("2d5pt_star", (32, 256))
    cfg = KernelConfig(step=4, trapezoid=True, block=2, lane_mode="roll",
                       tm=128, dtype="bfloat16")
    tuner_mod.emit_artifact(spec, cfg, str(tmp_path))
    path = tmp_path / "cu" / f"2d5pt_star__{cfg.label()}.py"
    text = path.read_text(encoding="utf-8")
    assert "CHECK = True" in text and 'DTYPE = "bfloat16"' in text
    assert "levels=2 reach=2" in text and "bx=128" in text
    g = {"__name__": "artifact"}
    exec(compile(text, str(path), "exec"), g)
    assert g["DIMS"] == (32, 256) and g["LEVELS"] == 2


@pytest.mark.parametrize("cfg", [
    KernelConfig(variant="xla", step=2),
    KernelConfig(step=2, factor=True),
], ids=["xla", "factor"])
def test_no_artifact_for_what_has_no_emitter(tmp_path, cfg):
    logged = []
    tuner_mod.emit_artifact(port_spec("2d25pt_box", (32, 256)), cfg,
                            str(tmp_path), logged.append)
    assert not (tmp_path / "cu").exists() and logged == []


def test_artifact_emission_fails_softly(tmp_path):
    logged = []
    cfg = KernelConfig(step=3, trapezoid=True)      # no reuse at distance 3
    tuner_mod.emit_artifact(port_spec("3d9pt_cross"), cfg, str(tmp_path),
                            logged.append)
    assert len(logged) == 1
    assert logged[0].startswith("[3d9pt_cross] artifact emit skipped: "
                                "No data to reuse")


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tuner_mod.measure_config(port_spec("2d5pt_star"),
                                 KernelConfig(step=1))
    t = Tuner(port_spec("2d5pt_star"), str(tmp_path))
    res = t.sweep(max_configs=1, log=lambda *_: None)
    assert res.errors == 1
    assert "CUDA is not available" in next(iter(t.ledger.values()))["error"]


# -- tuned table ---------------------------------------------------------------

def test_record_best_is_monotone_under_the_dtype_objective(on_fake_card):
    fp32 = KernelConfig(variant="stream", step=2, trapezoid=True)
    bf16 = fp32.replace(dtype="bfloat16")
    tuned_mod.record_best("s", fp32, {"ms_per_step": 1.0})
    tuned_mod.record_best("s", fp32, {"ms_per_step": 1.5})
    assert tuned_mod.tuned_entries(tuned_mod.TUNED_GPU_PATH)["s"][
        "score"]["ms_per_step"] == 1.0
    # bf16 at 0.7 ms: faster in raw ms, 1.4 normalised — rejected
    tuned_mod.record_best("s", bf16, {"ms_per_step": 0.7})
    assert tuned_mod.best_config("s").dtype == "float32"
    # bf16 at 0.4 ms: 0.8 normalised — accepted
    tuned_mod.record_best("s", bf16, {"ms_per_step": 0.4})
    assert tuned_mod.best_config("s").dtype == "bfloat16"
    assert tuned_mod.objective_ms(0.4, "bfloat16") == pytest.approx(0.8)


def test_best_config_prefers_the_ports_table(on_fake_card):
    name = "2d5pt_star"
    # the TPU winner, without its TPU tile size (tm=128)
    assert tuned_mod.best_config(name) == KernelConfig.from_dict(
        tuned_mod.tuned_entries()[name]["config"]).replace(tm=None)
    assert tuned_mod.best_config(name).tm is None
    mine = KernelConfig(step=3, trapezoid=True, lane_mode="roll")
    tuned_mod.record_best(name, mine, {"ms_per_step": 0.1})
    assert tuned_mod.best_config(name) == mine
    assert tuned_mod.best_config("not_tuned_anywhere") == KernelConfig()


def test_reconcile_from_ledgers(on_fake_card):
    ledger = {
        "a": {"status": "ok", "ms_per_step": 2.0, "device": H100,
              "config": {"variant": "stream", "step": 1}},
        "b": {"status": "ok", "ms_per_pair": 4.0,  # legacy: 1.0 ms/step
              "config": {"variant": "stream", "step": 2, "trapezoid": True}},
        "c": {"status": "ok", "ms_per_step": 0.6,  # bf16: 1.2 normalised
              "config": {"variant": "stream", "step": 2,
                         "dtype": "bfloat16"}},
        "d": {"status": "error", "config": {"variant": "stream"}},
    }
    (on_fake_card / "t1.ledger.json").write_text(json.dumps(ledger))
    assert tuned_mod.reconcile_from_ledgers(str(on_fake_card)) == {"t1": 1.0}
    cfg = tuned_mod.best_config("t1")
    assert cfg.step == 2 and cfg.trapezoid and cfg.dtype == "float32"
    tuned_mod.record_best("t1", KernelConfig(), {"ms_per_step": 5.0})
    assert tuned_mod.best_config("t1").step == 2


def test_port_never_writes_tuned_json():
    assert os.path.basename(tuned_mod.TUNED_GPU_PATH) == "tuned_gpu.json"
    assert tuned_mod.TUNED_GPU_PATH != tuned_mod.TUNED_PATH
    pkg = os.path.dirname(os.path.dirname(tuned_mod.__file__))
    for d, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(d, fn)) as f:
                    text = f.read()
                assert "TUNED_PATH, \"w\"" not in text
                assert "open(TUNED_PATH" not in text


def test_roofline_peaks():
    assert tuned_mod.naive_sol_gstencil(2, H100) == 3350.0 / 4
    assert tuned_mod.objective_ms(1.0, "float32") == 1.0
    with pytest.raises(ValueError, match="dtype 'float16'"):
        tuned_mod.objective_ms(1.0, "float16")


# -- finalists -----------------------------------------------------------------

def _ledger_file(tmp_path, name, entries):
    path = tmp_path / f"{name}.ledger.json"
    path.write_text(json.dumps(entries))
    return path


def test_finalist_medians_written_back_to_ledger(tmp_path):
    cfg = asdict(KernelConfig(variant="stream", step=2, trapezoid=True))
    path = _ledger_file(tmp_path, "fake", {
        "lucky": {"status": "ok", "ms_per_step": 0.51, "config": cfg},
        "honest": {"status": "ok", "ms_per_step": 0.66,
                   "config": dict(cfg, step=4)},
        "broken": "not a dict",
    })
    finalists.writeback_medians(str(path), {"lucky": 0.73}, reps=3)
    led = json.loads(path.read_text())
    assert led["lucky"]["ms_per_step"] == 0.73
    assert led["lucky"]["ms_per_step_sweep"] == 0.51
    assert led["lucky"]["protocol"] == "median-of-3"
    assert led["honest"]["ms_per_step"] == 0.66
    assert finalists.top_configs([str(path)], 2)[0][1] == "honest"
    finalists.writeback_medians(str(path), {"lucky": 0.74}, reps=3)
    assert json.loads(path.read_text())["lucky"]["ms_per_step_sweep"] == 0.51


def test_shortlist_ranks_by_sol_objective(tmp_path):
    fp32 = asdict(KernelConfig(variant="stream", step=2, trapezoid=True))
    path = _ledger_file(tmp_path, "fake", {
        "fp32_cfg": {"status": "ok", "ms_per_step": 0.84, "config": fp32},
        "bf16_cfg": {"status": "ok", "ms_per_step": 0.80,
                     "config": dict(fp32, dtype="bfloat16")},
    })
    assert [r[1] for r in finalists.top_configs([str(path)], 2)] == [
        "fp32_cfg", "bf16_cfg"]


def test_finalists_write_the_ports_table(on_fake_card, capsys):
    tuned_sha = sha(tuned_mod.TUNED_PATH)
    out = on_fake_card / "out"
    out.mkdir()
    base = KernelConfig(variant="stream", trapezoid=True, lane_mode="roll")
    _ledger_file(out, "2d5pt_star", {
        c.label(): {"status": "ok", "ms_per_step": 1.0, "config": asdict(c)}
        for c in (base.replace(step=2), base.replace(step=4))})
    results = finalists.main(["--out-dir", str(out), "--top", "2",
                              "--reps", "2", "--pairs", "1"], device="cpu")
    assert set(results) == {"2d5pt_star"}
    table = tuned_mod.tuned_entries(tuned_mod.TUNED_GPU_PATH)
    assert table["2d5pt_star"]["score"]["protocol"] == "median-of-2"
    assert table["2d5pt_star"]["score"]["device"] == H100
    led = json.loads((out / "2d5pt_star.ledger.json").read_text())
    assert all(e["protocol"] == "median-of-2" for e in led.values())
    assert sha(tuned_mod.TUNED_PATH) == tuned_sha
    # the winner's program is kept in step with the table
    winner = KernelConfig.from_dict(table["2d5pt_star"]["config"])
    assert os.listdir(out / "cu") == [f"2d5pt_star__{winner.label()}.py"]
    text = (out / "cu" / f"2d5pt_star__{winner.label()}.py").read_text(
        encoding="utf-8")
    assert "DIMS = (8192, 8192, )" in text and "CHECK = True" in text


# -- session and report --------------------------------------------------------

def test_aggregate_metrics_mixed_headers(tmp_path):
    (tmp_path / "metrics.csv").write_text(
        "stencil,config,ms_per_step\n"
        "a,cfg1,1.5\n"
        "stencil,config,ms_per_step,smem_bytes\n"
        "a,cfg2,1.2,46080\n")
    dest = session.aggregate_metrics(str(tmp_path))
    with open(dest) as f:
        rows = list(csv.DictReader(f))
    assert [r["smem_bytes"] for r in rows] == ["", "46080"]


def test_session_sweeps_traces_and_aggregates(on_fake_card, monkeypatch):
    bench = on_fake_card / "bench"
    bench.mkdir()
    (bench / "t1.stc").write_text(TINY)
    out = on_fake_card / "out"
    res = session.run_session(str(bench), str(out), max_configs=2,
                              stencils=["t1"], log=lambda *_: None,
                              trace=True, device="cpu")
    assert res["t1"].best_cfg is not None and res["t1"].errors == 0
    assert (out / "tuning-time.log").exists()
    with open(out / "gpuMetrics.csv") as f:
        assert len(list(csv.DictReader(f))) == 2
    # the once-per-session trace, through torch.profiler (CPU activity)
    assert (out / "trace" / "trace.json").exists()
    assert (out / "trace" / "kernels.txt").exists()


def test_maybe_trace_is_soft(tmp_path, monkeypatch):
    with maybe_trace(None) as active:
        assert active is False
    import torch.profiler

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with maybe_trace(str(tmp_path / "tr")) as active:
        assert active is False
    assert "no profiler here" in (tmp_path / "tr" / "trace_error.txt"
                                  ).read_text()


def test_report_render(on_fake_card):
    cfg = KernelConfig(variant="stream", step=4, trapezoid=True,
                       lane_mode="roll", dtype="bfloat16")
    tuned_mod.record_best("2d5pt_star", cfg, {"ms_per_step": 0.2,
                                              "device": H100})
    out = on_fake_card / "out"
    out.mkdir()
    _ledger_file(out, "2d5pt_star", {
        "x": {"status": "ok"}, "y": {"status": "error"}})
    text = report.render(str(out))
    # 8192² cells / 0.2 ms = 335.5 GStencil/s over the bf16 SoL 837.5
    assert "| 2d5pt_star | stream_fu4_trap_roll_bfloat16 |" in text
    assert "| 335.5 | 0.40 | 1/1 |" in text
    assert "geomean vs naive roofline: **0.401** over 1 stencils" in text


# -- isolated worker -----------------------------------------------------------

STUB = textwrap.dedent('''
    """Test stub loaded by the isolated worker: the card's time and name."""
    import torch
    from drstencil_tpu_torch.ops import runner
    from tests_fake_card import fake_time
    runner.StencilProgram.time = fake_time
    torch.cuda.get_device_name = lambda *a: "{h100}"
''')


def test_isolated_worker_marker_line(tmp_path, monkeypatch):
    """A config measured in its own worker process comes back through the
    marker line as the in-process measurement would."""
    import inspect

    (tmp_path / "tests_fake_card.py").write_text(
        "import hashlib\nimport numpy as np\n"
        "from drstencil_tpu_torch.ops import runner as runner_mod\n\n"
        + inspect.getsource(fake_time))
    (tmp_path / "sitecustomize.py").write_text(STUB.format(h100=H100))
    monkeypatch.setenv("PYTHONPATH", str(tmp_path) + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    spec = parse_stc(TINY, "tiny")
    t = Tuner(spec, str(tmp_path / "out"), pairs=1, isolate=True,
              config_timeout_s=300.0, device="cpu")
    cand = space.smem_estimate(spec, KernelConfig(step=2, trapezoid=True,
                                                  lane_mode="roll"))
    entry = t._measure_isolated(cand)
    assert entry["status"] == "ok" and entry["device"] == H100
    assert entry["config"] == asdict(cand.cfg)
    assert entry["max_dev_diff"] <= tuner_mod.CHECK_TOL["float32"]
    assert entry["ms_per_step"] > 0


def test_isolated_hang_is_killed_and_sweep_continues(tmp_path, monkeypatch):
    monkeypatch.setattr(tuned_mod, "TUNED_GPU_PATH",
                        str(tmp_path / "tuned_gpu.json"))
    monkeypatch.setenv("DRSTENCIL_TEST_HANG", "600")
    t = Tuner(parse_stc(TINY, "tiny"), str(tmp_path), isolate=True,
              config_timeout_s=3.0, device="cpu")
    res = t.sweep(max_configs=2, log=lambda *_: None)
    assert res.errors == 2 and res.tried == 2
    for e in t.ledger.values():
        assert e["status"] == "error" and "isolated worker" in e["error"]


def test_worker_reports_failures(tmp_path):
    """A worker that dies without a marker line is an error with its
    output, never a result."""
    import subprocess

    proc = subprocess.run(
        [sys.executable, "-m", "drstencil_tpu_torch.tune.worker"],
        input="not json", capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode != 0
    assert tuner_mod.RESULT_MARKER not in proc.stdout
