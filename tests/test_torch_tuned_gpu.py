"""The port's committed winners table (``drstencil_tpu_torch/tune/tuned_gpu.json``)
— the counterpart of ``tests/test_docs_consistency.py``'s winner checks: every
entry constructs, is a member of the space the tuner sweeps, was measured on
the card by the finalists pass, and is what ``best_config`` hands out; the
JAX package's table stays as it was."""

import csv
import hashlib
import json
import os

import pytest

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.ops.stream import level_plan
from drstencil_tpu_torch.tune import tuned
from drstencil_tpu_torch.tune.space import default_space, representative

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
LEDGERS = os.path.join(REPO, "drstencil_tpu_torch", "tuning", "ledgers")
NAMES = sorted(tuned.tuned_entries(tuned.TUNED_PATH))
# benchmarks/tuned.json as the JAX package committed it
TUNED_JSON_SHA256 = (
    "c01a9b7d4203d57f37b28c1a7647c09d01421de0281371f48858d47c5c91a877")
FINALISTS_PROTOCOL = "median-of-3"


def table():
    with open(tuned.TUNED_GPU_PATH) as f:
        return json.load(f)


def spec_of(name):
    return load_stc(os.path.join(tuned.BENCH_DIR, name + ".stc"))


def test_table_covers_every_tpu_winner():
    assert tuned.TUNED_GPU_PATH == os.path.join(
        REPO, "drstencil_tpu_torch", "tune", "tuned_gpu.json")
    assert sorted(table()) == NAMES
    assert len(NAMES) == 11


@pytest.mark.parametrize("name", NAMES)
def test_winner_constructs(name):
    spec = spec_of(name)
    cfg = KernelConfig.from_dict(table()[name]["config"])
    an = analyze(spec, step=cfg.step, distance=cfg.distance,
                 merge_forward=cfg.merge_forward)
    assert level_plan(an, cfg) is not None
    prog = StencilProgram(spec, cfg, device="cpu")
    assert prog.pair_fn() is not None


@pytest.mark.parametrize("name", NAMES)
def test_winner_in_space(name):
    """A winner is a sweep candidate: its own Hopper representative, and a
    member of ``default_space`` — a gate that later orphans it fails
    here, not at the next session."""
    spec = spec_of(name)
    cfg = KernelConfig.from_dict(table()[name]["config"])
    assert representative(cfg, spec.ndim) == cfg
    assert any(c.cfg == cfg for c in default_space(spec)), cfg.label()


@pytest.mark.parametrize("name", NAMES)
def test_score_names_the_card_and_the_finalists_median(name):
    """The score was measured on the card, at the ``.stc`` size, by the
    finalists pass, and the committed ledger carries the same median."""
    entry = table()[name]
    score = entry["score"]
    assert "H100" in score["device"]
    assert tuned.card_peaks(score["device"])
    assert score["protocol"] == FINALISTS_PROTOCOL
    assert score["dims"] == list(spec_of(name).dims)
    assert 0.0 < score["ms_per_step"] < 10.0
    with open(os.path.join(LEDGERS, name + ".ledger.json")) as f:
        ledger = json.load(f)
    row = ledger[KernelConfig.from_dict(entry["config"]).label()]
    assert row["status"] == "ok"
    assert row["protocol"] == FINALISTS_PROTOCOL
    assert row["ms_per_step"] == score["ms_per_step"]
    assert row["max_dev_diff"] <= {"float32": 1e-3, "bfloat16": 1e-2}[
        entry["config"]["dtype"]]


@pytest.mark.parametrize("name", NAMES)
def test_best_config_returns_the_winner(name):
    assert tuned.best_config(name) == KernelConfig.from_dict(
        table()[name]["config"])


def test_sweep_measured_every_candidate():
    """The committed ledgers hold every candidate of each stencil's space,
    measured ok, and ``gpuMetrics.csv`` one row per measured config."""
    with open(os.path.join(LEDGERS, "gpuMetrics.csv"), newline="") as f:
        metrics = list(csv.DictReader(f))
    for name in NAMES:
        with open(os.path.join(LEDGERS, name + ".ledger.json")) as f:
            ledger = json.load(f)
        labels = {c.cfg.label() for c in default_space(spec_of(name))}
        assert labels <= set(ledger), sorted(labels - set(ledger))
        ok = {k for k, e in ledger.items() if e.get("status") == "ok"}
        assert ok == set(ledger), sorted(set(ledger) - ok)
        assert {r["config"] for r in metrics
                if r["stencil"] == name} == ok


def test_tpu_table_unchanged():
    with open(tuned.TUNED_PATH, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == TUNED_JSON_SHA256
