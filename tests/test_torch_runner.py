"""The port's run protocol (drstencil_tpu_torch.ops.runner) end to end on
the CPU, against the JAX package's ``StencilProgram`` and the fp64 golden
model, plus the package rules: CUDA by default, and no JAX anywhere.
"""

import ast
import os
from dataclasses import asdict

import numpy as np
import pytest
import torch

from drstencil_tpu.ops.config import KernelConfig as JKernelConfig
from drstencil_tpu.ops.runner import StencilProgram as JProgram
from drstencil_tpu.ops.stream import unpad_state
from drstencil_tpu.tune import tuned as jtuned
from drstencil_tpu_torch import convert
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.tune import tuned

from conftest import small_spec

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
WINNERS = [
    "2d13pt_star", "2d25pt_box", "2d5pt_cross", "2d5pt_star", "2d9pt_box",
    "2d9pt_cross", "2d9pt_star", "3d13pt_star", "3d27pt_box", "3d7pt_star",
    "3d9pt_cross",
]
# fp64-golden tolerances of tests/test_kernels.py (values ~100), scaled
# with max|gold| for the operators that grow the state (2d25pt_box at
# step 6 reaches ~1e6)
MAX_TOL, RMS_TOL = 5e-3, 1e-3


def port_program(name, dims=None):
    jspec = small_spec(name, dims)
    spec = convert.spec_from_fields(jspec.name, jspec.dims, jspec.iterations,
                                    jspec.taps)
    cfg = convert.config_from_dict(asdict(jtuned.best_config(name)))
    return StencilProgram(spec, cfg, device="cpu")


@pytest.mark.parametrize("name", WINNERS)
def test_final_a_matches_jax_program(name):
    """The whole protocol (num_pairs ping-pong pairs from the same numpy
    seed) against the JAX StencilProgram in Pallas interpret mode."""
    jspec = small_spec(name)
    jcfg = jtuned.best_config(name).replace(
        tm=32 if jspec.ndim == 2 else 80, ch=None, interpret=True)
    jp = JProgram(jspec, jcfg)
    want = jp.final_a(jp.run_pairs(jp.init_state(0), jp.num_pairs()))
    prog = port_program(name)
    assert prog.num_pairs() == jp.num_pairs()
    got = prog.final_a(prog.run_pairs(prog.init_state(0), prog.num_pairs()))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-5, f"rel={rel}"


@pytest.mark.parametrize("name", WINNERS)
def test_check_against_fp64_golden(name):
    prog = port_program(name)
    max_err, rms = prog.check(seed=0)
    a = prog.final_a(prog.run_pairs(prog.init_state(0), prog.num_pairs()))
    h = prog.an.halo
    scale = max(1.0, np.abs(a[tuple(slice(h, s - h) for s in a.shape)]).max()
                / 100.0)
    assert max_err < MAX_TOL * scale, f"max_err={max_err} scale={scale}"
    assert rms < RMS_TOL * scale


@pytest.mark.parametrize("name,dims", [
    ("2d5pt_star", None),
    ("3d7pt_star", None),
    # deep: step-1 gold composed 6x, compared past an inset of 36 cells
    ("2d25pt_box", (96, 128)),
])
def test_device_check_on_cpu(name, dims):
    assert port_program(name, dims).device_check(pairs=1) <= 1e-5


def test_state_is_updated_in_place_and_keeps_frames():
    prog = port_program("2d9pt_box")
    state = prog.init_state(1)
    a, b = state["a"], state["b"]
    a0 = a.clone()
    out = prog.run_pairs(state, 2)
    assert out["a"] is a and out["b"] is b
    h = prog.an.halo
    frame = torch.ones(a.shape, dtype=torch.bool)
    frame[h:-h, h:-h] = False
    assert torch.equal(a[frame], a0[frame])
    assert not b[frame].any()
    pa, pb = prog.pair_fn()(a, b)
    assert pa is a and pb is b


def test_init_state_is_golden_random_state():
    prog = port_program("3d27pt_box")
    jspec = small_spec("3d27pt_box")
    jp = JProgram(jspec, jtuned.best_config("3d27pt_box").replace(
        tm=80, interpret=True))
    js = jp.init_state(4)
    ja = np.asarray(unpad_state(js["a"], jp.geom))
    ts = prog.init_state(4)
    assert ts["a"].dtype == torch.float32 and ts["a"].device.type == "cpu"
    np.testing.assert_array_equal(ts["a"].numpy(), ja)
    assert not ts["b"].any()


def test_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = port_program("2d5pt_star").spec
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StencilProgram(spec, KernelConfig(step=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.state_from_numpy(np.zeros(4), np.zeros(4))


def test_time_needs_the_card():
    with pytest.raises(RuntimeError, match="measures the card"):
        port_program("2d5pt_star").time(pairs=1)


def test_xla_variant_and_unknown_variant():
    spec = port_program("2d5pt_cross").spec
    gold = StencilProgram(spec, KernelConfig(variant="xla", step=1),
                          device="cpu")
    assert gold.an.part is None  # cross at step 1: relaxed analysis
    max_err, _ = gold.check()
    assert max_err < MAX_TOL
    with pytest.raises(ValueError, match="xla variant"):
        gold.device_check()
    with pytest.raises(ValueError, match="unknown variant"):
        StencilProgram(spec, KernelConfig(variant="nope", step=2),
                       device="cpu")


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 100, (6, 7, 8)).astype(np.float32)
    b = rng.uniform(0, 1, (6, 7, 8)).astype(np.float32)
    state = convert.state_from_numpy(a, b, device="cpu")
    ra, rb = convert.state_to_numpy(state)
    np.testing.assert_array_equal(ra, a)
    np.testing.assert_array_equal(rb, b)
    state["a"].add_(1.0)  # the copies do not alias the state
    np.testing.assert_array_equal(ra, a)


@pytest.mark.parametrize("name", WINNERS)
def test_configs_and_specs_carry_across(name, monkeypatch, tmp_path):
    # the fallback: without the port's table, best_config is the JAX one's
    monkeypatch.setattr(tuned, "TUNED_GPU_PATH",
                        str(tmp_path / "tuned_gpu.json"))
    # every field crosses but the TPU tile sizes tm and ch, which are not
    # the Hopper segment and column
    jcfg = jtuned.best_config(name)
    cfg = convert.config_from_dict(asdict(jcfg))
    assert cfg == tuned.best_config(name)
    assert cfg.tm is None and cfg.ch is None
    assert asdict(cfg) == asdict(jcfg.replace(tm=None, ch=None))
    assert cfg.label() == jcfg.replace(tm=None, ch=None).label()
    jspec = small_spec(name)
    spec = convert.spec_from_fields(jspec.name, jspec.dims, jspec.iterations,
                                    jspec.taps)
    assert spec.to_stc() == jspec.to_stc()


@pytest.mark.parametrize("name", WINNERS)
def test_hopper_winner_carries_across(name):
    """With the port's committed table, ``best_config`` is its entry, and
    that config is one the JAX package's ``KernelConfig`` reads back field
    for field and label for label."""
    entry = tuned.tuned_entries(tuned.TUNED_GPU_PATH)[name]
    cfg = tuned.best_config(name)
    assert asdict(cfg) == entry["config"]
    jcfg = JKernelConfig.from_dict(entry["config"])
    assert asdict(jcfg) == asdict(cfg)
    assert jcfg.label() == cfg.label()
    assert convert.config_from_dict(asdict(jcfg)) == cfg.replace(tm=None,
                                                                 ch=None)


def test_roofline_denominator_is_the_cards():
    assert tuned.hbm_peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert tuned.naive_sol_gstencil(4, "NVIDIA H100 80GB HBM3") == 3350.0 / 8
    assert tuned.hbm_peak_gbps("NVIDIA H100 PCIe") == 2000.0
    assert tuned.card_peaks("NVIDIA H200")[0] == 4800.0
    with pytest.raises(ValueError, match="no published peaks"):
        tuned.naive_sol_gstencil(4, "TPU v5 lite")


def _py_files():
    pkg = os.path.join(ROOT, "drstencil_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = list(_py_files())
    rel = {os.path.relpath(p, ROOT) for p in files}
    # the autotuner path and the profiling module are covered too
    assert {f"drstencil_tpu_torch/tune/{m}.py" for m in (
        "space", "tuner", "worker", "session", "finalists", "report")} <= rel
    assert "drstencil_tpu_torch/utils/profiling.py" in rel
    # ... and factor mode, the multi-device path and the entry points
    assert {"drstencil_tpu_torch/ir/factor.py",
            "drstencil_tpu_torch/entry.py"} <= rel
    assert {f"drstencil_tpu_torch/parallel/{m}.py" for m in (
        "__init__", "halo", "stream_shard", "model")} <= rel
    # ... and the compiler front door and the kernel experiments
    assert {"drstencil_tpu_torch/emit.py", "drstencil_tpu_torch/cli.py",
            "drstencil_tpu_torch/__main__.py",
            "drstencil_tpu_torch/tuning/exp_tile2d.py",
            "drstencil_tpu_torch/tuning/exp_overlap.py",
            "drstencil_tpu_torch/ops/codegen.py",
            "drstencil_tpu_torch/utils/kernel_times.py"} <= rel
    # ... and the measurement entry points
    assert {"drstencil_tpu_torch/bench.py",
            "drstencil_tpu_torch/utils/trace_summary.py",
            "drstencil_tpu_torch/tuning/capture_trace.py"} <= rel
    assert len(files) >= 35
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "drstencil_tpu"), (
                f"{os.path.relpath(path, ROOT)} imports {mod}")
