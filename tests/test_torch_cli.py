"""``python -m drstencil_tpu_torch.cli`` against ``tests/test_cli.py``'s
cases, and its ``--dump-analysis`` JSON against the JAX package's native
analysis (``native_bridge.analyze``) field by field."""

import json
import os
import subprocess
import sys

import pytest

from drstencil_tpu import native_bridge

from conftest import BENCH_DIR

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
STENCILS = [
    "2d13pt_star", "2d25pt_box", "2d5pt_cross", "2d5pt_star", "2d9pt_box",
    "2d9pt_cross", "2d9pt_star", "3d13pt_star", "3d27pt_box", "3d7pt_star",
    "3d9pt_cross",
]


def run_cli(*args, module="drstencil_tpu_torch.cli"):
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True, text=True, cwd=ROOT,
    )


def stc_path(name):
    return os.path.join(BENCH_DIR, name + ".stc")


def test_cli_dump_analysis():
    r = run_cli(stc_path("2d5pt_star"), "--step", "2", "--dump-analysis")
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert out["order"] == 2 and out["distance"] == 2


def test_cli_emit(tmp_path):
    out_py = str(tmp_path / "o.py")
    r = run_cli(stc_path("2d9pt_box"), "-o", out_py, "--bx", "64", "--check")
    assert r.returncode == 0, r.stderr
    text = open(out_py, encoding="utf-8").read()
    assert "__global__" in text and "CUDA_SOURCE" in text
    assert "golden_apply" in text
    # the command line is recorded in the header
    assert "--bx 64 --check" in text.split("import argparse")[0]


def test_cli_error_path(tmp_path):
    bad = tmp_path / "bad.stc"
    bad.write_text("M 8 N 8 iteratioins 1 stencil 0 0 1.0")
    r = run_cli(str(bad))
    assert r.returncode == 1
    assert "iteratioins" in r.stderr


def test_package_main_is_the_cli():
    r = run_cli(stc_path("2d5pt_star"), "--dump-analysis",
                module="drstencil_tpu_torch")
    assert r.returncode == 0 and json.loads(r.stdout)["order"] == 1


@pytest.mark.parametrize("args,message", [
    (("--vfuse",), "--vfuse requires --trapezoid with --step > 1"),
    (("--step", "4", "--trapezoid", "--block", "3"),
     "--block requires step % block == 0 and block < step"),
    (("--shard", "3"), "leading dim not divisible by shards"),
])
def test_cli_rejections_exit_1(tmp_path, args, message):
    r = run_cli(stc_path("2d5pt_star"), "-o", str(tmp_path / "o.py"), *args)
    assert r.returncode == 1 and message in r.stderr
    assert not (tmp_path / "o.py").exists()


@pytest.mark.parametrize("flags", [
    ("--step", "4", "--trapezoid", "--vfuse", "--lane-mode", "roll",
     "--bx", "128"),
    ("--step", "3", "--trapezoid", "--jfix", "kernel", "--bx", "4624",
     "--prefetch", "1", "--ch", "8"),
    ("--step", "2", "--dtype", "bfloat16", "--shard", "4", "--check"),
    ("--gold",),
], ids=["2d_winner_flags", "3d_winner_flags", "bf16_shard", "gold"])
def test_cli_takes_the_jax_cli_flags(tmp_path, flags):
    """Every flag of ``drstencil_tpu/cli.py`` is accepted; the TPU-only
    ones land in the header."""
    name = "3d7pt_star" if "--jfix" in flags else "2d5pt_star"
    out_py = tmp_path / "o.py"
    r = run_cli(stc_path(name), "-o", str(out_py), *flags)
    assert r.returncode == 0, r.stderr
    text = out_py.read_text(encoding="utf-8")
    compile(text, "o.py", "exec")
    assert " ".join(flags) in text.split("import argparse")[0]


@pytest.mark.parametrize("name", STENCILS)
@pytest.mark.parametrize("step", [1, 2, 3])
def test_dump_analysis_matches_native(name, step):
    with open(stc_path(name)) as f:
        stc = f.read()
    try:
        nat, nat_err = native_bridge.analyze(stc, name, step=step), None
    except native_bridge.NativeError as e:
        nat, nat_err = None, str(e)
    r = run_cli(stc_path(name), "--step", str(step), "--dump-analysis")
    if nat_err is not None:
        assert "No data to reuse" in nat_err
        assert r.returncode == 1 and r.stdout == ""
        assert r.stderr.strip() == nat_err
        return
    assert r.returncode == 0, r.stderr
    port = json.loads(r.stdout)
    assert list(port) == list(nat)          # the same keys, in order
    for key in ("order", "distance", "window", "low", "high"):
        assert port[key] == nat[key]
    # offsets in the same sorted order, fused values bit-exact
    assert [k for k, _ in port["fused"]] == [k for k, _ in nat["fused"]]
    assert [v for _, v in port["fused"]] == [v for _, v in nat["fused"]]
    assert port["forward"] == nat["forward"]
    assert port["backward"] == nat["backward"]
