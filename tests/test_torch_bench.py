"""The port's bench (``drstencil_tpu_torch/bench.py``) against the hardening
contract of the JAX bench (``tests/test_bench.py``, test for test): a card
that is missing or broken reads as an ENVIRONMENT error, never as a perf
score, and a fault of a kernel is never hidden behind that marker."""

import json
import os
import subprocess
import sys

import pytest

from drstencil_tpu_torch import bench

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

ENV_MESSAGES = [
    "CUDA is not available; pass device='cpu' to run the plain PyTorch "
    "versions of the kernels",
    "CUDA error: no CUDA-capable device is detected",
    "CUDA driver initialization failed, you might not have a CUDA gpu.",
    "CUDA error: all CUDA-capable devices are busy or unavailable",
    "cudaErrorDevicesUnavailable",
    "CUDA error: uncorrectable ECC error encountered",
    "nvcc not found: put it on PATH or set CUDA_HOME",
    "no published peaks recorded for 'NVIDIA A100-SXM4-80GB'",
]
CONFIG_MESSAGES = [
    "CUDA error: an illegal memory access was encountered",
    "plan kernel launch failed: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "plan kernel launch failed: misaligned address",
    "CUDA out of memory. Tried to allocate 1.00 GiB",
    "nvcc failed (1) on build/plans/plan_ab.cu:\nptxas error : Entry "
    "function uses too much shared data",
    "device_check 0.5 exceeds 0.001",
    # a fault of the program stays one even where the message also names
    # an environment signature
    "CUDA error: an illegal memory access was encountered (the device is "
    "busy or unavailable afterwards)",
    # the JAX bench's own config examples
    "tm=96 does not divide padded rows",
    "block=2 requires step % block == 0 and block < step",
]


@pytest.mark.parametrize("msg", ENV_MESSAGES)
def test_env_error_classifier_environment(msg):
    assert bench.is_env_error(msg)


@pytest.mark.parametrize("msg", CONFIG_MESSAGES)
def test_env_error_classifier_config(msg):
    assert not bench.is_env_error(msg)


def test_assemble_separates_env_from_config_errors():
    detail = {
        "2d5pt_star": {"cfg": "a", "roofline_frac": 1.0},
        "2d9pt_star": {"cfg": "b", "error": "illegal memory access"},
        "3d7pt_star": {"cfg": "c", "env_error": "CUDA is not available"},
    }
    out = bench._assemble(detail)
    # geomean over {1.0, 1e-6} only — the env-failed stencil is excluded
    assert out["value"] == round((1.0 * 1e-6) ** 0.5, 4)
    marker = out["detail"]["_environment"]
    assert marker["environment_error"] is True
    assert marker["stencils_env_failed"] == ["3d7pt_star"]


def test_assemble_all_env_failed_scores_zero_with_marker():
    detail = {n: {"env_error": "no CUDA-capable device"} for n in bench.ALL}
    out = bench._assemble(detail)
    assert out["value"] == 0.0
    assert out["detail"]["_environment"]["environment_error"] is True


def test_assemble_clean_run_has_no_marker():
    detail = {n: {"cfg": "x", "roofline_frac": 0.9} for n in bench.ALL}
    out = bench._assemble(detail)
    assert out["value"] == 0.9
    assert "_environment" not in out["detail"]
    assert out["metric"] == ("geomean stencil throughput vs naive HBM "
                             "roofline")


def test_retry_merges_recovered_stencils(monkeypatch, capsys):
    """main() retries only the env-failed stencils and merges the
    recovered rows — a transient failure costs nothing."""
    first = {
        "2d5pt_star": {"cfg": "a", "roofline_frac": 1.0},
        "2d9pt_star": {"cfg": "b", "env_error": "busy or unavailable"},
    }
    second = {"2d9pt_star": {"cfg": "b", "roofline_frac": 1.0}}
    calls = []

    monkeypatch.setattr(bench, "_probe_with_retries", lambda b: (True, "ok"))
    monkeypatch.setattr(
        bench, "_run_suite",
        lambda names, timeout: calls.append(names) or
        (dict(first) if len(calls) == 1 else dict(second)))
    monkeypatch.setenv("BENCH_STENCILS", "2d5pt_star,2d9pt_star")
    bench.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert calls == [["2d5pt_star", "2d9pt_star"], ["2d9pt_star"]]
    assert out["value"] == 1.0
    assert "_environment" not in out["detail"]


def test_persistent_env_failure_keeps_marker(monkeypatch, capsys):
    failing = {"2d5pt_star": {"cfg": "a", "env_error": "no CUDA-capable "
                                                       "device"}}
    monkeypatch.setattr(bench, "_probe_with_retries", lambda b: (True, "ok"))
    monkeypatch.setattr(bench, "_run_suite",
                        lambda names, timeout: dict(failing))
    monkeypatch.setenv("BENCH_STENCILS", "2d5pt_star")
    bench.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["value"] == 0.0
    assert out["detail"]["_environment"]["environment_error"] is True


def test_unit_names_the_card_the_probe_reported(monkeypatch, capsys):
    probe = ('probe: ok {"kind": "NVIDIA H100 80GB HBM3", "card": '
             '"NVIDIA H100 80GB HBM3, 700.00 W", "gbps": 3350.0, '
             '"sol": 418.75}')
    monkeypatch.setattr(bench, "_probe_with_retries",
                        lambda b: (True, probe))
    monkeypatch.setattr(
        bench, "_run_suite",
        lambda names, timeout: {"2d5pt_star": {"cfg": "a",
                                               "roofline_frac": 2.0}})
    monkeypatch.setenv("BENCH_STENCILS", "2d5pt_star")
    bench.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in out["unit"]
    assert "418.75 GStencil/s fp32 @ 3350 GB/s" in out["unit"]
    assert out["value"] == 2.0


class _Proc:
    def __init__(self, stdout="", stderr="", returncode=0):
        self.stdout, self.stderr, self.returncode = stdout, stderr, returncode


def test_sticky_error_stays_with_its_stencil(monkeypatch):
    """One subprocess per stencil: an illegal address in the first
    stencil's process is that stencil's error row (scored 1e-6), and the
    next stencil's fresh process still scores."""
    seen = []

    def child(flag, names, timeout):
        seen.append((flag, names))
        if flag == "--build":
            return _Proc("build: 2 plans built or found in 1.0 s\n")
        name = names[0]
        if name == "2d5pt_star":
            row = {"cfg": "a", "error": "CUDA error: an illegal memory "
                                        "access was encountered"}
        else:
            row = {"cfg": "b", "roofline_frac": 1.5}
        return _Proc(json.dumps(bench._assemble({name: row})) + "\n")

    monkeypatch.setattr(bench, "_run_child", child)
    detail = bench._run_suite(["2d5pt_star", "2d9pt_star"], 600)
    assert seen == [("--build", ["2d5pt_star", "2d9pt_star"]),
                    ("--suite", ["2d5pt_star"]), ("--suite", ["2d9pt_star"])]
    assert "illegal memory access" in detail["2d5pt_star"]["error"]
    assert detail["2d9pt_star"]["roofline_frac"] == 1.5
    out = bench._assemble(detail)
    assert out["value"] == round((1e-6 * 1.5) ** 0.5, 4)
    assert "_environment" not in out["detail"]


def test_crashed_stencil_is_classified_by_its_output(monkeypatch):
    """A process that died before its JSON line is the config's fault
    unless its output names the environment.  A build that hangs past the
    budget is every stencil's fault (the plans' own text); a budget spent,
    after a build that finished, before a stencil ran is the environment's
    (retried)."""
    def child(flag, names, timeout):
        if flag == "--build":
            return _Proc()
        if names[0] == "2d5pt_star":
            return _Proc(stderr="Segmentation fault", returncode=-11)
        return _Proc(stderr="RuntimeError: CUDA error: uncorrectable ECC "
                            "error encountered", returncode=1)

    monkeypatch.setattr(bench, "_run_child", child)
    detail = bench._run_suite(["2d5pt_star", "2d9pt_star"], 600)
    assert "error" in detail["2d5pt_star"]
    assert "env_error" in detail["2d9pt_star"]

    def slow(flag, names, timeout):
        raise subprocess.TimeoutExpired(cmd="bench", timeout=timeout)

    monkeypatch.setattr(bench, "_run_child", slow)
    detail = bench._run_suite(["2d5pt_star", "2d9pt_star"], 5.0)
    assert sorted(detail) == ["2d5pt_star", "2d9pt_star"]
    assert all("ran past" in row["error"] for row in detail.values())
    assert "_environment" not in bench._assemble(detail)["detail"]

    def built(flag, names, timeout):
        if flag == "--build":
            return _Proc("build: 2 plans built or found in 0.0 s\n")
        raise AssertionError("no stencil may run past the budget")

    monkeypatch.setattr(bench, "_run_child", built)
    detail = bench._run_suite(["2d5pt_star", "2d9pt_star"], 0.0)
    assert all("env_error" in row for row in detail.values())


def test_suite_scores_each_stencil_in_process(monkeypatch, capsys):
    """``_suite`` itself: a kernel fault is an ``error`` row, a missing
    card an ``env_error`` row, a failed device_check an ``error`` row, and
    a good stencil its roofline row (the card's time and roofline stubbed
    on the CPU)."""
    from drstencil_tpu_torch.ops import runner
    from drstencil_tpu_torch.tune import tuned as tuned_mod

    faults = {
        "2d5pt_star": RuntimeError("plan kernel launch failed: an illegal "
                                   "memory access was encountered"),
        "2d9pt_star": RuntimeError("CUDA is not available"),
    }
    diffs = {"2d9pt_box": 0.5, "2d5pt_cross": 1e-7}

    class FakeProgram:
        def __init__(self, spec, cfg):
            if spec.name in faults:
                raise faults[spec.name]
            self.name = spec.name
            self.an = type("An", (), {"step": cfg.step})
            self.dtype = runner.torch.float32

        def time(self, pairs):
            return runner.RunResult("x", 1e-3, pairs, 3,
                                    gstencil_per_s=837.5,
                                    achieved_gbps=1000.0)

        def device_check(self, pairs=1):
            return diffs[self.name]

    monkeypatch.setattr(runner, "StencilProgram", FakeProgram)
    monkeypatch.setattr(tuned_mod, "naive_sol_gstencil",
                        lambda itemsize=4, device_name=None: 418.75)
    monkeypatch.setenv("BENCH_STENCILS",
                       "2d5pt_star,2d9pt_star,2d9pt_box,2d5pt_cross")
    monkeypatch.setenv("BENCH_CHECK", "1")
    bench._suite()
    detail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "detail"]
    assert "illegal memory access" in detail["2d5pt_star"]["error"]
    assert "CUDA is not available" in detail["2d9pt_star"]["env_error"]
    assert "device_check" in detail["2d9pt_box"]["error"]
    assert detail["2d5pt_cross"]["roofline_frac"] == 2.0
    assert detail["2d5pt_cross"]["max_dev_diff"] == 1e-7


def test_bench_without_cuda_gives_the_marker_end_to_end(tmp_path):
    """No card here: the bench exits 0 with the environment marker and
    value 0.0, not a traceback and never a CPU fallback."""
    env = dict(os.environ)
    env["BENCH_PROBE_BACKOFF"] = "0"
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "drstencil_tpu_torch.bench"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["value"] == 0.0
    assert out["detail"]["_environment"]["environment_error"] is True
    assert "probe" in out["detail"]["_environment"]["note"]
    assert "CUDA is not available" in out["detail"]["_environment"][
        "probe_tail"]


@pytest.mark.parametrize("given,used", [(None, 3), ("1", 1), ("2", 3),
                                        ("4", 5), ("5", 5)])
def test_suite_repeats_forced_odd(monkeypatch, given, used):
    """BENCH_REPEATS even values are bumped to odd — median-of-odd only."""
    if given is None:
        monkeypatch.delenv("BENCH_REPEATS", raising=False)
    else:
        monkeypatch.setenv("BENCH_REPEATS", given)
    assert bench._repeats() == used


def test_parent_never_imports_torch():
    """The parent process stays off CUDA: importing the bench pulls in no
    torch (the probe, the build and the suite import it in their own
    processes)."""
    code = ("import sys; import drstencil_tpu_torch.bench; "
            "print('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "False", proc.stderr
