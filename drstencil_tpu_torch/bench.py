"""Headline benchmark of the port — prints ONE JSON line.

The port of the repository's ``bench.py``: the benchmark stencil suite
(the reference's 8 ``.stc`` configs) with the port's best-known kernel
configs (``tune/tuned.best_config``: the card's winners table, else the
TPU winners), timed on the card with ``StencilProgram.time`` (CUDA
events), and reported as the geometric mean over stencils of

    GStencil/s  /  naive-roofline GStencil/s

where the denominator is the card's own speed of light of an UNFUSED
sweep (``tune/tuned.naive_sol_gstencil``: HBM peak / 8 bytes per
cell-step, 418.75 GStencil/s for fp32 on an H100 SXM; a bf16 winner is
divided by the bf16 figure, twice that).  Temporal fusion can exceed 1.0.

Environment hardening, as in the JAX bench: the parent process never
touches CUDA.  It

  1. probes the card in a SUBPROCESS (a tiny matmul and a scalar fetch,
     the card's name and power limit) with bounded retries/backoff,
  2. builds every winner's kernel in one subprocess (one ``nvcc`` per
     plan, all at once: build seconds are paid once and never timed),
  3. runs ONE subprocess per stencil: a CUDA fault (an illegal address, a
     launch failure) poisons its context, and must stay that stencil's
     error instead of failing every later one,
  4. re-probes and retries ONLY the environment-failed stencils once,
  5. and if the card never answers, emits a JSON whose detail carries an
     unambiguous ``environment_error`` marker (value 0.0).  The suite never
     falls back to the CPU.

Per-stencil errors are classified (:func:`is_env_error`): no card, a
driver that does not initialise, a busy or lost device, an uncorrectable
ECC error, no ``nvcc``, a card without published peaks are environment
errors (excluded from the geomean, retried, marked); anything else — an
illegal address, a launch failure, out of memory, a failed build of a
plan, a build or a stencil that hangs past the budget, a failed
``device_check`` — means the tuned config or its kernel is broken and
scores 1e-6: a kernel fault must still hurt.

    python -m drstencil_tpu_torch.bench

Env knobs (the JAX bench's):
  BENCH_STENCILS=name1,name2   subset (default: all 8)
  BENCH_PAIRS=N                timed pairs (default 12)
  BENCH_REPEATS=N              timing repetitions per stencil, median-of;
                               forced odd (default 3)
  BENCH_CHECK=1                also run the on-card differential check
                               (a result past the tuner's CHECK_TOL is an
                               error row)
  BENCH_PROBE_BACKOFF=s1,s2    probe retry backoff seconds
                               (default 0,20,60,120)
  BENCH_SUITE_TIMEOUT=secs     per-suite-attempt timeout, the build
                               included (default 7200)
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(REPO, "benchmarks")

ALL = [
    "2d5pt_star",
    "2d5pt_cross",
    "2d9pt_star",
    "2d9pt_cross",
    "2d9pt_box",
    "2d25pt_box",
    "3d7pt_star",
    "3d9pt_cross",
]

METRIC = "geomean stencil throughput vs naive HBM roofline"
UNIT = ("GStencil/s over naive-sweep speed-of-light ({sol:g} GStencil/s "
        "fp32 @ {gbps:g} GB/s on {card}; fusion can exceed 1.0; "
        "target 0.85)")
UNIT_NO_CARD = ("GStencil/s over naive-sweep speed-of-light (the card did "
                "not answer the probe; fusion can exceed 1.0; target 0.85)")

# The tuner's gate per state dtype (tune/tuner.CHECK_TOL), for BENCH_CHECK.
CHECK_TOL = {"float32": 1e-3, "bfloat16": 1e-2}

# Signatures of a program fault: a message with any of these is the tuned
# config's or its kernel's error, whatever else it says.
_CONFIG_SIGNATURES = (
    "illegal memory access",
    "illegal instruction",
    "unspecified launch failure",
    "misaligned address",
    "out of memory",
    "nvcc failed",
    "device_check",
)
# Signatures of a card, driver or toolchain that is missing or broken.
_ENV_SIGNATURES = (
    "CUDA is not available",
    "no CUDA-capable device",
    "CUDA driver initialization failed",
    "Found no NVIDIA driver",
    "driver version is insufficient",
    "cudaErrorDevicesUnavailable",
    "busy or unavailable",
    "uncorrectable ECC error",
    "nvcc not found",
    "no published peaks recorded",
)


def is_env_error(msg: str) -> bool:
    """Whether ``msg`` says the ENVIRONMENT failed.  A program fault never
    counts as one, even where its message also names the device."""
    if any(sig in msg for sig in _CONFIG_SIGNATURES):
        return False
    return any(sig in msg for sig in _ENV_SIGNATURES)


def _names() -> list:
    names = os.environ.get("BENCH_STENCILS")
    return names.split(",") if names else list(ALL)


def _repeats() -> int:
    """``BENCH_REPEATS``, bumped to odd: the median is a real draw, never a
    mean of two."""
    repeats = max(1, int(os.environ.get("BENCH_REPEATS", "3")))
    if repeats % 2 == 0:
        repeats += 1
    return repeats


def _card_line(kind: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{kind}, power limit not read"


def _probe_inprocess():
    """Tiny matmul on the card + scalar fetch; raises where there is no
    card, or no published peaks for it.  Prints the card's name, power
    limit and roofline for the parent's ``unit``."""
    import torch

    from drstencil_tpu_torch.ops.stream import resolve_device
    from drstencil_tpu_torch.tune.tuned import card_peaks

    dev = resolve_device(None)
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    s = float((x @ x.T).sum().item())
    if s != 8 * 128 * 8:
        raise RuntimeError(f"probe matmul gave {s}, not {8 * 128 * 8}")
    kind = torch.cuda.get_device_name(dev)
    gbps, _ = card_peaks(kind)
    print("probe: ok " + json.dumps({"kind": kind, "card": _card_line(kind),
                                     "gbps": gbps, "sol": gbps / 8}))


def _probe_info(tail: str):
    """The probe's JSON from its output, or None."""
    for line in tail.splitlines():
        if line.startswith("probe: ok {"):
            try:
                return json.loads(line[len("probe: ok "):])
            except json.JSONDecodeError:
                return None
    return None


def _build():
    """Build (or find) every winner's per-plan kernel in one
    ``kernels.build_plans`` call: one ``nvcc`` per plan, all at once.  A
    failed build is raised here and again by its stencil's suite, where it
    is scored."""
    from drstencil_tpu_torch.ir.passes import analyze
    from drstencil_tpu_torch.ir.spec import load_stc
    from drstencil_tpu_torch.ops import kernels
    from drstencil_tpu_torch.ops.stream import level_plan
    from drstencil_tpu_torch.tune.tuned import best_config

    requests = []
    for name in _names():
        cfg = best_config(name)
        if cfg.variant == "xla":
            continue
        spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
        an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
        requests.append((level_plan(an, cfg), spec.dims, cfg.dtype, False))
    t0 = time.perf_counter()
    kernels.build_plans(requests)
    print(f"build: {len(requests)} plans built or found in "
          f"{time.perf_counter() - t0:.1f} s")


def _suite():
    """Run the stencils of ``BENCH_STENCILS`` in THIS process and print the
    JSON line (the parent runs one stencil per process)."""
    from drstencil_tpu_torch.ir.spec import load_stc
    from drstencil_tpu_torch.ops import kernels
    from drstencil_tpu_torch.ops.runner import StencilProgram
    from drstencil_tpu_torch.tune.tuned import best_config, naive_sol_gstencil

    pairs = int(os.environ.get("BENCH_PAIRS", "12"))
    repeats = _repeats()
    do_check = os.environ.get("BENCH_CHECK", "0") == "1"

    detail = {}
    for name in _names():
        cfg = best_config(name)
        row = {"cfg": cfg.label()}
        try:
            spec = load_stc(os.path.join(BENCH_DIR, name + ".stc"))
            prog = StencilProgram(spec, cfg)
            kernels.reset_launches()
            # median over repeats (not best-of): min-selection re-inherits
            # the winner's curse the finalists protocol removes
            runs = sorted(
                (prog.time(pairs=pairs) for _ in range(repeats)),
                key=lambda r: r.seconds_per_pair,
            )
            res = runs[len(runs) // 2]
            launches = sum(k.launches for k in kernels.KERNELS)
            frac = res.gstencil_per_s / naive_sol_gstencil(
                prog.dtype.itemsize)
            row.update({
                "ms_per_pair": round(res.seconds_per_pair * 1e3, 4),
                "ms_per_step": round(
                    res.seconds_per_pair * 1e3 / (2 * prog.an.step), 4),
                "gstencil_per_s": round(res.gstencil_per_s, 2),
                "eff_gbps": round(res.achieved_gbps, 1),
                "roofline_frac": round(frac, 4),
            })
            if do_check:
                diff = prog.device_check(pairs=1)
                if not diff <= CHECK_TOL[cfg.dtype]:
                    raise RuntimeError(
                        f"device_check {diff} exceeds {CHECK_TOL[cfg.dtype]}")
                row["max_dev_diff"] = diff
        except Exception as e:
            msg = str(e)[:300]
            key = "env_error" if is_env_error(msg) else "error"
            detail[name] = {"cfg": cfg.label(), key: msg}
            print(f"# {name}: {key.upper()} {msg[:200]}", file=sys.stderr)
            continue
        detail[name] = row
        print(f"# {name}: launches={launches} {row}", file=sys.stderr)

    print(json.dumps(_assemble(detail)))


def _assemble(detail: dict, unit: str = UNIT_NO_CARD) -> dict:
    """The one-line JSON from per-stencil detail rows.

    Geomean over scored stencils only: ok rows contribute their roofline
    fraction, broken-config rows contribute 1e-6 (a kernel fault must
    hurt), environment-failed rows are EXCLUDED and flagged — a missing
    card is not a perf number.
    """
    fracs = []
    env_failed = []
    for name, row in detail.items():
        if "roofline_frac" in row:
            fracs.append(max(row["roofline_frac"], 1e-9))
        elif "env_error" in row:
            env_failed.append(name)
        else:
            fracs.append(1e-6)
    if fracs:
        geomean = math.exp(sum(math.log(f) for f in fracs) / len(fracs))
    else:
        geomean = 0.0
    out = {
        "metric": METRIC,
        "value": round(geomean, 4),
        "unit": unit,
        "vs_baseline": round(geomean, 4),
        "detail": detail,
    }
    if env_failed:
        out["detail"]["_environment"] = {
            "environment_error": True,
            "stencils_env_failed": env_failed,
            "note": "card/driver/toolchain failure, NOT a perf result; "
                    "geomean covers the scored stencils only",
        }
    return out


# ---------------------------------------------------------------- parent


def _run_child(flag: str, names, timeout: float):
    """``python -m drstencil_tpu_torch.bench <flag>`` from the repository
    root, with ``BENCH_STENCILS`` set to ``names`` (all when None)."""
    env = dict(os.environ)
    if names is not None:
        env["BENCH_STENCILS"] = ",".join(names)
    return subprocess.run(
        [sys.executable, "-m", "drstencil_tpu_torch.bench", flag],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env,
    )


def _probe_with_retries(backoffs) -> tuple:
    """(ok, last_tail): retry the subprocess probe across backoffs."""
    tail = ""
    for i, delay in enumerate(backoffs):
        if delay:
            print(f"# probe retry in {delay}s", file=sys.stderr)
            time.sleep(delay)
        try:
            proc = _run_child("--probe", None, 600)
        except subprocess.TimeoutExpired:
            tail = "probe timeout (card did not answer in 600s)"
            print(f"# probe attempt {i + 1}: {tail}", file=sys.stderr)
            continue
        if proc.returncode == 0 and "probe: ok" in proc.stdout:
            return True, proc.stdout.strip()
        tail = (proc.stdout + proc.stderr)[-2000:]
        print(f"# probe attempt {i + 1} failed (rc={proc.returncode})",
              file=sys.stderr)
    return False, tail


def _run_stencil(name: str, timeout: float) -> dict:
    """One stencil's suite in a fresh subprocess; its detail row, made up
    where the process died (classified by its output's tail) or ran past
    ``timeout`` (a hang or a build past the budget: the config's error)."""
    try:
        proc = _run_child("--suite", [name], timeout)
    except subprocess.TimeoutExpired as e:
        out = e.stdout or ""
        err = e.stderr or ""
        if isinstance(out, bytes):
            out, err = out.decode(errors="replace"), err.decode(
                errors="replace")
        return {name: {"error": f"suite timeout after {timeout:.0f}s: "
                                f"{(out + err)[-1000:]}"}}
    sys.stderr.write(proc.stderr)
    for line in reversed(proc.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)["detail"]
            except (json.JSONDecodeError, KeyError):
                break
    tail = (proc.stdout + proc.stderr)[-1000:]
    key = "env_error" if is_env_error(tail) else "error"
    return {name: {key: f"suite crashed (rc={proc.returncode}): {tail}"}}


def _run_suite(names, timeout) -> dict:
    """One suite attempt over ``names`` (all when None) within ``timeout``
    seconds: the build subprocess, then one subprocess per stencil.
    Returns per-stencil detail.  A build that runs past the budget (a hung
    or endless ``nvcc``/``ptxas`` on the plans' own text) is every
    stencil's ``error`` row; after a build that finished, a stencil the
    budget never reached is an environment row (retried)."""
    names = list(names or ALL)
    deadline = time.monotonic() + timeout
    try:
        proc = _run_child("--build", names, timeout)
        sys.stderr.write(proc.stdout + proc.stderr[-3000:])
    except subprocess.TimeoutExpired:
        msg = f"build of the suite's plans ran past {timeout:.0f}s"
        print(f"# {msg}", file=sys.stderr)
        return {name: {"error": msg} for name in names}
    detail = {}
    for name in names:
        left = deadline - time.monotonic()
        if left <= 0:
            detail[name] = {"env_error": f"suite budget of {timeout:.0f}s "
                                         "spent before this stencil ran"}
            continue
        detail.update(_run_stencil(name, left))
    return detail


def main():
    backoffs = [
        float(s) for s in
        os.environ.get("BENCH_PROBE_BACKOFF", "0,20,60,120").split(",")
    ]
    timeout = float(os.environ.get("BENCH_SUITE_TIMEOUT", "7200"))
    names = _names()

    ok, tail = _probe_with_retries(backoffs)
    if not ok:
        print(json.dumps({
            "metric": METRIC, "value": 0.0, "unit": UNIT_NO_CARD,
            "vs_baseline": 0.0,
            "detail": {"_environment": {
                "environment_error": True,
                "note": "device probe never succeeded; NOT a perf result",
                "probe_attempts": len(backoffs),
                "probe_tail": tail[-1500:],
            }},
        }))
        return
    info = _probe_info(tail)
    unit = UNIT.format(**info) if info else UNIT_NO_CARD

    detail = _run_suite(names, timeout)
    detail.pop("_environment", None)
    failed = [n for n, row in detail.items() if "env_error" in row]
    if failed:
        print(f"# retrying env-failed stencils once: {failed}",
              file=sys.stderr)
        ok, _ = _probe_with_retries(backoffs)
        if ok:
            retry = _run_suite(failed, timeout)
            retry.pop("_environment", None)
            detail.update(retry)
    print(json.dumps(_assemble(detail, unit)))


if __name__ == "__main__":
    if "--probe" in sys.argv:
        _probe_inprocess()
    elif "--build" in sys.argv:
        _build()
    elif "--suite" in sys.argv:
        _suite()
    else:
        main()
