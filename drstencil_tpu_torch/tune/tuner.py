"""Autotuner sweeps — the port of ``drstencil_tpu/tune/tuner.py``.

Per config: build → check on the card against the torch gold → time →
score against the card's roofline.  The kernels of a sweep's candidates
are built before its first config is measured, one ``nvcc`` per plan, all
started together (``ops/kernels.build_plans``); an isolated worker finds
them in ``build/plans``.  Artifacts, in ``out_dir``:

- ``duration.log``     best-so-far (elapsed_s, ms_per_step) lines, and
  every 3D config's time;
- ``metrics.csv``      one row per measured config: kernel time, roofline
  metrics, the CTA's shared memory and tile;
- ``<stencil>.ledger.json``  config label → status/score; a killed sweep
  resumes from it;
- the winner per stencil in ``tune.tuned.TUNED_GPU_PATH`` (never in
  ``benchmarks/tuned.json``);
- ``cu/<stencil>__<label>.py``  the standalone program of the winner
  (``emit.emit`` with ``check=True``).

A failing config (a build or launch error, a failed check, a timeout) is
logged as ``status=error`` or ``check_failed`` and the sweep goes on.
The winner's generated program is kept under ``out_dir/cu/`` (every
attempted config's with ``--keep-artifacts``), as the JAX tuner keeps them.

``python -m drstencil_tpu_torch.tune.tuner benchmarks/2d5pt_star.stc
--out-dir /tmp/t --max-configs 4`` runs a short sweep on the card.
"""

from __future__ import annotations

import csv
import fnmatch
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from dataclasses import asdict, dataclass
from typing import Optional

import torch

from drstencil_tpu_torch import emit as emit_mod
from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import StencilSpec, load_stc
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops import stream as stream_mod
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.tune import tuned as tuned_mod
from drstencil_tpu_torch.tune.space import (Candidate, default_space,
                                            representative, smem_estimate)
from drstencil_tpu_torch.utils.profiling import traffic_model

# relative tolerance vs the torch gold on the card: fp32 roundoff across a
# few hundred accumulated terms; for bf16 both sides accumulate in fp32
# and round once per launch, so they differ by fp32 associativity plus at
# most one bf16 ulp at the rounding — up to 2^-7 relative just above a
# power of two (the JAX package's gate, tune/tuner.py:44)
CHECK_TOL = {"float32": 1e-3, "bfloat16": 1e-2}

# stdout line prefix the isolated worker hands its result back with
RESULT_MARKER = "DRSTENCIL_RESULT "

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclass
class SweepResult:
    best_cfg: Optional[KernelConfig]
    best_ms: float
    tried: int
    errors: int


def measure_config(spec: StencilSpec, cfg: KernelConfig, pairs: int = 10,
                   check: bool = True, device=None) -> dict:
    """Build, check on the device, and time ONE config; returns a ledger
    entry.  Module-level so that the isolated worker (``tune.worker``) and
    the in-process tuner run the same measurement.  ``device=None`` is
    CUDA; ``time()`` raises anywhere else."""
    prog = StencilProgram(spec, cfg, device)
    entry: dict = {"config": asdict(cfg)}
    if check and cfg.variant != "xla":
        diff = prog.device_check(pairs=1)
        entry["max_dev_diff"] = diff
        if diff > CHECK_TOL[cfg.dtype]:
            entry["status"] = "check_failed"
            return entry
    res = prog.time(pairs=pairs)
    kind = torch.cuda.get_device_name(prog.device)
    entry.update(
        status="ok",
        device=kind,
        ms_per_pair=res.seconds_per_pair * 1e3,
        # the objective: time per plain timestep (a launch advances `step`)
        ms_per_step=res.seconds_per_pair * 1e3 / (2 * prog.an.step),
        gstencil_per_s=res.gstencil_per_s,
        eff_gbps=res.achieved_gbps,
        roofline_frac=res.gstencil_per_s / tuned_mod.naive_sol_gstencil(
            prog.dtype.itemsize, kind),
    )
    if cfg.variant != "xla":
        # the kernel's modeled traffic (haloed tiles) over the measured
        # time per application: refetch overhead shows as modeled > eff
        gbps, frac = traffic_model(prog.an, cfg).achieved(
            res.seconds_per_pair / 2, tuned_mod.hbm_peak_gbps(kind))
        entry["modeled_gbps"] = round(gbps, 1)
        entry["modeled_hbm_frac"] = round(frac, 4)
    return entry


class Tuner:
    """Sweep one stencil's space on ``device`` (``None`` = CUDA).

    ``isolate=True`` measures each config in its own worker process with a
    hard kill at ``config_timeout_s``; otherwise configs run in this
    process under a SIGALRM cap (main thread only)."""

    def __init__(self, spec: StencilSpec, out_dir: str,
                 time_budget_s: float = 3600.0, pairs: int = 10,
                 check: bool = True, seed: int = 0,
                 config_timeout_s: float = 420.0, isolate: bool = False,
                 device=None, keep_artifacts: bool = False):
        self.spec = spec
        self.out_dir = out_dir
        self.time_budget_s = time_budget_s
        self.pairs = pairs
        self.check = check
        self.seed = seed
        self.config_timeout_s = config_timeout_s
        self.isolate = isolate
        self.device = device
        self.keep_artifacts = keep_artifacts
        os.makedirs(out_dir, exist_ok=True)
        self.ledger_path = os.path.join(out_dir, f"{spec.name}.ledger.json")
        self.metrics_path = os.path.join(out_dir, "metrics.csv")
        self.duration_path = os.path.join(out_dir, "duration.log")
        self.ledger = self._load_ledger()

    def _load_ledger(self) -> dict:
        try:
            with open(self.ledger_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def _save_ledger(self):
        with open(self.ledger_path, "w") as f:
            json.dump(self.ledger, f, indent=1, sort_keys=True)

    def _append_metrics(self, row: dict):
        header = ",".join(row)
        last_header = None
        try:
            with open(self.metrics_path) as f:
                for line in f:
                    if line.startswith("stencil,"):
                        last_header = line.rstrip("\n")
        except OSError:
            pass
        with open(self.metrics_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            # an append-log across versions: re-emit the header whenever
            # the schema changed since the last header line
            if last_header != header:
                w.writeheader()
            w.writerow(row)

    def _log_duration(self, line: str):
        with open(self.duration_path, "a") as f:
            f.write(line + "\n")

    def _measure_with_timeout(self, cand: Candidate) -> dict:
        if self.isolate:
            return self._measure_isolated(cand)
        if (self.config_timeout_s <= 0
                or threading.current_thread() is not threading.main_thread()):
            return self._measure(cand)

        def on_alarm(signum, frame):
            raise TimeoutError(
                f"config exceeded {self.config_timeout_s:.0f}s (build or "
                "run); skipped")

        old = signal.signal(signal.SIGALRM, on_alarm)
        signal.alarm(max(1, int(self.config_timeout_s)))
        try:
            return self._measure(cand)
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old)

    def _measure(self, cand: Candidate) -> dict:
        return measure_config(self.spec, cand.cfg, pairs=self.pairs,
                              check=self.check, device=self.device)

    def _measure_isolated(self, cand: Candidate) -> dict:
        """Measure one config in a fresh ``tune.worker`` process, killed at
        ``config_timeout_s``: a hung build or kernel dies with it."""
        payload = json.dumps({
            "stc": self.spec.to_stc(),
            "name": self.spec.name,
            "config": asdict(cand.cfg),
            "pairs": self.pairs,
            "check": self.check,
            "device": None if self.device is None else str(self.device),
        })
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "drstencil_tpu_torch.tune.worker"],
                input=payload, capture_output=True, text=True, env=env,
                timeout=(self.config_timeout_s if self.config_timeout_s > 0
                         else None))
        except subprocess.TimeoutExpired:
            raise TimeoutError(
                f"config exceeded {self.config_timeout_s:.0f}s in isolated "
                "worker (build or run); process killed, sweep continues")
        for line in reversed(proc.stdout.splitlines()):
            if line.startswith(RESULT_MARKER):
                return json.loads(line[len(RESULT_MARKER):])
        raise RuntimeError(
            f"isolated worker failed (rc={proc.returncode}): "
            f"{proc.stdout[-800:]}\n{proc.stderr[-1500:]}")

    def candidates(self, max_configs: Optional[int] = None,
                   label_filter: Optional[str] = None) -> list:
        """The sweep order: the space shuffled by ``seed``, with the
        best-known config (its Hopper representative) first, cut to
        ``max_configs``."""
        cands = list(default_space(self.spec))
        if label_filter:
            cands = [c for c in cands
                     if fnmatch.fnmatch(c.cfg.label(), label_filter)]
        random.Random(self.seed).shuffle(cands)
        # a short sweep must never do worse than the previous best: the
        # prior (the card's winner, else the TPU winner without its TPU
        # tile sizes: tuned.best_config) maps onto its representative
        prior = tuned_mod.best_config(self.spec.name)
        if prior.variant != "xla":
            prior = representative(prior, self.spec.ndim)
            if all(c.cfg.label() != prior.label() for c in cands):
                pc = smem_estimate(self.spec, prior)
                if pc is not None:
                    cands.insert(0, pc)
        cands.sort(key=lambda c: c.cfg.label() != prior.label())
        return cands[:max_configs] if max_configs else cands

    def prebuild(self, cands, log=print) -> None:
        """Build the per-plan kernels of ``cands`` ahead of their
        measurement, so that no config's cap or timed window holds a
        build.  A plan whose build fails is left to fail again in its
        config's turn, where the sweep logs it."""
        try:
            if stream_mod.resolve_device(self.device).type != "cuda":
                return
        except RuntimeError:        # no card: every config will say so
            return
        requests = []
        for cand in cands:
            cfg = cand.cfg
            if cfg.variant == "xla" or cfg.factor:
                continue
            an = analyze(self.spec, step=cfg.step, distance=cfg.distance,
                         merge_forward=cfg.merge_forward)
            requests.append((stream_mod.level_plan(an, cfg), self.spec.dims,
                             cfg.dtype, False))
        t0 = time.time()
        try:
            kernels.build_plans(requests)
        except RuntimeError as e:
            log(f"[{self.spec.name}] a kernel build failed: {str(e)[:200]}")
        log(f"[{self.spec.name}] {len(requests)} kernels built or found in "
            f"{time.time() - t0:.1f} s")

    @staticmethod
    def _scored(entry: dict):
        ms = tuned_mod.ledger_ms(entry)
        cfg = KernelConfig.from_dict(entry["config"])
        return (tuned_mod.objective_ms(ms, cfg.dtype), ms, cfg,
                entry.get("device"))

    def sweep(self, max_configs: Optional[int] = None, log=print,
              label_filter: Optional[str] = None) -> SweepResult:
        start = time.time()
        cands = self.candidates(max_configs, label_filter)

        # the best (objective, ms/step, config, device) minimises the
        # SoL-normalised objective (tuned.objective_ms), seeded from a
        # resumed ledger
        best = (float("inf"), float("inf"), None, None)
        for entry in self.ledger.values():
            if entry.get("status") == "ok":
                best = min(best, self._scored(entry), key=lambda b: b[0])

        self.prebuild([c for c in cands if c.cfg.label() not in self.ledger],
                      log)
        tried = errors = 0
        for i, cand in enumerate(cands):
            label = cand.cfg.label()
            if label in self.ledger:
                continue  # resume: already measured
            if time.time() - start > self.time_budget_s:
                log(f"[{self.spec.name}] time budget reached")
                break
            tried += 1
            log(f"[{self.spec.name}] {i + 1}/{len(cands)}: {label}")
            if self.keep_artifacts:
                # written BEFORE measuring, so that a failed or hung config
                # leaves a program to debug too
                emit_artifact(self.spec, cand.cfg, self.out_dir, log)
            try:
                entry = self._measure_with_timeout(cand)
            except Exception as e:  # build/launch/timeout: skip and log
                entry = {"config": asdict(cand.cfg), "status": "error",
                         "error": str(e)[:500]}
                errors += 1
            entry["elapsed_s"] = round(time.time() - start, 1)
            self.ledger[label] = entry
            self._save_ledger()
            if entry.get("status") != "ok":
                continue
            self._append_metrics({
                "stencil": self.spec.name,
                "config": label,
                "ms_per_pair": round(entry["ms_per_pair"], 4),
                "ms_per_step": round(entry["ms_per_step"], 4),
                "gstencil_per_s": round(entry["gstencil_per_s"], 2),
                "eff_gbps": round(entry["eff_gbps"], 1),
                "roofline_frac": round(entry["roofline_frac"], 4),
                "smem_bytes": cand.smem_bytes,
                "tile": "x".join(map(str, cand.tile)),
                "modeled_gbps": entry.get("modeled_gbps", ""),
                "modeled_hbm_frac": entry.get("modeled_hbm_frac", ""),
                "max_dev_diff": entry.get("max_dev_diff", ""),
                "device": entry.get("device", ""),
            })
            if self.spec.ndim == 3:
                self._log_duration(f"{self.spec.name} [{label}]: "
                                   f"{entry['ms_per_step']:.4f} ms/step")
            scored = self._scored(entry)
            if scored[0] < best[0]:
                best = scored
                self._log_duration(f"{self.spec.name}: "
                                   f"{time.time() - start:.0f} s, "
                                   f"{scored[1]:.4f} ms/step")

        _, best_ms, best_cfg, device = best
        if best_cfg is not None:
            score = {"ms_per_step": best_ms, "dims": list(self.spec.dims)}
            if device:
                score["device"] = device
            tuned_mod.record_best(self.spec.name, best_cfg, score)
            emit_artifact(self.spec, best_cfg, self.out_dir, log)
        return SweepResult(best_cfg=best_cfg, best_ms=best_ms, tried=tried,
                           errors=errors)


def emit_artifact(spec: StencilSpec, cfg: KernelConfig, out_dir: str,
                  log=print) -> None:
    """Write ``cfg``'s generated program to ``out_dir/cu/<stencil>__<label>
    .py`` (``emit.emit`` with ``check=True``).  Only stream configs have an
    emitter, and factor mode has none, so those are skipped.  Soft-fail:
    emitting an artifact must never kill a sweep."""
    if cfg.variant != "stream" or cfg.factor:
        return
    try:
        text = emit_mod.emit(
            spec, spec.name, step=cfg.step, distance=cfg.distance,
            merge_forward=cfg.merge_forward, tm=cfg.tm or 0, check=True,
            dtype=cfg.dtype, trapezoid=cfg.trapezoid,
            lane_mode=cfg.lane_mode or "", ch=cfg.ch or 0, vfuse=cfg.vfuse,
            block=cfg.block, prefetch=cfg.prefetch, jfix=cfg.jfix,
            cli_line=f"(tuner: {cfg.label()})")
        cu_dir = os.path.join(out_dir, "cu")
        os.makedirs(cu_dir, exist_ok=True)
        path = os.path.join(cu_dir, f"{spec.name}__{cfg.label()}.py")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
    except Exception as e:
        log(f"[{spec.name}] artifact emit skipped: {str(e)[:200]}")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="drstencil_tpu_torch autotuner")
    ap.add_argument("stc", help=".stc file to tune")
    ap.add_argument("--out-dir", default="tuning_gpu")
    ap.add_argument("--budget", type=float, default=3600.0,
                    help="wall-clock budget in seconds")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--max-configs", type=int, default=None)
    ap.add_argument("--filter", default=None,
                    help="fnmatch glob over config labels, e.g. "
                    "'stream_fu4_*'")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--isolate", action="store_true",
                    help="measure each config in its own process, killed "
                    "at the per-config timeout")
    ap.add_argument("--keep-artifacts", action="store_true",
                    help="write cu/<stencil>__<label>.py for every "
                    "attempted config, not just the winner")
    ap.add_argument("--config-timeout", type=float, default=420.0,
                    help="per-config cap in seconds (a kill with "
                    "--isolate, SIGALRM otherwise)")
    args = ap.parse_args(argv)
    spec = load_stc(args.stc)
    tuner = Tuner(spec, args.out_dir, time_budget_s=args.budget,
                  pairs=args.pairs, check=not args.no_check,
                  isolate=args.isolate, config_timeout_s=args.config_timeout,
                  keep_artifacts=args.keep_artifacts)
    res = tuner.sweep(max_configs=args.max_configs, label_filter=args.filter)
    print(f"best for {spec.name}: "
          f"{res.best_cfg.label() if res.best_cfg else 'none'} "
          f"at {res.best_ms:.4f} ms/step ({res.tried} tried, "
          f"{res.errors} errors)")


if __name__ == "__main__":
    main()
