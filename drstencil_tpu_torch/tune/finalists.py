"""Finalist re-measurement — the port of ``drstencil_tpu/tune/finalists.py``.

A sweep records each config's time from one noisy measurement, so the
argmin over many configs flatters the winner (winner's curse).  This pass
re-times the top-K ledger configs per stencil ``reps`` times each, in one
process on one card, picks the best SoL-normalised median, folds the
medians back into the ledger, and writes the winners to
``tune.tuned.TUNED_GPU_PATH`` directly (bypassing ``record_best``'s
monotonicity, which would refuse an honest but larger number), and keeps
each winner's generated program in ``out_dir/cu/`` in step with it.

``python -m drstencil_tpu_torch.tune.finalists [--out-dir tuning_gpu]
[--top 4] [--reps 3] [--stencils a,b,...]``
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
from dataclasses import asdict

import torch

from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.tune import tuned as tuned_mod
from drstencil_tpu_torch.tune.tuner import emit_artifact


def top_configs(paths, k: int):
    """The ``k`` best (objective, label, config dict) over the ok entries
    of the given ledgers, current and archived (every finalist is
    re-measured, so a stale time only decides who is shortlisted)."""
    rows = {}
    for ledger_path in paths:
        try:
            with open(ledger_path) as f:
                ledger = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        for label, e in ledger.items():
            # one malformed entry must not abort the whole pass
            if not isinstance(e, dict) or e.get("status") != "ok":
                continue
            if not isinstance(e.get("config"), dict):
                continue
            obj = tuned_mod.objective_ms(tuned_mod.ledger_ms(e),
                                         e["config"].get("dtype", "float32"))
            if label not in rows or obj < rows[label][0]:
                rows[label] = (obj, label, e["config"])
    return sorted(rows.values(), key=lambda r: r[0])[:k]


def writeback_medians(ledger_path: str, measured: dict, reps: int) -> None:
    """Fold re-measured medians back into the live ledger, keeping the raw
    sweep value as ``ms_per_step_sweep``, so that a later argmin over the
    ledger (``record_best``, ``reconcile_from_ledgers``) cannot bring back
    a lucky draw this pass overturned."""
    try:
        with open(ledger_path) as f:
            ledger = json.load(f)
    except (OSError, json.JSONDecodeError):
        return
    changed = False
    for label, med in measured.items():
        e = ledger.get(label)
        if not isinstance(e, dict):
            continue
        e.setdefault("ms_per_step_sweep", e.get("ms_per_step"))
        e["ms_per_step"] = med
        e["protocol"] = f"median-of-{reps}"
        changed = True
    if changed:
        with open(ledger_path, "w") as f:
            json.dump(ledger, f, indent=1, sort_keys=True)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="tuning_gpu")
    ap.add_argument("--top", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--stencils", default="")
    args = ap.parse_args(argv)

    want = set(args.stencils.split(",")) if args.stencils else None
    by_name: dict = {}
    for pat in ("*.ledger.json", os.path.join("archive-*", "*.ledger.json")):
        for path in glob.glob(os.path.join(args.out_dir, pat)):
            name = os.path.basename(path)[: -len(".ledger.json")]
            by_name.setdefault(name, []).append(path)
    results = {}
    for name in sorted(by_name):
        if want and name not in want:
            continue
        spec = load_stc(os.path.join(tuned_mod.BENCH_DIR, name + ".stc"))
        best = None
        measured = {}
        for _, label, cfg_d in top_configs(by_name[name], args.top):
            cfg = KernelConfig.from_dict(cfg_d)
            try:
                prog = StencilProgram(spec, cfg, device)
                meds = [prog.time(pairs=args.pairs).seconds_per_pair * 1e3
                        / (2 * prog.an.step) for _ in range(args.reps)]
            except Exception as e:  # one bad finalist must not end the pass
                print(f"[{name}] {label}: ERROR {str(e)[:120]}", flush=True)
                continue
            med = statistics.median(meds)
            measured[label] = med
            print(f"[{name}] {label}: median {med:.4f} ms/step "
                  f"(reps {['%.4f' % m for m in meds]})", flush=True)
            obj = tuned_mod.objective_ms(med, cfg.dtype)
            if best is None or obj < best[0]:
                best = (obj, med, label, cfg, prog.device)
        writeback_medians(
            os.path.join(args.out_dir, name + ".ledger.json"),
            measured, args.reps)
        if best is None:
            continue
        _, med, label, cfg, dev = best
        results[name] = {"config": asdict(cfg),
                         "score": {"ms_per_step": med,
                                   "dims": list(spec.dims),
                                   "device": torch.cuda.get_device_name(dev),
                                   "protocol": f"median-of-{args.reps}"}}
        print(f"[{name}] FINALIST: {label} @ {med:.4f} ms/step", flush=True)
        emit_artifact(spec, cfg, args.out_dir,
                      log=lambda m: print(m, flush=True))

    path = tuned_mod.TUNED_GPU_PATH
    tuned = tuned_mod.load_table(path)
    tuned.update(results)
    with open(path, "w") as f:
        json.dump(tuned, f, indent=2, sort_keys=True)
    print(f"{os.path.basename(path)} updated for {sorted(results)}")
    return results


if __name__ == "__main__":
    main()
