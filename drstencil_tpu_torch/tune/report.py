"""Render the port's tuning results — the port of
``drstencil_tpu/tune/report.py``.

``python -m drstencil_tpu_torch.tune.report [--out-dir tuning_gpu]``
prints a markdown table of the best measured config per stencil (from
``tune.tuned.TUNED_GPU_PATH``) with the sweep's coverage from the ledgers.
The roofline is the naive-sweep speed of light of the card each winner
was measured on (its ``score["device"]``), else of ``device_name``.
Where the ledgers hold tile candidates (``tm`` / ``ch``, the CTA's segment
and column), a second table sets each against the candidate it moves the
tile of, both at their sweep's measurement (:func:`tile_table`).
"""

from __future__ import annotations

import math
import os
import statistics

from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import state_dtype
from drstencil_tpu_torch.tune import tuned as tuned_mod


def _dims(name: str, entry: dict) -> tuple:
    """Grid dims of a winner: its recorded ``score["dims"]``, else the
    benchmark ``.stc``."""
    dims = entry.get("score", {}).get("dims")
    if dims:
        return tuple(dims)
    return tuple(load_stc(os.path.join(tuned_mod.BENCH_DIR,
                                       f"{name}.stc")).dims)


def render(out_dir: str = "tuning_gpu", tuned_path: str | None = None,
           device_name: str | None = None) -> str:
    tuned = tuned_mod.load_table(tuned_path or tuned_mod.TUNED_GPU_PATH)
    lines = ["| stencil | best config | card | ms/step | GStencil/s "
             "| vs naive SoL | configs tried (ok/err) |",
             "|---|---|---|---|---|---|---|"]
    fracs = []
    for name in sorted(tuned):
        score = tuned[name].get("score", {})
        ms = score.get("ms_per_step")
        if not ms:
            continue
        cfg = KernelConfig.from_dict(tuned[name]["config"])
        card = score.get("device") or device_name
        ledger = tuned_mod.load_table(
            os.path.join(out_dir, f"{name}.ledger.json"))
        n_ok = sum(1 for e in ledger.values() if e.get("status") == "ok")
        gst = math.prod(_dims(name, tuned[name])) / (ms * 1e-3) / 1e9
        frac = gst / tuned_mod.naive_sol_gstencil(
            state_dtype(cfg.dtype).itemsize, card)
        fracs.append(frac)
        lines.append(f"| {name} | {cfg.label()} | {card} | {ms:.4f} "
                     f"| {gst:.1f} | {frac:.2f} | {n_ok}/{len(ledger) - n_ok} |")
    if fracs:
        geo = math.exp(sum(map(math.log, fracs)) / len(fracs))
        lines.append(f"\ngeomean vs naive roofline: **{geo:.3f}** over "
                     f"{len(fracs)} stencils")
    tiles = tile_table(out_dir, sorted(tuned))
    return "\n".join(lines + ([""] + tiles if tiles else []))


def _pct(ratios) -> str:
    return (f"{(statistics.median(ratios) - 1) * 100:+.1f}%" if ratios
            else "-")


def tile_table(out_dir: str, names) -> list:
    """Lines of a markdown table: per stencil, its ok tile candidates'
    sweep ms/step over that of the candidate at the generator's tile (the
    same config with ``tm=None, ch=None``): how many beat it, the median
    change of the shorter and the longer segments and of the narrower
    columns, and the best.  Empty where no ledger holds a tile candidate."""
    from drstencil_tpu_torch.tune.space import smem_estimate

    lines = []
    for name in names:
        ledger = tuned_mod.load_table(
            os.path.join(out_dir, f"{name}.ledger.json"))
        ok = {k: e for k, e in ledger.items() if isinstance(e, dict)
              and e.get("status") == "ok"
              and isinstance(e.get("config"), dict)}
        kinds = {"shorter": [], "longer": [], "column": []}
        best = None
        for label, e in ok.items():
            cfg = KernelConfig.from_dict(e["config"])
            if cfg.tm is None and cfg.ch is None:
                continue
            base = cfg.replace(tm=None, ch=None)
            twin = ok.get(base.label())
            if twin is None:
                continue
            ratio = (e.get("ms_per_step_sweep") or e["ms_per_step"]) / (
                twin.get("ms_per_step_sweep") or twin["ms_per_step"])
            if cfg.ch is not None:
                kinds["column"].append(ratio)
            else:
                spec = load_stc(os.path.join(tuned_mod.BENCH_DIR,
                                             f"{name}.stc"))
                seg = smem_estimate(spec, base).tile[0]
                kinds["shorter" if cfg.tm < seg else "longer"].append(ratio)
            if best is None or ratio < best[0]:
                best = (ratio, label)
        n = sum(map(len, kinds.values()))
        if not n:
            continue
        beat = sum(r < 1 for rs in kinds.values() for r in rs)
        lines.append(f"| {name} | {n} | {beat} | {_pct(kinds['shorter'])} "
                     f"| {_pct(kinds['longer'])} | {_pct(kinds['column'])} "
                     f"| {best[1]} {(best[0] - 1) * 100:+.1f}% |")
    if not lines:
        return []
    return ["| stencil | tile candidates | faster than their default "
            "| shorter segment | longer segment | narrower column "
            "| best |", "|---|---|---|---|---|---|---|"] + lines


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="the port's tuning summary")
    ap.add_argument("--out-dir", default="tuning_gpu")
    args = ap.parse_args(argv)
    print(render(args.out_dir))


if __name__ == "__main__":
    main()
