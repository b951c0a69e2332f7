"""Render the port's tuning results — the port of
``drstencil_tpu/tune/report.py``.

``python -m drstencil_tpu_torch.tune.report [--out-dir tuning_gpu]``
prints a markdown table of the best measured config per stencil (from
``tune.tuned.TUNED_GPU_PATH``) with the sweep's coverage from the ledgers.
The roofline is the naive-sweep speed of light of the card each winner
was measured on (its ``score["device"]``), else of ``device_name``.
"""

from __future__ import annotations

import math
import os

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
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="the port's tuning summary")
    ap.add_argument("--out-dir", default="tuning_gpu")
    args = ap.parse_args(argv)
    print(render(args.out_dir))


if __name__ == "__main__":
    main()
