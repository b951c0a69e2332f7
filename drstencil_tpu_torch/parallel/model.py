"""Weak-scaling model table for the sharded streaming kernel — the port of
``drstencil_tpu/parallel/model.py``.

For every tuned winner (``tune/tuned.best_config``) it prints the
halo-exchange cost of :func:`stream_shard.halo_traffic_model` and, where
the card's single-device ms/step is known, the MODELLED weak-scaling
efficiency.  The ``score`` fields of ``benchmarks/tuned.json`` are TPU
times and are never read: the card's time comes from the caller (a dict by
stencil name, as ``chip_smoke.py`` measures it) or from
``drstencil_tpu_torch/tune/tuned_gpu.json`` (the port's committed winners).
Without either, a row carries bytes and copy time only.  The traffic
accounting is pinned to the exchange's own counters by
``tests/test_torch_parallel.py``; this module only divides those bytes by
NVLink's data-sheet rate.

Usage::

    python -m drstencil_tpu_torch.parallel.model     # table for all winners
"""

from __future__ import annotations

import os

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops.stream import state_dtype
from drstencil_tpu_torch.parallel import stream_shard
from drstencil_tpu_torch.tune import tuned


def _card_ms_per_step(name: str):
    """ms/step of ``name``'s entry in ``tuned_gpu.json``, else None."""
    entry = tuned.load_table(tuned.TUNED_GPU_PATH).get(name, {})
    return entry.get("score", {}).get("ms_per_step")


def winner_rows(n_shards: int = 8, ms_per_step: dict | None = None,
                latency_s: float = 0.0) -> list[dict]:
    """One model row per tuned winner.

    Weak scaling: each device keeps the FULL single-device problem (the
    premise ``halo_traffic_model`` prices), so the analysis is the
    undivided spec's; the halo bytes do not depend on ``dims[0]`` anyway.
    ``n_shards`` sets the mesh-wide totals; it does not change one
    device's traffic on a 1-axis mesh (one exchange per side whatever n).
    ``ms_per_step`` maps stencil names to the card's measured
    single-device ms/step; ``latency_s`` is the measured time of one copy
    beyond its bytes.
    """
    rows = []
    for name in sorted(tuned.tuned_entries()):
        cfg = tuned.best_config(name)
        spec = load_stc(os.path.join(tuned.BENCH_DIR, name + ".stc"))
        an = analyze(spec, step=cfg.step, distance=cfg.distance,
                     merge_forward=cfg.merge_forward)
        ms = (ms_per_step or {}).get(name)
        if ms is None:
            ms = _card_ms_per_step(name)
        m = stream_shard.halo_traffic_model(
            an, cfg.step, n_shards, ms_per_step_single=ms,
            itemsize=state_dtype(cfg.dtype).itemsize, latency_s=latency_s)
        m["name"], m["config"] = name, cfg.label()
        rows.append(m)
    return rows


def main() -> None:
    rows = winner_rows()
    hdr = (f"{'stencil':<12} {'config':<34} {'halo':>4} {'row cells':>9} "
           f"{'KiB/apply':>9} {'halo us/step':>12} {'ms/step':>8} "
           f"{'weak eff (model)':>16}")
    print(hdr)
    print("-" * len(hdr))
    for m in rows:
        ms = m.get("ms_per_step_single")
        eff = m.get("weak_scaling_efficiency")
        print(f"{m['name']:<12} {m['config']:<34} {m['halo']:>4} "
              f"{m['row_cells']:>9} {m['bytes_per_apply'] / 1024:>9.1f} "
              f"{m['halo_ms_per_step'] * 1e3:>12.2f} "
              f"{'not measured' if ms is None else format(ms, '.4f'):>8} "
              f"{'-' if eff is None else format(eff, '.4f'):>16}")


if __name__ == "__main__":
    main()
