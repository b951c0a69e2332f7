"""Best-known kernel configs per benchmark stencil, and the card's roofline.

The port's tuner (``tune.tuner``) records the winning config per stencil
into ``drstencil_tpu_torch/tune/tuned_gpu.json`` (``TUNED_GPU_PATH``),
monotone under the dtype-normalised objective, and never writes
``benchmarks/tuned.json`` (the JAX package's TPU winners).
``best_config`` reads a ``tuned_gpu.json`` entry where there is one, else
the ``tuned.json`` entry, else a curated default (``_DEFAULTS``).

``tm`` and ``ch`` mean the CTA's segment and column on Hopper
(``ops/config.py``), and a ``tuned_gpu.json`` entry keeps the values it
was measured with.  The ``tuned.json`` entries and the curated defaults
carry the TPU's tile sizes instead (``tm=64``, ``tm=8192``,
``tm6160_ch3080``): read as Hopper values they would ask for 8192-plane
segments or a column that names nothing, so every config taken from them
comes with ``tm=None, ch=None`` (:func:`tpu_config`), the generator's own
tile; every other field is kept.
The roofline denominator is the card's own HBM bandwidth, chosen from its
device name; an unknown card raises rather than borrow another's number.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import asdict

from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import state_dtype

# Published peaks by device-name fragment (NVIDIA data sheets; dense, at
# the full power limit): (HBM GB/s, fp32 CUDA-core TFLOP/s).  Checked in
# order, so the specific H100 parts precede the SXM default.
CARD_PEAKS = (
    ("H100 PCIe", (2000.0, 51.0)),
    ("H100 NVL", (3900.0, 60.0)),
    ("H200", (4800.0, 67.0)),
    ("H100", (3350.0, 67.0)),  # SXM5, HBM3
)


def card_peaks(device_name: str | None = None):
    """(HBM GB/s, fp32 TFLOP/s) of the named card (default: CUDA device
    0).  Raises ValueError on a card not in ``CARD_PEAKS``."""
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name(0)
    for fragment, peaks in CARD_PEAKS:
        if fragment in device_name:
            return peaks
    raise ValueError(f"no published peaks recorded for {device_name!r}")


def hbm_peak_gbps(device_name: str | None = None) -> float:
    return card_peaks(device_name)[0]


def naive_sol_gstencil(itemsize: int = 4,
                       device_name: str | None = None) -> float:
    """Speed-of-light stencil throughput of a NAIVE (unfused) sweep: one
    read + one write per cell per timestep at the card's HBM peak.
    Temporal fusion legitimately exceeds 1.0 of this."""
    return hbm_peak_gbps(device_name) / (2 * itemsize)


def objective_ms(ms_per_step: float, dtype: str = "float32") -> float:
    """SoL-normalised objective: fp32-equivalent ms per timestep.  The
    roofline fraction divides by the naive SoL of the config's own dtype,
    twice as high for bf16, so a bf16 config must be twice as fast in raw
    ms to score the same; identical to raw ms for fp32."""
    return ms_per_step * 4.0 / state_dtype(dtype).itemsize


BENCH_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "benchmarks",
)
# the JAX package's TPU winners: read, never written by the port
TUNED_PATH = os.path.join(BENCH_DIR, "tuned.json")
# the port's own winners on the card, committed beside this module
TUNED_GPU_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tuned_gpu.json")

# Curated defaults of the JAX package, for names tuned.json lacks.
_DEFAULTS = {
    "2d5pt_star": dict(variant="stream", step=2, tm=512, lane_mode="roll"),
    "2d5pt_cross": dict(variant="stream", step=2, tm=512, lane_mode="roll"),
    "2d9pt_star": dict(variant="stream", step=2, tm=512, lane_mode="roll",
                       trapezoid=True),
    "2d9pt_cross": dict(variant="stream", step=2, tm=512, lane_mode="roll",
                        trapezoid=True),
    "2d9pt_box": dict(variant="stream", step=2, tm=512, lane_mode="roll",
                      trapezoid=True),
    "2d25pt_box": dict(variant="stream", step=2, tm=512, lane_mode="roll",
                       trapezoid=True),
    "3d7pt_star": dict(variant="stream", step=2, tm=8192, trapezoid=True),
    "3d9pt_cross": dict(variant="stream", step=2, tm=8192, trapezoid=True),
}


def tuned_entries(path: str | None = None) -> dict:
    """A winners table (default ``tuned.json``): name -> {"config": ...,
    "score": ...}."""
    with open(path or TUNED_PATH) as f:
        return json.load(f)


def load_table(path: str) -> dict:
    """A winners table or ledger at ``path``; {} where it is missing or
    unreadable."""
    try:
        return tuned_entries(path)
    except (OSError, json.JSONDecodeError):
        return {}


def tpu_config(d: dict) -> KernelConfig:
    """A config of the TPU's tables (``tuned.json``, ``_DEFAULTS``) as the
    port runs it: every field kept but the TPU tile sizes ``tm`` and
    ``ch``, which become ``None`` (the generator's segment and column)."""
    return KernelConfig.from_dict(d).replace(tm=None, ch=None)


def best_config(name: str) -> KernelConfig:
    """The ``tuned_gpu.json`` winner as recorded, else the ``tuned.json``
    one, else the curated default (both without their TPU tile sizes:
    :func:`tpu_config`)."""
    try:
        return KernelConfig.from_dict(
            load_table(TUNED_GPU_PATH)[name]["config"])
    except (KeyError, TypeError):
        pass
    try:
        return tpu_config(load_table(TUNED_PATH)[name]["config"])
    except (KeyError, TypeError):
        pass
    return tpu_config(_DEFAULTS.get(name, {"variant": "stream"}))


def ledger_ms(entry: dict) -> float:
    """ms per plain timestep of an ok ledger entry (legacy entries carry
    only ms_per_pair, which covers 2*step timesteps)."""
    ms = entry.get("ms_per_step")
    if ms is None:
        ms = entry.get("ms_per_pair", 1e18) / (
            2 * entry["config"].get("step", 1))
    return ms


def record_best(name: str, cfg: KernelConfig, score: dict) -> None:
    """Record a measured best config in ``TUNED_GPU_PATH`` — monotone:
    never replaces a stored entry whose SoL-normalised objective is better
    (a short sweep must not regress the record of a longer earlier one)."""
    path = TUNED_GPU_PATH
    tuned = load_table(path)
    entry = tuned.get(name, {})
    old = entry.get("score", {}).get("ms_per_step")
    new = score.get("ms_per_step")
    if old is not None and new is not None:
        old_obj = objective_ms(
            old, entry.get("config", {}).get("dtype", "float32"))
        if old_obj <= objective_ms(new, cfg.dtype):
            return
    tuned[name] = {"config": asdict(cfg), "score": score}
    with open(path, "w") as f:
        json.dump(tuned, f, indent=2, sort_keys=True)


def reconcile_from_ledgers(ledger_dir: str) -> dict:
    """Rebuild ``TUNED_GPU_PATH`` as the argmin over every ok measurement
    in a tuning directory's ``<stencil>.ledger.json`` files; returns
    name -> ms per step of the argmin."""
    best: dict = {}
    for path in glob.glob(os.path.join(ledger_dir, "*.ledger.json")):
        name = os.path.basename(path)[: -len(".ledger.json")]
        for entry in load_table(path).values():
            if entry.get("status") != "ok":
                continue
            ms = ledger_ms(entry)
            obj = objective_ms(ms, entry["config"].get("dtype", "float32"))
            if name not in best or obj < best[name][0]:
                best[name] = (obj, ms, entry)
    for name, (_, ms, entry) in best.items():
        score = {"ms_per_step": ms}
        if "device" in entry:
            score["device"] = entry["device"]
        record_best(name, KernelConfig.from_dict(entry["config"]), score)
    return {k: v[1] for k, v in best.items()}
