"""Best-known kernel configs per benchmark stencil, and the card's roofline.

``best_config`` reads ``benchmarks/tuned.json`` — the JAX package's tuned
winners — unchanged (``KernelConfig.from_dict`` keeps every field).  The
roofline denominator is the card's own HBM bandwidth, chosen from its
device name; an unknown card raises rather than borrow another's number.
"""

from __future__ import annotations

import json
import os

from drstencil_tpu_torch.ops.config import KernelConfig

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


TUNED_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "benchmarks",
    "tuned.json",
)

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


def tuned_entries(path: str = TUNED_PATH) -> dict:
    """The tuned.json table: name -> {"config": ..., "score": ...}."""
    with open(path) as f:
        return json.load(f)


def best_config(name: str) -> KernelConfig:
    try:
        tuned = tuned_entries()
        if name in tuned:
            return KernelConfig.from_dict(tuned[name]["config"])
    except (OSError, json.JSONDecodeError, TypeError):
        pass
    return KernelConfig(**_DEFAULTS.get(name, {"variant": "stream"}))
