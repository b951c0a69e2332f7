"""Tracing and the traffic model — the port of ``drstencil_tpu/utils/profiling.py``.

- :func:`maybe_trace` wraps a region in ``torch.profiler`` (CPU and CUDA
  activity) and writes a Chrome trace and a per-kernel table.  A failure
  is soft, as in the JAX package: tracing never kills a session, and the
  error is written to ``<trace_dir>/trace_error.txt``.
- :func:`traffic_model` gives one application's bytes and operations for
  the kernel that runs (``ops/codegen.Geometry``: columns, segments and
  their warm-up planes): what the kernel
  moves, for the tuner's ``modeled_gbps``, and the least the card could
  take for the same work, for ``chip_smoke.py``'s bound.
"""

from __future__ import annotations

import contextlib
import os
import traceback
from dataclasses import dataclass

import numpy as np

from drstencil_tpu_torch.ir.passes import Analysis
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops import stream as stream_mod
from drstencil_tpu_torch.ops.config import KernelConfig


def _record_error(trace_dir: str) -> None:
    try:
        os.makedirs(trace_dir, exist_ok=True)
        with open(os.path.join(trace_dir, "trace_error.txt"), "w") as f:
            f.write(traceback.format_exc())
    except OSError:
        pass


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """``torch.profiler`` trace of the body if ``trace_dir`` is given;
    yields whether a trace is being taken.  On exit it writes
    ``trace.json`` (Chrome trace) and ``kernels.txt`` (``key_averages``)
    to ``trace_dir``.  Errors of the profiler are soft and recorded in
    ``trace_error.txt``; errors of the body propagate."""
    if not trace_dir:
        yield False
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:  # soft: the platform cannot trace
        _record_error(trace_dir)
        yield False
        return
    try:
        yield True
    finally:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            with open(os.path.join(trace_dir, "kernels.txt"), "w") as f:
                f.write(prof.key_averages().table(row_limit=30))
        except Exception:  # soft: writing the trace must not kill a run
            _record_error(trace_dir)


@dataclass(frozen=True)
class TrafficModel:
    """One application's device-memory traffic and operations.

    ``read_bytes``/``write_bytes`` are what the kernel moves: every CTA's
    staged planes (its segment plus ``2 * frame`` warm-up planes of its
    haloed column, and a factor plan's one tail plane) read, the interior
    written.  ``bound_bytes`` is the
    least the function needs: each input cell read once and each output
    cell written once (2 · item · cells).  ``flops`` is 2 · taps · levels
    · cells (factor mode: 2 · (|V1| + |V2| + |R|) · step · cells), fp32
    FMAs on the CUDA cores whatever the storage dtype."""

    read_bytes: int
    write_bytes: int
    bound_bytes: int
    flops: int
    smem_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.read_bytes + self.write_bytes

    def achieved(self, seconds_per_apply: float, peak_gbps: float):
        """(achieved GB/s on the kernel's modeled traffic, fraction of
        ``peak_gbps``)."""
        gbps = self.total_bytes / seconds_per_apply / 1e9
        return gbps, gbps / peak_gbps

    def bound_ms(self, hbm_gbps: float, fp32_tflops: float):
        """(least ms of one application, "bytes" or "operations"): the
        larger of ``bound_bytes`` over the memory rate and ``flops`` over
        the fp32 rate."""
        bytes_ms = self.bound_bytes / (hbm_gbps * 1e9) * 1e3
        ops_ms = self.flops / (fp32_tflops * 1e12) * 1e3
        if bytes_ms >= ops_ms:
            return bytes_ms, "bytes"
        return ops_ms, "operations"


def traffic_model(an: Analysis, cfg: KernelConfig) -> TrafficModel:
    """The streaming kernel's traffic for one application of ``cfg``."""
    plan = stream_mod.level_plan(an, cfg)
    item = stream_mod.state_dtype(cfg.dtype).itemsize
    dims = tuple(an.spec.dims)
    H = plan.frame
    taps_per_cell = (plan.taps_per_step * an.step if kernels.is_factor(plan)
                     else len(plan.coeffs) * plan.levels)
    read_cells = kernels.geometry(plan, dims).read_cells()
    cells = int(np.prod(dims))
    interior = int(np.prod([d - 2 * H for d in dims]))
    return TrafficModel(
        read_bytes=read_cells * item,
        write_bytes=interior * item,
        bound_bytes=2 * item * cells,
        flops=2 * taps_per_cell * cells,
        smem_bytes=kernels.smem_bytes(plan, dims),
    )
