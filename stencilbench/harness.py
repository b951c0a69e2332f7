"""One run of one cell: set-up, the measured window, the traced slice, the
metrics and the check of the answers against the plain reference.

The system under test is ``drstencil_tpu_torch``: the configuration's
frozen `.stc` loaded by ``ir.spec.load_stc``, the port's winner
``tune.tuned.best_config`` in the configuration's state dtype, and
``ops.runner.StencilProgram``, which builds or finds the plan's kernel in
``build/plans`` inside the checkout. A request resets ``a`` from the
field, solves with ``run_pairs`` and, in a mix with ``readback``, returns
the result to host memory with ``final_a``. A cell on more than one card
runs the port's sharded main path instead (``sharded.ShardedSolve``), with
the same interface.
"""

from __future__ import annotations

import math
import random
import subprocess
import time
from dataclasses import dataclass
from typing import Optional

import torch
from drstencil_tpu_torch.ir.spec import load_stc as port_load_stc
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.tune.tuned import best_config

from stencilbench import reference, trace
from stencilbench.cells import Cell
from stencilbench.sharded import ShardedSolve
from stencilbench.work import (Work, card_peaks, field_of,
                               pairs_per_request, work_of)

CHECKED = "max_rel_err"


class Solve:
    """The port's program for a cell, its ping-pong state, the field of the
    seed loaded last, and the answers kept for the check: the requests whose
    index the seed draws among the first ``sample_from`` of the mix, and the
    last one. ``dtype`` overrides the configuration's state dtype (the
    control runs the program's own bfloat16 path)."""

    def __init__(self, cell: Cell, device, dtype=None):
        spec = port_load_stc(cell.stc_path)
        if list(spec.dims) != list(cell.config["dims"]):
            raise ValueError(f"{cell.stc_path} is {spec.dims}, its "
                             f"configuration says {cell.config['dims']}")
        self.cell = cell
        self.cfg = best_config(cell.config["stencil"]).replace(
            dtype=dtype or cell.config["dtype"])
        self.prog = StencilProgram(spec, self.cfg, device=device)
        self.device = self.prog.device
        self.devices = (self.device,)
        self.step = self.prog.an.step
        self.pairs = pairs_per_request(cell.traffic["timesteps"], self.step)
        shape = tuple(spec.dims)
        make = dict(dtype=self.prog.dtype, device=self.device)
        self.a0 = torch.empty(shape, **make)
        self.state = {"a": torch.empty(shape, **make),
                      "b": torch.zeros(shape, **make)}
        self._snaps = ([] if cell.traffic["readback"] else
                       [torch.empty(shape, **make)
                        for _ in range(cell.traffic["check_samples"])])

    def load(self, seed: int) -> None:
        """Make the field of ``seed`` and draw the requests to keep."""
        mix = self.cell.traffic
        self.seed = seed
        self.a0.copy_(field_of(self.cell.config, self.a0.shape, seed,
                               self.device, self.a0.dtype))
        self.samples = sorted(random.Random(seed).sample(
            range(mix["sample_from"]), mix["check_samples"]))
        self.forget()

    def reset(self) -> None:
        self.state["a"].copy_(self.a0)

    def solve(self) -> None:
        self.prog.run_pairs(self.state, self.pairs)

    def readback(self):
        return self.prog.final_a(self.state)

    def answered(self, index: int, out=None) -> None:
        """Keep request ``index``'s answer if it is sampled: the returned
        host array, or a device copy of ``a`` where nothing is returned."""
        self.last = out
        if index in self.samples:
            if out is None:
                out = self._snaps[self.samples.index(index)].copy_(
                    self.state["a"])
            self.kept[index] = out

    def forget(self) -> None:
        self.kept: dict = {}
        self.last = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def work(self) -> Work:
        dims, taps = reference.load_stc(self.cell.stc_path)
        return work_of(dims, len(taps), self.cell.traffic["timesteps"],
                       self.step, self.cfg.dtype)

    def answers(self) -> dict:
        """The kept answers by label; the last one is ``a`` itself where the
        mix returns nothing."""
        out = {f"request {i}": v for i, v in sorted(self.kept.items())}
        out["last request"] = (self.state["a"] if self.last is None
                               else self.last)
        return out

    def release(self) -> dict:
        """Free the program and its state; return the answers."""
        answers = self.answers()
        self.prog = self.state = self.a0 = self._snaps = None
        self.forget()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return answers

    def check(self, answers: dict) -> dict:
        return check(self.cell, self.seed, self.step, self.pairs, answers,
                     self.device)


def bench_for(cell: Cell, device, dtype=None):
    """The bench of a cell: ``Solve`` on one card, ``ShardedSolve`` on
    more."""
    return (ShardedSolve if cell.chips > 1 else Solve)(cell, device, dtype)


def check(cell: Cell, seed: int, step: int, pairs: int, answers: dict,
          device) -> dict:
    """Each answer's ``max_rel_err`` against the plain reference, run in
    fp64 on ``device`` from the field of ``seed`` as the benchmark made it."""
    dims, taps = reference.load_stc(cell.stc_path)
    field = field_of(cell.config, dims, seed, device)
    ref = reference.solve(field, taps, step, pairs)
    del field
    return {label: reference.max_rel_err(ans if torch.is_tensor(ans)
                                         else torch.from_numpy(ans), ref)
            for label, ans in answers.items()}


@dataclass
class Window:
    """What a loop did: its requests, the host-clock seconds from its first
    request's issue to the end of its last, and, where requests return their
    result, each one's seconds from its reset being issued to its result
    being in host memory."""

    requests: int
    wall_s: float
    latencies: list


@dataclass
class Context:
    """What a metric's reader reads: the set-up time, the measured window,
    the traced slice, the counts of one request and the card's peaks."""

    setup_s: float
    window: Optional[Window]
    slice: Optional[trace.Slice]
    work: Work
    peaks: Optional[tuple]


def card_line(device, count: int = 1) -> dict:
    """The name and power limit of the ``count`` cards from ``device`` on,
    as ``nvidia-smi`` reads them."""
    index = torch.device(device).index or 0
    line = {"card": torch.cuda.get_device_name(index)}
    cards = ",".join(str(index + i) for i in range(count))
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", cards],
            capture_output=True, text=True, timeout=60)
        line["nvidia_smi"] = "; ".join(
            (proc.stdout.strip() or proc.stderr.strip()).splitlines())
    except (OSError, subprocess.TimeoutExpired) as err:
        line["nvidia_smi"] = f"not read: {err}"
    return line


def _number(x: float):
    return x if math.isfinite(x) else str(x)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float):
    """One run: returns ``(result, check_lines, card)``."""
    bench = bench_for(cell, device)
    bench.load(seed)
    driver = cell.driver()
    mix = cell.traffic
    driver.run(bench, mix, requests=1)      # every shape a request uses
    bench.sync()
    bench.forget()
    setup_s = time.perf_counter() - t_start

    window = driver.run(bench, mix, seconds=seconds)
    attempted = window.requests
    sl = None
    if traced:
        sl = trace.traced_slice(bench, driver, mix, first=attempted)
        attempted += sl.requests
    cuda = bench.device.type == "cuda"
    # the fullest card's peak
    peak = max(torch.cuda.max_memory_allocated(dev)
               for dev in bench.devices) if cuda else 0
    name = torch.cuda.get_device_name(bench.device) if cuda else "cpu"
    work = bench.work()
    ctx = Context(setup_s, window, sl, work, card_peaks(name))
    metrics = {}
    for metric, unit, read in cell.metrics(traced):
        value = read(ctx)
        if value is not None:
            metrics[metric] = {"value": value, "unit": unit}

    errors = bench.check(bench.release())
    limit = cell.limits[CHECKED]
    worst = max(errors.values())
    failed = sum(not e <= limit for e in errors.values())
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if sl is not None:
        device_info["busy_s"] = sl.busy_s()
        device_info["window_s"] = sl.window_s
        result["breakdown"] = sl.breakdown()
    result["checks"] = {CHECKED: {"value": _number(worst), "limit": limit}}
    lines = [f"{label}: {CHECKED} {err!r}" for label, err in errors.items()]
    lines.append(f"{CHECKED} {worst!r} limit {limit!r} "
                 f"({'correct' if failed == 0 else 'NOT correct'})")
    card = (card_line(bench.device, len(bench.devices)) if cuda
            else {"card": name})
    return result, lines, card
