"""The port's hand-written Hopper kernels: build, wrappers, plain versions.

Every build of the TPU streaming kernel ``drstencil_tpu/ops/stream.py:568-803``
has a CUDA kernel here:

- ``stencil2d_levels`` for 2D grids and ``stencil3d_levels`` for 3D grids
  (``row_frame=True``): ``levels`` levels of one tap table applied to the
  interior ``[frame, dim - frame)`` of ``dst``, reading ``src``; a frame
  cell is never written;
- ``stencil2d_levels_shard`` and ``stencil3d_levels_shard``
  (``row_frame=False``, the multi-device path): the same levels on one
  shard's slab with ``frame`` ghost rows on each side of axis 0, storing
  the axis-0 range ``rows`` that the caller derives from the shard's place
  in the mesh; the off-axis frame stays frozen;
- ``stencil2d_factor_levels`` (``factor=True``): ``2 * step`` levels
  alternating the 3x3 tables V1 and V2 of ``ir/factor.py``, where every
  V2 level adds the residual R read from the level two back;
- ``stencil2d_factor_levels_shard`` (``factor=True, row_frame=False``):
  those levels on a shard's slab, storing ``rows`` as the levels' shard
  builds do.

The kernels of the two kernel experiments (``tuning/exp_tile2d.py``,
``tuning/exp_overlap.py``) are fp32 only:

- ``tile2d_fused`` (the TPU kernel ``tuning/exp_tile2d.py:78-89``): the
  step-fused operator applied whole to a ``(R + 2 * tm, C)`` padded state,
  columns wrapping around ``C``, pad rows never written;
- ``overlap_probe`` (``tuning/exp_overlap.py:59-65``): a timing probe,
  ``level(level(window))`` per strip, its windows copied by TMA bulk copies
  completed on ``mbarrier``s, awaited before compute or prefetched one tile
  ahead, in ``csrc/experiments.cu``.

Every kernel but the probe is built PER PLAN: ``ops/codegen`` writes it as
text specialised to one plan — for the levels and factor kernels (grid
dims, storage type, shard, tap tables, levels, reach: ``cuda_source``),
for ``tile2d_fused`` (layout and table: ``tile2d_source``) — streamed
along axis 0, four outputs per thread, every shape a constant, the taps
unrolled; :func:`plan_kernel` compiles it with ``nvcc`` for ``sm_90a``
into ``build/plans/plan_<hash>.so`` at first use (the hash is of text +
flags; a later process finds the library on disk; about 6 s per plan).
:func:`build_plans` compiles many plans at once, one ``nvcc`` each, all
started together; callers that know their plans ahead use it.  A failed
build raises with the compiler's log; nothing falls back.
:func:`plan_counters` counts the plan cache's disk hits, builds and seconds,
the plans it made or found that keep register windows, feed their source
planes by TMA, accumulate partial sums or apply block-fused levels, and the
flops and cell-steps of the levels kernels' launches.

Each streaming kernel runs on float32 and on bfloat16 state: the bf16
build loads as fp32, computes every level in fp32 and rounds once at the
store, as the TPU kernel does with ``dtype="bfloat16"``.

``csrc/experiments.cu`` is compiled like the plans, into one library.
Everything is loaded with ``ctypes`` through a plain C interface.
Each wrapper dispatches on the tensors' device: CPU tensors go to the
plain PyTorch version beside it (``*_ref``), CUDA tensors launch the
kernel or raise.  Each wrapper's ``launches`` counts its kernel's launches
(both dtypes) only; a levels wrapper's ``maps_encoded`` counts the tensor
maps its TMA-fed plans encoded (one a source buffer).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from drstencil_tpu_torch.ops import codegen
from drstencil_tpu_torch.ops.codegen import NVCC_FLAGS, SMEM_LIMIT, is_factor

# Most taps of one level (and of a tile2d table): ``level_plan`` holds
# every plan to it, a bound on the text a plan unrolls.
MAX_TAPS = 256
# Storage dtypes the kernels take, with the suffix of their name in the
# kernel rows and their name in a plan's text.
BUILDS = {torch.float32: "", torch.bfloat16: "_bf16"}
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# nvcc processes :func:`build_plans` runs at once
BUILD_WORKERS = 16
# cells an axis of a levels kernel's grid stays under (:func:`check_grid`)
AXIS_LIMIT = 2**30
# tile2d_fused's tables and layouts, as the experiment makes them: at most
# this many column shifts, and a pad height ``tm`` that is a multiple of
# TILE2D_TM_MULTIPLE (the JAX experiment's 8-row blocks) dividing the data
# rows.  The kernel's geometry depends on neither.
TILE2D_MAX_GROUPS = 64
TILE2D_TM_MULTIPLE = 8
# csrc/experiments.cu's sizes, checked at load: the probe's columns per tile
# and the TPU level's rows per chunk (TM - 2*HK and TM - 4*HK are multiples).
PROBE_TILE = 64
PROBE_CHUNK = 8
# the probe's variants, in the order of the C entry's `variant` argument
PROBE_VARIANTS = ("A", "B", "C")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS_SOURCE = os.path.join(_PKG_DIR, "csrc", "experiments.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
PLAN_DIR = os.path.join(BUILD_DIR, "plans")


@dataclass(frozen=True)
class LevelTaps:
    """What one kernel launch applies: ``levels`` levels of the tap table
    (``offsets`` (n, ndim) int32 sorted with ``coeffs`` (n,) float32), each
    reaching ``reach`` cells, with the frozen frame ``frame`` =
    ``levels * reach`` on every axis.  ``segment`` and ``column`` are the
    CTA's tile where the config names it (``KernelConfig.tm`` / ``ch``;
    ``codegen.geometry``), ``None`` for the generator's choice.  ``block``
    is the timesteps one level advances: 1 for the base table, the block of
    a block-step fused table ``fuse(base, block)`` (K7), the step for the
    one level of the whole coefficient-fused operator (K1); the text does
    not depend on it."""

    offsets: np.ndarray
    coeffs: np.ndarray
    levels: int
    reach: int
    frame: int
    segment: Optional[int] = None
    column: Optional[int] = None
    block: int = 1

    @property
    def ndim(self) -> int:
        return self.offsets.shape[1]

    @property
    def timesteps(self) -> int:
        """Timesteps one launch advances."""
        return self.levels * self.block

    @property
    def block_fused(self) -> bool:
        """Whether the levels, more than one, apply a block-step fused
        operator (``KernelConfig.block > 1``: block-hybrid K7)."""
        return self.block > 1 and self.levels > 1

    def level_flops(self) -> Tuple[int, ...]:
        """Flops one output cell of each level costs: ``2 * taps - 1``."""
        return (2 * len(self.coeffs) - 1,) * self.levels


@dataclass(frozen=True)
class FactorTaps:
    """What one factor-mode launch applies: ``levels`` = 2 * step levels of
    reach ``reach`` = 1 alternating the tables V1 and V2; every V2 level
    adds the residual table R read from the level two back at reach
    ``2 * reach``.  Each table is (offsets (n, 2) int32, coeffs (n,)
    float32) in sorted order; ``frame`` = ``levels * reach``;
    ``segment`` and ``column`` as for ``LevelTaps``."""

    v1: Tuple[np.ndarray, np.ndarray]
    v2: Tuple[np.ndarray, np.ndarray]
    r: Tuple[np.ndarray, np.ndarray]
    levels: int
    reach: int
    frame: int
    segment: Optional[int] = None
    column: Optional[int] = None

    ndim = 2
    block_fused = False

    @property
    def taps_per_step(self) -> int:
        """|V1| + |V2| + |R|: the taps one timestep applies per cell."""
        return sum(len(c) for _, c in (self.v1, self.v2, self.r))

    @property
    def timesteps(self) -> int:
        """Timesteps one launch advances: a V1 and a V2 level each."""
        return self.levels // 2

    def level_flops(self) -> Tuple[int, ...]:
        """Flops one output cell of each level costs: ``2 * |V1| - 1`` on
        a V1 level; on a V2 level its table's and R's chains, joined by one
        add, ``2 * (|V2| + |R|) - 1``."""
        v1 = 2 * len(self.v1[1]) - 1
        v2r = 2 * (len(self.v2[1]) + len(self.r[1])) - 1
        return tuple(v1 if t % 2 else v2r for t in range(1, self.levels + 1))


def sm_count(device=None) -> int:
    """The SMs a plan's segments are chosen to fill: on a CUDA ``device``
    (``None``: the current one, where there is a card) the count the
    device reports; without a card ``codegen.SM_COUNT``, the count of text
    made for no card (the tests, the emulation)."""
    if device is None:
        if not torch.cuda.is_available():
            return codegen.SM_COUNT
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return codegen.SM_COUNT
    return _device_sms(torch.cuda.current_device() if device.index is None
                       else device.index)


@functools.lru_cache(maxsize=None)
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def geometry(taps, dims, sms: Optional[int] = None) -> codegen.Geometry:
    """``codegen.geometry`` of ``taps`` (a ``LevelTaps`` or a
    ``FactorTaps``, with its segment and column) on a grid of ``dims``, for
    ``sms`` SMs (default :func:`sm_count`)."""
    return codegen.geometry(taps, dims, sm_count() if sms is None else sms)


def tile_shape(taps, dims, sms: Optional[int] = None) -> Tuple[int, ...]:
    """Output cells of one CTA of the kernel that runs ``taps`` on a grid
    of ``dims``: ``(SEG, TX)`` / ``(SEG, TY, TX)`` — a segment of axis 0
    and the column it walks (:func:`geometry`)."""
    return geometry(taps, dims, sms).tile


def n_buffers(taps, dims) -> int:
    """fp32 planes (rows in 2D) one CTA keeps in shared memory: a ring per
    level (``codegen.Geometry.ring`` planes), plus the staging rows of a
    plan that copies ahead."""
    return geometry(taps, dims).window_planes


def smem_bytes(taps, dims) -> int:
    """Shared memory of one CTA, fp32 whatever the storage dtype (the
    load converts)."""
    return geometry(taps, dims).smem_bytes


# -- build -------------------------------------------------------------------

class _Library:
    """One compiled kernel library (``source`` -> ``build/<stem>_<hash>
    .so``), built and loaded at first use.  ``check(lib)`` holds the
    source's constants against this module's."""

    def __init__(self, source: str, stem: str, check):
        self.source = source
        self.stem = stem
        self._check = check
        self._lib = None
        self._lock = threading.Lock()
        self.path = None
        self.build_seconds = None
        self.build_log = ""

    def get(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self):
        with open(self.source, encoding="utf-8", newline="") as f:
            digest = codegen.source_hash(f.read())
        self.path = os.path.join(BUILD_DIR, f"{self.stem}_{digest}.so")
        t0 = time.perf_counter()
        if not os.path.exists(self.path):
            self.build_log = _run_nvcc(self.source, self.path)
        self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(self.path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for kernel in KERNELS:
            if kernel.library is not self:
                continue
            for entry, argtypes in kernel.c_entries(ptr, i32).items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = i32
        self._check(lib)
        return lib


def _check_experiments(lib) -> None:
    lib.experiments_limit.argtypes = [ctypes.c_int]
    lib.experiments_limit.restype = ctypes.c_int
    lib.experiments_error_string.argtypes = [ctypes.c_int]
    lib.experiments_error_string.restype = ctypes.c_char_p
    want = (PROBE_TILE, PROBE_CHUNK)
    got = tuple(lib.experiments_limit(i) for i in range(len(want)))
    if got != want:
        raise RuntimeError(f"experiments.cu limits {got} disagree with "
                           f"kernels.py {want}")


def _run_nvcc(source: str, out: str) -> str:
    """Compile ``source`` into the shared library ``out`` (written whole:
    another process never sees half of it); returns the compiler's log,
    raises with it on failure."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                           f"{log}")
    os.replace(tmp, out)
    return log


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


EXPERIMENTS = _Library(EXPERIMENTS_SOURCE, "libexperiments",
                       _check_experiments)


def build():
    """Build (or find) and load the ``.cu`` library; returns
    ``(EXPERIMENTS,)``, with its ``build_seconds``, ``path`` and the
    compiler's ``build_log``."""
    EXPERIMENTS.get()
    return (EXPERIMENTS,)


# -- the per-plan kernels -------------------------------------------------------

class LaunchWork:
    """The arithmetic of one launch of a levels or factor plan, from its
    ``codegen.Geometry``: the flops of every cell its levels compute,
    trapezoid recompute included, and the cell-steps it stores (the
    counters ``flops`` and ``cell_steps``).  In a segment of ``n0`` stored
    rows (planes) of axis 0, level ``t`` computes the rows ``[t * reach,
    n0 + 2 * frame - t * reach)`` of the segment's window (a factor plan's
    V2 levels below the last one row more, ``Geometry.tail``), each row
    the plane cells of ``Geometry.level_region(t)``, in every column of the
    grid; a cell costs its level's ``level_flops``.  ``whole`` is the
    counts of a launch that stores the whole interior."""

    def __init__(self, taps, g: codegen.Geometry):
        H, r, L = g.frame, g.reach, g.levels
        self._segment = g.tile[0]
        self._per_row = self._per_segment = 0
        for t, flops in enumerate(taps.level_flops(), 1):
            _, rows, _, quads = g.level_region(t)
            cells = flops * g.n_columns * rows * codegen.QUAD * quads
            past = g.tail if g.factor and t % 2 == 0 and t < L else 0
            self._per_row += cells
            self._per_segment += cells * (2 * H - 2 * t * r + past)
        self._stored = taps.timesteps * math.prod(
            d - 2 * H for d in g.dims[1:])
        self.whole = self.counts(g.interior)

    def counts(self, rows: int) -> Tuple[int, int]:
        """``(flops, cell_steps)`` of a launch that stores ``rows`` rows
        (planes) of axis 0, cut into segments of ``Geometry.tile[0]``."""
        segments = -(-rows // self._segment)
        return (rows * self._per_row + segments * self._per_segment,
                rows * self._stored)


class PlanKernel:
    """One plan's kernel: its text, its geometry (``codegen.Geometry``, or
    ``codegen.TileGeometry`` for ``tile2d_fused``), where its library lies,
    and, once loaded, its ``launch``.  ``build_log`` is what nvcc printed
    when the library was built (kept beside it, so a later process reads
    it too); ``build_seconds`` is None when the library was found on
    disk.  ``work`` is a levels or factor plan's :class:`LaunchWork` (made
    from ``taps``; None for ``tile2d_fused``), ``block_fused`` whether its
    levels apply a block-step fused operator."""

    def __init__(self, text: str, geometry, shard: bool, taps=None):
        self.text = text
        self.geometry = geometry
        self.shard = shard
        self.work = None if taps is None else LaunchWork(taps, geometry)
        self.block_fused = bool(getattr(taps, "block_fused", False))
        self.stem = "plan_" + codegen.source_hash(text)
        stem = os.path.join(PLAN_DIR, self.stem)
        self.path, self.source, self.log_path = (stem + ".so", stem + ".cu",
                                                 stem + ".log")
        self.build_log = ""
        self.build_seconds = None
        self._lib = None

    @property
    def built(self) -> bool:
        return os.path.exists(self.path)

    def compile(self) -> None:
        """Run nvcc on the text (one process; raises with its log)."""
        t0 = time.perf_counter()
        os.makedirs(PLAN_DIR, exist_ok=True)
        tmp = f"{self.source}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(self.text)
        os.replace(tmp, self.source)
        self.build_log = _run_nvcc(self.source, self.path)
        with open(self.log_path, "w") as f:
            f.write(self.build_log)
        self.build_seconds = time.perf_counter() - t0
        _COUNTERS.add(builds=1)

    def load(self) -> "PlanKernel":
        if self._lib is None:
            if not self.built:
                self.compile()
            else:
                if self.build_seconds is None:  # not built by this object
                    _COUNTERS.add(disk_hits=1)
                if not self.build_log and os.path.exists(self.log_path):
                    with open(self.log_path) as f:
                        self.build_log = f.read()
            if getattr(self.geometry, "window", False):
                _COUNTERS.add(**{f"windowed_{self.geometry.ndim}d": 1})
            if getattr(self.geometry, "partial", False):
                _COUNTERS.add(partial_2d=1)
            if self.tma:
                _COUNTERS.add(**{f"tma_{self.geometry.ndim}d": 1})
            if self.block_fused:
                _COUNTERS.add(block_fused=1)
            lib = ctypes.CDLL(self.path)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.launch.argtypes = ([ptr, ptr] + [i32] * (2 * self.shard)
                                   + [ptr])
            lib.launch.restype = i32
            lib.error_string.argtypes = [i32]
            lib.error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self

    @property
    def tma(self) -> bool:
        """Whether the text feeds its source planes by TMA
        (``codegen.Geometry.tma``)."""
        return getattr(self.geometry, "tma", False)

    def maps_encoded(self) -> int:
        """Tensor maps the loaded library has encoded in this process, one
        a source buffer it has launched on (0 for a text without TMA)."""
        if not (self.tma and self._lib):
            return 0
        count = self._lib.maps_encoded
        count.restype = ctypes.c_longlong
        return int(count())

    def launch(self, src_ptr: int, dst_ptr: int, store, stream: int) -> None:
        """Launch on the buffers at ``src_ptr`` and ``dst_ptr``, storing the
        axis-0 range ``store`` (a shard build's ``(lo, hi)``, else ``()``);
        a levels or factor plan adds its :class:`LaunchWork` to the
        counters."""
        err = self._lib.launch(src_ptr, dst_ptr, *store, stream)
        if err:
            raise RuntimeError("plan kernel launch failed: "
                               + self._lib.error_string(err).decode())
        if self.work is not None:
            _COUNTERS.add_launch(*(self.work.counts(store[1] - store[0])
                                   if store else self.work.whole))

    def ctas_per_sm(self):
        """CTAs an SM holds of this build by its registers (the ``ptxas``
        log: 256-register blocks per warp of a 64K file), threads and
        shared memory (``geometry.ctas_per_sm``): an occupancy model, None
        where there is no log."""
        regs = self.ptxas().get("registers")
        if not regs:
            return None
        per_warp = -(-regs * 32 // 256) * 256
        by_regs = 65536 // (per_warp * (self.geometry.threads // 32))
        return min(by_regs, self.geometry.ctas_per_sm)

    def ptxas(self) -> dict:
        """Registers per thread and spilled bytes from the build's
        ``-Xptxas -v`` log (empty where there is no log)."""
        regs = re.findall(r"Used (\d+) registers", self.build_log)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", self.build_log)
        if not regs:
            return {}
        return {"registers": max(map(int, regs)),
                "spill_bytes": max(int(a) + int(b) for a, b in spills)
                if spills else 0}


class _PlanCounters:
    """The plan cache's counters (:func:`plan_counters`), safe across the
    threads of :func:`build_plans`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0     # plan_kernel / build_plans calls under way
        self._t0 = 0.0
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._counts = {"disk_hits": 0, "builds": 0, "plan_s": 0.0,
                            "windowed_2d": 0, "windowed_3d": 0, "tma_2d": 0,
                            "tma_3d": 0, "partial_2d": 0, "block_fused": 0,
                            "flops": 0, "cell_steps": 0}

    def add(self, **by) -> None:
        with self._lock:
            for key, value in by.items():
                self._counts[key] += value

    def add_launch(self, flops: int, cell_steps: int) -> None:
        """Add one launch's :class:`LaunchWork`: two sums under the lock,
        without :meth:`add`'s keyword arguments, since it runs on every
        launch."""
        with self._lock:
            self._counts["flops"] += flops
            self._counts["cell_steps"] += cell_steps

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)

    @contextlib.contextmanager
    def timed(self):
        """Add the wall seconds of the outermost timed call to ``plan_s``
        (a context, or a decorator): calls nested in it or overlapping it
        in another thread add only the time during which none was under
        way."""
        with self._lock:
            if self._depth == 0:
                self._t0 = time.perf_counter()
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    self._counts["plan_s"] += time.perf_counter() - self._t0


_COUNTERS = _PlanCounters()


def plan_counters() -> dict:
    """A copy of the plan cache's counters since the process started (or
    :func:`reset_plan_counters`): ``disk_hits``, libraries found in
    ``build/plans``; ``builds``, compiles (text written, ``nvcc``, log);
    ``plan_s``, wall seconds inside :func:`plan_kernel` and
    :func:`build_plans` (text, hash, ``nvcc``, ``dlopen``), each second
    counted once; ``windowed_2d`` and ``windowed_3d``, the plans of those
    builds and disk hits whose geometry keeps register windows
    (``codegen.Geometry.window``); ``tma_2d`` and ``tma_3d``, those whose
    text feeds its source rows or planes by TMA (``codegen.Geometry.tma``);
    ``partial_2d``, those
    whose text accumulates partial sums (``codegen.Geometry.partial``);
    ``block_fused``, those whose levels apply a block-step fused operator
    (``LevelTaps.block_fused``: ``KernelConfig.block > 1``).  Summed over
    the levels kernels' launches on CUDA tensors (never the plain versions'
    calls): ``flops``, the arithmetic of the cells their levels computed,
    trapezoid recompute included, and ``cell_steps``, the cells they stored
    times the timesteps they advanced (:class:`LaunchWork`)."""
    return _COUNTERS.snapshot()


def reset_plan_counters() -> None:
    _COUNTERS.reset()


_PLANS: dict = {}
_PLANS_LOCK = threading.Lock()


def plan_key(taps, dims, dtype, shard: bool = False,
             sms: Optional[int] = None) -> tuple:
    """What a plan's kernel is specialised to (``taps`` a ``LevelTaps`` or
    a ``FactorTaps``): grid, storage type, shard, tables, levels, reach,
    the asked segment and column, the timesteps a launch advances (which
    its counters read and its text does not) and the SM count (default
    :func:`sm_count`)."""
    tables = ((taps.v1, taps.v2, taps.r) if is_factor(taps)
              else ((taps.offsets, taps.coeffs),))
    return (len(dims), tuple(int(d) for d in dims),
            DTYPE_NAMES.get(dtype, dtype), bool(shard),
            *(b for offsets, coeffs in tables for b in (
                np.ascontiguousarray(offsets, dtype=np.int32).tobytes(),
                np.ascontiguousarray(coeffs, dtype=np.float32).tobytes())),
            int(taps.levels), int(taps.reach), taps.segment, taps.column,
            int(taps.timesteps), sm_count() if sms is None else int(sms))


def _plan(key, make) -> PlanKernel:
    """The :class:`PlanKernel` of ``key``, made by ``make()`` at first."""
    with _PLANS_LOCK:
        if key not in _PLANS:
            _PLANS[key] = make()
        return _PLANS[key]


def plan_of(taps, dims, dtype, shard: bool,
            sms: Optional[int] = None) -> PlanKernel:
    """The (possibly unbuilt) :class:`PlanKernel` of one key."""
    key = plan_key(taps, dims, dtype, shard, sms)
    return _plan(key, lambda: PlanKernel(
        codegen.cuda_source(taps, key[1], key[2], key[3], sms=key[-1]),
        codegen.geometry(taps, key[1], key[-1]), key[3], taps))


def tile2d_plan(taps: "Tile2dTaps", shape, tm: int,
                sms: Optional[int] = None) -> PlanKernel:
    """The (possibly unbuilt) ``tile2d_fused`` kernel of ``taps`` on a
    ``(R + 2 * tm, C)`` padded layout of ``shape`` for ``sms`` SMs
    (default :func:`sm_count`)."""
    rows, cols = int(shape[0]) - 2 * tm, int(shape[1])
    sms = sm_count() if sms is None else int(sms)
    key = ("tile2d", rows, cols, tm, taps.groups, taps.halo, sms)
    return _plan(key, lambda: PlanKernel(
        codegen.tile2d_source(taps, rows, cols, tm, sms=sms),
        codegen.tile2d_geometry(taps, rows, cols, tm, sms), False))


@_COUNTERS.timed()
def plan_kernel(taps, dims, dtype, shard: bool = False,
                sms: Optional[int] = None) -> PlanKernel:
    """The loaded kernel of ``taps`` on a grid (a ghosted slab with
    ``shard``) of ``dims`` in ``dtype`` (a torch dtype or its name) for
    ``sms`` SMs (default :func:`sm_count`: the current card's), built by
    nvcc unless its library is on disk."""
    return plan_of(taps, dims, dtype, shard, sms).load()


@_COUNTERS.timed()
def build_plans(requests) -> list:
    """Build and load the kernels of many plans, each request a
    :class:`PlanKernel` (e.g. :func:`tile2d_plan`'s) or a ``(taps, dims,
    dtype, shard[, sms])`` tuple (for the current card's SM count where
    ``sms`` is left out): one nvcc per missing library, up to
    ``BUILD_WORKERS`` at once.  Every build is tried; the first failure is
    raised afterwards.  Returns the :class:`PlanKernel` of each request."""
    plans = [r if isinstance(r, PlanKernel) else plan_of(*r)
             for r in requests]
    todo = list({p.path: p for p in plans if not p.built}.values())
    errors = []

    def compile_one(plan):
        try:
            plan.compile()
        except Exception as e:      # re-raised below, in the caller's thread
            errors.append(e)

    if todo:
        with ThreadPoolExecutor(max_workers=BUILD_WORKERS) as pool:
            list(pool.map(compile_one, todo))
    if errors:
        raise errors[0]
    return [p.load() for p in plans]


# -- plain versions ----------------------------------------------------------

def _valid_level(cur: torch.Tensor, table, reach: int,
                 shrink: int) -> torch.Tensor:
    """One 'valid' shifted-slice sum (taps in table order) of ``cur``: the
    result is ``shrink`` cells smaller on every side, ``shrink >= reach``."""
    offsets, coeffs = table
    inner = [s - 2 * shrink for s in cur.shape]
    acc = None
    for off, coe in zip(offsets.tolist(), coeffs.tolist()):
        sl = cur[tuple(slice(shrink + o, shrink + o + n)
                       for o, n in zip(off, inner))]
        term = coe * sl
        acc = term if acc is None else acc + term
    return acc


def _store(cur: torch.Tensor, dst: torch.Tensor, frame: int,
           rows=None) -> torch.Tensor:
    """Copy ``cur`` (``dst``'s shape, fp32) into ``dst`` over ``rows`` of
    axis 0 (default ``[frame, dim - frame)``) and the interior of the other
    axes, rounded to ``dst``'s dtype."""
    lo, hi = rows if rows is not None else (frame, dst.shape[0] - frame)
    region = (slice(lo, max(lo, hi)),) + tuple(
        slice(frame, s - frame) for s in dst.shape[1:])
    dst[region] = cur[region].to(dst.dtype)
    return dst


def _levels_ref(src: torch.Tensor, dst: torch.Tensor, taps: LevelTaps,
                rows=None) -> torch.Tensor:
    """Zero-pad ``src`` by ``frame``, apply ``levels`` 'valid' shifted-slice
    sums in fp32 (taps in table order), copy the stored region into ``dst``.

    The plain version of both builds: a bfloat16 ``src`` is upcast to
    fp32, every level stays fp32, and the result is rounded to ``dst``'s
    dtype once at the copy (round to nearest even), as the bf16 kernel
    does."""
    H, r = taps.frame, taps.reach
    cur = F.pad(src.to(torch.float32), (H,) * (2 * src.dim()))
    for _ in range(taps.levels):
        cur = _valid_level(cur, (taps.offsets, taps.coeffs), r, r)
    return _store(cur, dst, H, rows)


def stencil2d_levels_ref(src, dst, taps: LevelTaps):
    """Plain PyTorch version of ``stencil2d_levels``."""
    return _levels_ref(src, dst, taps)


def stencil3d_levels_ref(src, dst, taps: LevelTaps):
    """Plain PyTorch version of ``stencil3d_levels``."""
    return _levels_ref(src, dst, taps)


def stencil2d_levels_shard_ref(src, dst, taps: LevelTaps, rows):
    """Plain PyTorch version of ``stencil2d_levels_shard``: ``src`` and
    ``dst`` are slabs with ``frame`` ghost rows on each side of axis 0."""
    return _levels_ref(src, dst, taps, rows)


def stencil3d_levels_shard_ref(src, dst, taps: LevelTaps, rows):
    """Plain PyTorch version of ``stencil3d_levels_shard``."""
    return _levels_ref(src, dst, taps, rows)


def stencil2d_factor_levels_ref(src, dst, taps: FactorTaps, rows=None):
    """Plain PyTorch version of ``stencil2d_factor_levels``: level t is V1
    of level t-1 for odd t, and V2 of level t-1 plus R of level t-2 (two
    reaches wider on every side) for even t; fp32 levels, one rounding.
    ``rows`` is the stored range of axis 0 (default the interior)."""
    H, r = taps.frame, taps.reach
    prev = None
    cur = F.pad(src.to(torch.float32), (H,) * 4)
    for t in range(1, taps.levels + 1):
        if t % 2:
            nxt = _valid_level(cur, taps.v1, r, r)
        else:
            nxt = (_valid_level(cur, taps.v2, r, r)
                   + _valid_level(prev, taps.r, 2 * r, 2 * r))
        prev, cur = cur, nxt
    return _store(cur, dst, H, rows)


def stencil2d_factor_levels_shard_ref(src, dst, taps: FactorTaps, rows):
    """Plain PyTorch version of ``stencil2d_factor_levels_shard``: the same
    levels on a slab with ``frame`` ghost rows on each side of axis 0,
    stored over ``rows``."""
    return stencil2d_factor_levels_ref(src, dst, taps, rows)


# -- the kernel experiments: plain versions ----------------------------------

@dataclass(frozen=True)
class Tile2dTaps:
    """A fused 2D operator grouped by column shift, as
    ``tuning/exp_tile2d.py`` groups it: ``groups`` is ``((dj, ((di, coef),
    ...)), ...)`` ascending in ``dj`` and, within a group, in ``di``;
    ``halo`` bounds every ``|di|`` and ``|dj|``."""

    groups: tuple
    halo: int

    @property
    def ntaps(self) -> int:
        return sum(len(rows) for _, rows in self.groups)


def tile2d_taps(fused, halo: int) -> Tile2dTaps:
    """Group the tap map ``fused`` ({(di, dj): coef}) by column shift."""
    by_dj: dict = {}
    for (di, dj), c in sorted(fused.items()):
        by_dj.setdefault(dj, []).append((di, float(c)))
    groups = tuple((dj, tuple(rows)) for dj, rows in sorted(by_dj.items()))
    return Tile2dTaps(groups=groups, halo=int(halo))


def tile2d_fused_ref(src: torch.Tensor, dst: torch.Tensor, taps: Tile2dTaps,
                     tm: int) -> torch.Tensor:
    """Plain PyTorch version of ``tile2d_fused``: the arithmetic of
    ``tuning/exp_tile2d.py:78-89`` on the whole data block at once, a row
    pre-sum per column shift and one ``torch.roll`` (which wraps) each,
    summed in ascending ``dj``.  Writes data rows ``[tm, tm + R)`` only."""
    R = src.shape[0] - 2 * tm
    acc = None
    for dj, rows in taps.groups:
        t = None
        for di, c in rows:
            term = c * src[tm + di:tm + di + R, :]
            t = term if t is None else t + term
        if dj:
            t = torch.roll(t, -dj, dims=1)
        acc = t if acc is None else acc + t
    dst[tm:tm + R] = acc
    return dst


def probe_level_ref(x: torch.Tensor, n: int) -> torch.Tensor:
    """One level of ``tuning/exp_overlap.py:35-55`` on rows ``[0, n)`` of
    ``x`` (..., rows >= n + 4, N): 5 shifted row slices, pre-sums, three
    weighted combinations, four column rolls that wrap, in its order."""
    rows = [x[..., d:d + n, :] for d in range(5)]
    p2 = rows[0] + rows[4]
    p1 = rows[1] + rows[3]
    p0 = rows[2]
    inners = [
        0.02 * p2 + 0.05 * p1 + 0.1 * p0,
        0.05 * p2 + 0.1 * p1 + 0.2 * p0,
        0.1 * p2 + 0.2 * p1 + 0.3 * p0,
    ]
    acc = inners[2]
    for s, inner in ((1, inners[1]), (2, inners[0])):
        acc = acc + torch.roll(inner, -s, dims=-1)
        acc = acc + torch.roll(inner, s, dims=-1)
    return acc


def overlap_probe_ref(x: torch.Tensor, out: torch.Tensor, variant: str,
                      tm: int, hk: int, n_ctas: int):
    """Plain PyTorch version of ``overlap_probe``: per ``tm``-row strip,
    two levels on the strip's window, written to rows ``[0, tm - 4 * hk)``
    of the strip's output block; every other row of ``out`` is left as it
    is.  Strip ``i``'s window starts at row ``i * tm`` of ``x`` in every
    variant, and the levels read only its first ``tm - 4 * hk + 8`` rows,
    so A (``x`` of R rows) and B/C (R + 2 * hk rows) run the same code.
    Returns ``(out, carry)``: for variant C the ``(n_ctas, hk, PROBE_TILE)``
    carry each CTA holds after its last tile (half of the first ``hk`` rows
    of that tile's window), else ``None``."""
    R, N = out.shape
    n_strips = R // tm
    win = x[:n_strips * tm].view(n_strips, tm, N)
    lvl = probe_level_ref(probe_level_ref(win, tm - 2 * hk), tm - 4 * hk)
    out[:n_strips * tm].view(n_strips, tm, N)[:, :tm - 4 * hk] = lvl
    if variant != "C":
        return out, None
    n_ctiles = N // PROBE_TILE
    ntiles = n_strips * n_ctiles
    carry = torch.empty((n_ctas, hk, PROBE_TILE), dtype=x.dtype,
                        device=x.device)
    for cta in range(n_ctas):
        last = cta + (ntiles - 1 - cta) // n_ctas * n_ctas
        strip, ct = divmod(last, n_ctiles)
        carry[cta] = win[strip, :hk,
                         ct * PROBE_TILE:(ct + 1) * PROBE_TILE] * 0.5
    return out, carry


# -- wrappers ----------------------------------------------------------------

def check_grid(name: str, src: torch.Tensor) -> None:
    """Refuse a grid (or ghosted slab) ``src`` that ``codegen.cuda_source``'s
    text cannot index; reads only ``src.shape``, so a meta tensor will do.
    The text widens every global address to ``size_t`` before its first
    product with an extent, so the grid's cell count has no limit.  It
    holds in ``int`` the positions along each axis, of which it adds two (a
    segment's end ``a0 + SEG``), so each axis must stay under
    ``AXIS_LIMIT``.  (A CTA's staged plane, whose quads it also indexes in
    ``int``, is held far below ``2**31`` by ``codegen.geometry``'s shared
    memory limit.)"""
    for axis, d in enumerate(int(d) for d in src.shape):
        if d >= AXIS_LIMIT:
            raise ValueError(f"{name}: axis {axis} of {d} cells; the kernel "
                             f"holds positions in int, under {AXIS_LIMIT} "
                             "an axis")


class LevelsKernel:
    """Wrapper of one levels kernel: ``kernel(src, dst, taps)`` writes the
    interior of ``dst`` in place and returns it.  ``src`` and ``dst``
    share one dtype of ``BUILDS``.  On CUDA tensors it launches the
    per-plan kernel (:func:`plan_kernel`, built at first use) on a grid
    that :func:`check_grid` admits; ``launches``
    counts those launches in both dtypes (never the plain version's calls).

    A shard-local kernel (``shard=True``) is called as ``kernel(src, dst,
    taps, rows)``: ``src`` and ``dst`` are one shard's slabs and ``rows`` is
    the ``(lo, hi)`` range of axis 0 it stores, within ``[frame, dim -
    frame)``; everything outside it keeps ``dst``'s value."""

    route = "cuda"
    source = "drstencil_tpu_torch/ops/codegen.py"
    library = None
    taps_type = LevelTaps

    def __init__(self, name: str, ndim: int, plain, replaces: str,
                 shard: bool = False):
        self.name = name
        self.ndim = ndim
        self.plain = plain
        self.replaces = replaces
        self.shard = shard
        self.launches = 0
        # (id(taps), shape, dtype, device) -> (taps, its loaded
        # PlanKernel): a launch does not key the plan again; holding
        # ``taps`` keeps its id
        self._plans: dict = {}

    @property
    def maps_encoded(self) -> int:
        """Tensor maps encoded by the TMA-fed plans this wrapper has
        launched, counted by their C entries: one a source buffer, so two a
        ping-pong pair however many launches (each plan's library counts
        once, whichever wrappers share it)."""
        plans = {id(p): p for _, p in self._plans.values()}
        return sum(p.maps_encoded() for p in plans.values())

    def _launch(self, src, dst, taps, store, stream) -> None:
        """Launch on ``src``'s device, which is the current one: the plan is
        built for its SM count."""
        key = (id(taps), tuple(src.shape), src.dtype, src.device)
        hit = self._plans.get(key)
        if hit is None or hit[0] is not taps:
            check_grid(self.name, src)
            hit = self._plans[key] = (taps, plan_kernel(
                taps, src.shape, src.dtype, self.shard))
        plan = hit[1]
        if plan.geometry.vec and (src.data_ptr() % 16 or dst.data_ptr() % 16):
            raise ValueError(f"{self.name} reads and writes 16-byte quads: "
                             "src and dst must be 16-byte aligned")
        plan.launch(src.data_ptr(), dst.data_ptr(), store, stream)

    def __call__(self, src: torch.Tensor, dst: torch.Tensor, taps,
                 rows=None) -> torch.Tensor:
        if (not isinstance(taps, self.taps_type) or taps.ndim != self.ndim
                or src.dim() != self.ndim):
            raise ValueError(
                f"{self.name} takes {self.ndim}D grids and "
                f"{self.taps_type.__name__} tables, got a {src.dim()}D grid "
                f"and a {getattr(taps, 'ndim', '?')}D "
                f"{type(taps).__name__}")
        if src.shape != dst.shape:
            raise ValueError(f"src {tuple(src.shape)} and dst "
                             f"{tuple(dst.shape)} differ in shape")
        if src.dtype != dst.dtype or src.dtype not in BUILDS:
            raise TypeError(f"{self.name} takes src and dst of one dtype in "
                            f"{[str(d) for d in BUILDS]}, got {src.dtype} "
                            f"and {dst.dtype}")
        store = ()  # a shard kernel's (lo, hi), as passed on
        if self.shard:
            lo, hi = (int(v) for v in rows)
            if lo < taps.frame or hi > src.shape[0] - taps.frame:
                raise ValueError(
                    f"{self.name}: rows [{lo}, {hi}) reach into the "
                    f"{taps.frame} ghost rows of a slab of {src.shape[0]}")
            store = (lo, hi)
        elif rows is not None:
            raise ValueError(f"{self.name} takes no rows: it stores the "
                             "whole interior")
        if src.device.type == "cpu" and dst.device.type == "cpu":
            return self.plain(src, dst, taps, *([store] if self.shard else []))
        if src.device.type != "cuda" or src.device != dst.device:
            raise ValueError(f"{self.name} needs src and dst on one CUDA "
                             f"device, got {src.device} and {dst.device}")
        if not (src.is_contiguous() and dst.is_contiguous()):
            raise ValueError(f"{self.name} needs contiguous tensors")
        if src.untyped_storage().data_ptr() == dst.untyped_storage().data_ptr():
            raise ValueError(f"{self.name}: src and dst share storage")
        if self.shard and store[0] >= store[1]:
            return dst      # nothing to store: no kernel runs, none is counted
        with torch.cuda.device(src.device):
            self._launch(src, dst, taps, store,
                         torch.cuda.current_stream().cuda_stream)
        self.launches += 1
        return dst


class FactorLevelsKernel(LevelsKernel):
    """Wrapper of the factor-mode kernel: ``taps`` is a ``FactorTaps``;
    the kernel is ``codegen.cuda_source``'s text for it, built per plan."""

    taps_type = FactorTaps


def _check_fp32_pair(name: str, x: torch.Tensor, y: torch.Tensor) -> bool:
    """Checks shared by the experiments' wrappers; True when both tensors
    lie on the CPU (the plain version's case)."""
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 tensors, got {x.dtype} and "
                        f"{y.dtype}")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return True
    if x.device.type != "cuda" or x.device != y.device:
        raise ValueError(f"{name} needs both tensors on one CUDA device, "
                         f"got {x.device} and {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    if x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr():
        raise ValueError(f"{name}: input and output share storage")
    if max(x.numel(), y.numel()) >= 2**31:
        raise ValueError(f"{name}: more cells than the kernel's int indexing")
    return False


def _launch_error(name: str, err: int) -> RuntimeError:
    lib = EXPERIMENTS.get()
    return RuntimeError(f"{name} launch failed: "
                        f"{lib.experiments_error_string(err).decode()}")


class Tile2dKernel:
    """Wrapper of ``tile2d_fused``: ``kernel(src, dst, taps, tm)`` applies
    the fused operator ``taps`` (a ``Tile2dTaps``) to the data rows of the
    ``(R + 2 * tm, C)`` fp32 buffer ``src`` and writes data rows ``[tm, tm +
    R)`` of ``dst`` in place; pad rows keep ``dst``'s bits.  ``tm`` is the
    pad height of the layout: a multiple of ``TILE2D_TM_MULTIPLE`` that
    divides ``R``, with ``halo <= tm``.  On CUDA tensors it launches
    ``codegen.tile2d_source``'s text for (layout, table), built per plan
    (:func:`tile2d_plan`); ``launches`` counts those launches."""

    name = "tile2d_fused"
    route = "cuda"
    source = "drstencil_tpu_torch/ops/codegen.py"
    replaces = "tuning/exp_tile2d.py:78"
    library = None
    plain = staticmethod(tile2d_fused_ref)

    def __init__(self):
        self.launches = 0
        # (id(taps), shape, tm, device) -> (taps, its loaded PlanKernel)
        self._plans: dict = {}

    def __call__(self, src: torch.Tensor, dst: torch.Tensor, taps: Tile2dTaps,
                 tm: int) -> torch.Tensor:
        if src.dim() != 2 or src.shape != dst.shape:
            raise ValueError(f"{self.name} takes two 2D buffers of one "
                             f"shape, got {tuple(src.shape)} and "
                             f"{tuple(dst.shape)}")
        R, C = src.shape[0] - 2 * tm, src.shape[1]
        if (tm < 1 or tm % TILE2D_TM_MULTIPLE or R < tm or R % tm
                or taps.halo > tm):
            raise ValueError(
                f"{self.name}: tm={tm} must be a multiple of "
                f"{TILE2D_TM_MULTIPLE} that divides the {R} data rows "
                f"and is at least the halo {taps.halo}")
        if len(taps.groups) > TILE2D_MAX_GROUPS or taps.ntaps > MAX_TAPS:
            raise ValueError(
                f"{self.name}: {taps.ntaps} taps in {len(taps.groups)} column "
                f"shifts exceed the table of {MAX_TAPS} in "
                f"{TILE2D_MAX_GROUPS}")
        if _check_fp32_pair(self.name, src, dst):
            return self.plain(src, dst, taps, tm)
        key = (id(taps), tuple(src.shape), tm, src.device)
        hit = self._plans.get(key)
        if hit is None or hit[0] is not taps:
            hit = self._plans[key] = (taps, tile2d_plan(
                taps, src.shape, tm, sm_count(src.device)).load())
        plan = hit[1]
        if plan.geometry.vec and (src.data_ptr() % 16 or dst.data_ptr() % 16):
            raise ValueError(f"{self.name} reads and writes 16-byte quads: "
                             "src and dst must be 16-byte aligned")
        with torch.cuda.device(src.device):
            plan.launch(src.data_ptr(), dst.data_ptr(), (),
                        torch.cuda.current_stream().cuda_stream)
        self.launches += 1
        return dst


class OverlapProbeKernel:
    """Wrapper of ``overlap_probe``: ``kernel(x, out, variant, depth, tm,
    hk)`` returns ``(out, carry)``.  ``x`` is ``(R, N)`` for variant A and
    ``(R + 2 * hk, N)`` for B and C, ``out`` is ``(R, N)``, both fp32; rows
    ``[0, tm - 4 * hk)`` of each ``tm``-row block of ``out`` are written,
    the rest keeps its bits.  ``depth`` 1 copies each window by TMA and
    waits for it before compute, 2 copies the next tile's window while this
    one computes; ``load=False`` skips the copies (a compute-only timing,
    the output then means nothing).  ``carry`` is variant C's ``(n_ctas,
    hk, PROBE_TILE)`` buffer, else ``None``."""

    name = "overlap_probe"
    route = "cuda"
    source = "drstencil_tpu_torch/csrc/experiments.cu"
    replaces = "tuning/exp_overlap.py:59"
    library = EXPERIMENTS
    plain = staticmethod(overlap_probe_ref)

    def __init__(self):
        self.launches = 0
        # (device index, variant, depth, load, tm, hk) -> info()
        self._info: dict = {}

    def c_entries(self, ptr, i32):
        """``overlap_probe``: in, out, carry, R, N, TM, HK, variant,
        depth, load, the CTAs, the stream; ``overlap_probe_info``: variant,
        depth, load, TM, HK, an int[4] it fills."""
        return {self.name: [ptr, ptr, ptr] + [i32] * 8 + [ptr],
                "overlap_probe_info": [i32] * 5 + [ptr]}

    @staticmethod
    def smem_bytes(variant: str, depth: int, tm: int, hk: int) -> int:
        """Shared memory of one CTA: four barriers, ``depth`` windows, the
        level-1 rows and the carry."""
        wrows = tm if variant == "A" else tm + 2 * hk
        return 32 + 4 * (depth * wrows * (PROBE_TILE + 8)
                         + (tm - 2 * hk) * (PROBE_TILE + 4)
                         + hk * PROBE_TILE)

    def info(self, device, variant: str, depth: int, tm: int, hk: int,
             load: bool = True) -> dict:
        """What the instantiation takes on ``device``'s card, from the
        runtime: CTAs per SM (registers and shared memory both counted),
        registers and local (spill) bytes per thread, shared memory per
        CTA."""
        key = (device.index, variant, depth, bool(load), tm, hk)
        if key not in self._info:
            lib = EXPERIMENTS.get()
            got = (ctypes.c_int * 4)()
            with torch.cuda.device(device):
                err = lib.overlap_probe_info(PROBE_VARIANTS.index(variant),
                                             depth, int(load), tm, hk, got)
            if err:
                raise _launch_error(self.name, err)
            self._info[key] = {"ctas_per_sm": got[0], "regs": got[1],
                               "smem_bytes": got[2], "spill_bytes": got[3]}
        return self._info[key]

    def n_ctas(self, device, shape, variant: str, depth: int, tm: int,
               hk: int, load: bool = True) -> int:
        """Persistent CTAs of one launch: as many as the runtime's
        occupancy puts on the card's SMs, at most one per tile."""
        R, N = shape
        ntiles = (R // tm) * (N // PROBE_TILE)
        if device.type != "cuda":
            return min(ntiles, 132)
        per_sm = self.info(device, variant, depth, tm, hk, load)["ctas_per_sm"]
        if per_sm < 1:
            raise ValueError(f"{self.name}: tm={tm} hk={hk} depth={depth} "
                             "fit no CTA on an SM")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return min(ntiles, sms * per_sm)

    def __call__(self, x: torch.Tensor, out: torch.Tensor, variant: str,
                 depth: int = 2, tm: int = 96, hk: int = 8,
                 load: bool = True):
        if variant not in PROBE_VARIANTS or depth not in (1, 2):
            raise ValueError(f"{self.name}: variant {variant!r} of "
                             f"{PROBE_VARIANTS}, depth {depth} of (1, 2)")
        if out.dim() != 2 or x.dim() != 2:
            raise ValueError(f"{self.name} takes 2D tensors")
        R, N = out.shape
        if (hk < 2 or tm <= 4 * hk or (tm - 2 * hk) % PROBE_CHUNK
                or (tm - 4 * hk) % PROBE_CHUNK or R < tm
                or N < PROBE_TILE or N % PROBE_TILE):
            raise ValueError(
                f"{self.name}: needs hk >= 2, tm > 4 * hk with tm - 2 * hk "
                f"and tm - 4 * hk multiples of {PROBE_CHUNK}, R >= tm and N "
                f"a multiple of {PROBE_TILE}; got R={R} N={N} tm={tm} "
                f"hk={hk}")
        want = (R if variant == "A" else R + 2 * hk, N)
        if tuple(x.shape) != want:
            raise ValueError(f"{self.name}: variant {variant} reads "
                             f"{want}, got {tuple(x.shape)}")
        on_cpu = _check_fp32_pair(self.name, x, out)
        if on_cpu:
            return self.plain(x, out, variant, tm, hk,
                              self.n_ctas(x.device, (R, N), variant, depth,
                                          tm, hk, load))
        if self.smem_bytes(variant, depth, tm, hk) > SMEM_LIMIT:
            raise ValueError(f"{self.name}: tm={tm} hk={hk} depth={depth} "
                             "exceed shared memory")
        if x.data_ptr() % 16 or out.data_ptr() % 16:
            raise ValueError(f"{self.name} copies 16-byte pieces: x and out "
                             "must be 16-byte aligned")
        n_ctas = self.n_ctas(x.device, (R, N), variant, depth, tm, hk, load)
        lib = EXPERIMENTS.get()
        carry = (torch.empty((n_ctas, hk, PROBE_TILE), dtype=torch.float32,
                             device=x.device) if variant == "C" else None)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.overlap_probe(
                x.data_ptr(), out.data_ptr(),
                carry.data_ptr() if carry is not None else None, R, N, tm,
                hk, PROBE_VARIANTS.index(variant), depth, int(load), n_ctas,
                stream)
        if err:
            raise _launch_error(self.name, err)
        self.launches += 1
        return out, carry


stencil2d_levels = LevelsKernel(
    "stencil2d_levels", 2, stencil2d_levels_ref,
    "drstencil_tpu/ops/stream.py:568")
stencil3d_levels = LevelsKernel(
    "stencil3d_levels", 3, stencil3d_levels_ref,
    "drstencil_tpu/ops/stream.py:568")
stencil2d_levels_shard = LevelsKernel(
    "stencil2d_levels_shard", 2, stencil2d_levels_shard_ref,
    "drstencil_tpu/ops/stream.py:570", shard=True)
stencil3d_levels_shard = LevelsKernel(
    "stencil3d_levels_shard", 3, stencil3d_levels_shard_ref,
    "drstencil_tpu/ops/stream.py:570", shard=True)
stencil2d_factor_levels = FactorLevelsKernel(
    "stencil2d_factor_levels", 2, stencil2d_factor_levels_ref,
    "drstencil_tpu/ops/stream.py:683")
stencil2d_factor_levels_shard = FactorLevelsKernel(
    "stencil2d_factor_levels_shard", 2, stencil2d_factor_levels_shard_ref,
    "drstencil_tpu/ops/stream.py:683", shard=True)
tile2d_fused = Tile2dKernel()
overlap_probe = OverlapProbeKernel()
PLAN_KERNELS = (stencil2d_levels, stencil3d_levels, stencil2d_levels_shard,
                stencil3d_levels_shard)
KERNELS = PLAN_KERNELS + (stencil2d_factor_levels,
                          stencil2d_factor_levels_shard, tile2d_fused,
                          overlap_probe)


def kernel_for(ndim: int, shard: bool = False) -> LevelsKernel:
    """The levels kernel of ``ndim``-D grids, or its shard-local build."""
    return PLAN_KERNELS[ndim - 2 + (2 if shard else 0)]


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
