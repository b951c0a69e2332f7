"""The port's hand-written Hopper kernels: build, wrappers, plain versions.

The CUDA kernels of ``csrc/stencil.cu`` replace every build of the TPU
streaming kernel ``drstencil_tpu/ops/stream.py:568-803``:

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
  V2 level adds the residual R read from the level two back.

Each has two builds, on float32 and on bfloat16 state (C entries ``<name>``
and ``<name>_bf16``): the bf16 build loads as fp32, computes every level in
fp32 and rounds once at the store, as the TPU kernel does with
``dtype="bfloat16"``.  The source notes in ``stencil.cu`` give the designs
and the bounds.

The kernels are compiled by ``nvcc`` for ``sm_90a`` into ``build/`` at the
repository root at first use, and loaded with ``ctypes`` through a plain C
interface.  Each wrapper dispatches on the tensors' device: CPU tensors go
to the plain PyTorch version beside it (``*_ref``), CUDA tensors launch the
kernel or raise.  On CUDA it dispatches on the tensors' dtype to the fp32
or the bf16 build.  Each wrapper's ``launches`` counts its kernel's launches
(both builds) only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Size of the by-value tap table (stencil.cu MAX_TAPS); checked at load.
MAX_TAPS = 256
# Shared memory one block may use on Hopper: 227 KB.
SMEM_LIMIT = 232448
# Storage dtypes the kernels take, with the suffix of their C entry point.
BUILDS = {torch.float32: "", torch.bfloat16: "_bf16"}
# Output tile per CTA, (y, x) in 2D and (z, y, x) in 3D, before shrinking
# to fit SMEM_LIMIT.
TILE_2D = (32, 64)
TILE_3D = (8, 16, 32)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "stencil.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class LevelTaps:
    """What one kernel launch applies: ``levels`` levels of the tap table
    (``offsets`` (n, ndim) int32 sorted with ``coeffs`` (n,) float32), each
    reaching ``reach`` cells, with the frozen frame ``frame`` =
    ``levels * reach`` on every axis."""

    offsets: np.ndarray
    coeffs: np.ndarray
    levels: int
    reach: int
    frame: int

    @property
    def ndim(self) -> int:
        return self.offsets.shape[1]


@dataclass(frozen=True)
class FactorTaps:
    """What one factor-mode launch applies: ``levels`` = 2 * step levels of
    reach ``reach`` = 1 alternating the tables V1 and V2; every V2 level
    adds the residual table R read from the level two back at reach
    ``2 * reach``.  Each table is (offsets (n, 2) int32, coeffs (n,)
    float32) in sorted order; ``frame`` = ``levels * reach``."""

    v1: Tuple[np.ndarray, np.ndarray]
    v2: Tuple[np.ndarray, np.ndarray]
    r: Tuple[np.ndarray, np.ndarray]
    levels: int
    reach: int
    frame: int

    ndim = 2

    @property
    def taps_per_step(self) -> int:
        """|V1| + |V2| + |R|: the taps one timestep applies per cell."""
        return sum(len(c) for _, c in (self.v1, self.v2, self.r))


def is_factor(taps) -> bool:
    return isinstance(taps, FactorTaps)


def tile_shape(ndim: int, frame: int, levels: int,
               factor: bool = False) -> Tuple[int, ...]:
    """Output tile of one CTA, halved (leading axis first) until the
    haloed tile — ``n_buffers`` of it — fits in shared memory."""
    tile = list(TILE_2D if ndim == 2 else TILE_3D)
    nbuf = n_buffers(levels, factor)
    while smem_bytes(tile, frame, nbuf) > SMEM_LIMIT:
        axis = next((a for a, t in enumerate(tile) if t > 1), None)
        if axis is None:
            raise ValueError(
                f"frame {frame} is too wide for a shared-memory tile")
        tile[axis] //= 2
    return tuple(tile)


def n_buffers(levels: int, factor: bool = False) -> int:
    """Shared-memory tiles of one CTA: two to ping-pong levels, one for a
    single level, three in factor mode (the level two back stays alive)."""
    if factor:
        return 3
    return 2 if levels > 1 else 1


def smem_bytes(tile, frame: int, nbuf: int) -> int:
    """Shared memory of one CTA: ``nbuf`` haloed tiles of fp32, whatever
    the storage dtype (the load converts to fp32)."""
    return nbuf * 4 * int(np.prod([t + 2 * frame for t in tile]))


# -- build -------------------------------------------------------------------

class _Library:
    """The compiled kernel library, built and loaded at first use."""

    def __init__(self):
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
        with open(SOURCE, "rb") as f:
            src = f.read()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        self.path = os.path.join(BUILD_DIR, f"libdrstencil_{digest[:16]}.so")
        t0 = time.perf_counter()
        if not os.path.exists(self.path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{self.path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{self.build_log}")
            os.replace(tmp, self.path)
        self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(self.path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.stencil_max_taps.argtypes = []
        lib.stencil_max_taps.restype = i32
        lib.stencil_error_string.argtypes = [i32]
        lib.stencil_error_string.restype = ctypes.c_char_p
        for kernel in KERNELS:
            for suffix in BUILDS.values():
                fn = getattr(lib, kernel.name + suffix)
                fn.argtypes = kernel.argtypes(ptr, i32)
                fn.restype = i32
        if lib.stencil_max_taps() != MAX_TAPS:
            raise RuntimeError("stencil.cu MAX_TAPS disagrees with kernels.py")
        return lib


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


LIBRARY = _Library()


def build() -> _Library:
    """Build (or find) and load the kernel library; returns it, with
    ``build_seconds``, ``path`` and the compiler's ``build_log``."""
    LIBRARY.get()
    return LIBRARY


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


def stencil2d_factor_levels_ref(src, dst, taps: FactorTaps):
    """Plain PyTorch version of ``stencil2d_factor_levels``: level t is V1
    of level t-1 for odd t, and V2 of level t-1 plus R of level t-2 (two
    reaches wider on every side) for even t; fp32 levels, one rounding."""
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
    return _store(cur, dst, H)


# -- wrappers ----------------------------------------------------------------

class LevelsKernel:
    """Wrapper of one kernel: ``kernel(src, dst, taps)`` writes the
    interior of ``dst`` in place and returns it.  ``src`` and ``dst``
    share one dtype of ``BUILDS``.  ``launches`` counts the kernel's
    launches in both builds (never the plain version's calls).

    A shard-local kernel (``shard=True``) is called as ``kernel(src, dst,
    taps, rows)``: ``src`` and ``dst`` are one shard's slabs and ``rows`` is
    the ``(lo, hi)`` range of axis 0 it stores, within ``[frame, dim -
    frame)``; everything outside it keeps ``dst``'s value."""

    route = "cuda"
    source = "drstencil_tpu_torch/csrc/stencil.cu"
    taps_type = LevelTaps

    def __init__(self, name: str, ndim: int, plain, replaces: str,
                 shard: bool = False):
        self.name = name
        self.ndim = ndim
        self.plain = plain
        self.replaces = replaces
        self.shard = shard
        self.launches = 0

    def argtypes(self, ptr, i32):
        """ctypes argument types of the C entry: src, dst, the grid, the
        table, levels, reach, frame, the tile, the store range of a shard
        kernel, the stream."""
        return ([ptr, ptr] + [i32] * self.ndim + [ptr, ptr, i32]
                + [i32] * 3 + [i32] * self.ndim
                + [i32] * (2 if self.shard else 0) + [ptr])

    def _plan_args(self, taps, keep):
        """The C entry's arguments from the table to the tile; numpy
        buffers whose pointers are passed go into ``keep``."""
        if len(taps.coeffs) > MAX_TAPS:
            raise ValueError(f"{len(taps.coeffs)} taps exceed MAX_TAPS="
                             f"{MAX_TAPS}")
        return (*_table_args(taps.offsets, taps.coeffs, keep), taps.levels,
                taps.reach, taps.frame,
                *tile_shape(self.ndim, taps.frame, taps.levels))

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
        if src.numel() >= 2**31:
            raise ValueError(f"{self.name}: grid of {src.numel()} cells "
                             "exceeds the kernel's int indexing")
        lib = LIBRARY.get()
        keep = []
        args = self._plan_args(taps, keep)
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, self.name + BUILDS[src.dtype])(
                src.data_ptr(), dst.data_ptr(), *src.shape, *args, *store,
                stream)
        if err:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{lib.stencil_error_string(err).decode()}")
        self.launches += 1
        return dst


class FactorLevelsKernel(LevelsKernel):
    """Wrapper of the factor-mode kernel: ``taps`` is a ``FactorTaps``."""

    taps_type = FactorTaps

    def argtypes(self, ptr, i32):
        """src, dst, the grid, three tables, levels, frame, the tile, the
        stream."""
        return ([ptr, ptr, i32, i32] + [ptr, ptr, i32] * 3
                + [i32] * 4 + [ptr])

    def _plan_args(self, taps, keep):
        tables = []
        for offsets, coeffs in (taps.v1, taps.v2, taps.r):
            tables += _table_args(offsets, coeffs, keep)
        return (*tables, taps.levels, taps.frame,
                *tile_shape(2, taps.frame, taps.levels, factor=True))


def _table_args(offsets, coeffs, keep):
    """(pointer to int32 offsets, pointer to fp32 coeffs, count) of one
    tap table; the contiguous copies are kept alive in ``keep``."""
    offs = np.ascontiguousarray(offsets, dtype=np.int32)
    coefs = np.ascontiguousarray(coeffs, dtype=np.float32)
    keep += [offs, coefs]
    return [offs.ctypes.data, coefs.ctypes.data, len(coefs)]


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
KERNELS = (stencil2d_levels, stencil3d_levels, stencil2d_levels_shard,
           stencil3d_levels_shard, stencil2d_factor_levels)


def kernel_for(ndim: int, shard: bool = False) -> LevelsKernel:
    """The levels kernel of ``ndim``-D grids, or its shard-local build."""
    return KERNELS[ndim - 2 + (2 if shard else 0)]


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
