"""The port's hand-written Hopper kernels: build, wrappers, plain versions.

Two CUDA kernels (``csrc/stencil.cu``) replace the TPU streaming kernel
``drstencil_tpu/ops/stream.py:568-803``:

- ``stencil2d_levels`` for 2D grids;
- ``stencil3d_levels`` for 3D grids.

Each applies ``levels`` levels of one tap table to the interior
``[frame, dim - frame)`` of ``dst``, reading ``src``, and never writes a
frame cell.  Each has two builds, on float32 and on bfloat16 state (C
entries ``*_levels`` and ``*_levels_bf16``): the bf16 build loads as fp32,
computes every level in fp32 and rounds once at the store, as the TPU
kernel does with ``dtype="bfloat16"``.  The source note in ``stencil.cu``
gives the design and the bound.

The kernels are compiled by ``nvcc`` for ``sm_90a`` into ``build/`` at the
repository root at first use, and loaded with ``ctypes`` through a plain C
interface.  Each wrapper dispatches on the tensors' device: CPU tensors go
to the plain PyTorch version beside it (``*_ref``), CUDA tensors launch the
kernel or raise.  On CUDA it dispatches on the tensors' dtype to the fp32
or the bf16 build.  ``launches`` counts kernel launches (both builds) only.
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


def tile_shape(ndim: int, frame: int, levels: int) -> Tuple[int, ...]:
    """Output tile of one CTA, halved (leading axis first) until the
    haloed tile — two buffers of it when ``levels > 1`` — fits in shared
    memory."""
    tile = list(TILE_2D if ndim == 2 else TILE_3D)
    nbuf = n_buffers(levels)
    while smem_bytes(tile, frame, nbuf) > SMEM_LIMIT:
        axis = next((a for a, t in enumerate(tile) if t > 1), None)
        if axis is None:
            raise ValueError(
                f"frame {frame} is too wide for a shared-memory tile")
        tile[axis] //= 2
    return tuple(tile)


def n_buffers(levels: int) -> int:
    """Shared-memory tiles of one CTA: two to ping-pong levels, one for a
    single level."""
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
        for suffix in BUILDS.values():
            fn2 = getattr(lib, "stencil2d_levels" + suffix)
            fn2.argtypes = [ptr, ptr, i32, i32, ptr, ptr, i32, i32, i32, i32,
                            i32, i32, ptr]
            fn2.restype = i32
            fn3 = getattr(lib, "stencil3d_levels" + suffix)
            fn3.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr, i32, i32, i32,
                            i32, i32, i32, i32, ptr]
            fn3.restype = i32
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

def _levels_ref(src: torch.Tensor, dst: torch.Tensor,
                taps: LevelTaps) -> torch.Tensor:
    """Zero-pad ``src`` by ``frame``, apply ``levels`` 'valid' shifted-slice
    sums in fp32 (taps in table order), copy the interior into ``dst``.

    The plain version of both builds: a bfloat16 ``src`` is upcast to
    fp32, every level stays fp32, and the result is rounded to ``dst``'s
    dtype once at the copy (round to nearest even), as the bf16 kernel
    does."""
    H, r = taps.frame, taps.reach
    cur = F.pad(src.to(torch.float32), (H,) * (2 * src.dim()))
    for _ in range(taps.levels):
        inner = [s - 2 * r for s in cur.shape]
        acc = None
        for off, coe in zip(taps.offsets.tolist(), taps.coeffs.tolist()):
            sl = cur[tuple(slice(r + o, r + o + n) for o, n in zip(off, inner))]
            term = coe * sl
            acc = term if acc is None else acc + term
        cur = acc
    interior = tuple(slice(H, s - H) for s in dst.shape)
    dst[interior] = cur[interior].to(dst.dtype)
    return dst


def stencil2d_levels_ref(src, dst, taps: LevelTaps):
    """Plain PyTorch version of ``stencil2d_levels``."""
    return _levels_ref(src, dst, taps)


def stencil3d_levels_ref(src, dst, taps: LevelTaps):
    """Plain PyTorch version of ``stencil3d_levels``."""
    return _levels_ref(src, dst, taps)


# -- wrappers ----------------------------------------------------------------

class LevelsKernel:
    """Wrapper of one kernel: ``kernel(src, dst, taps)`` writes the
    interior of ``dst`` in place and returns it.  ``src`` and ``dst``
    share one dtype of ``BUILDS``.  ``launches`` counts the kernel's
    launches in both builds (never the plain version's calls)."""

    route = "cuda"
    source = "drstencil_tpu_torch/csrc/stencil.cu"
    replaces = "drstencil_tpu/ops/stream.py:568"

    def __init__(self, name: str, ndim: int, plain):
        self.name = name
        self.ndim = ndim
        self.plain = plain
        self.launches = 0

    def __call__(self, src: torch.Tensor, dst: torch.Tensor,
                 taps: LevelTaps) -> torch.Tensor:
        if taps.ndim != self.ndim or src.dim() != self.ndim:
            raise ValueError(
                f"{self.name} takes {self.ndim}D grids and tap tables, got "
                f"a {src.dim()}D grid and a {taps.ndim}D table")
        if src.shape != dst.shape:
            raise ValueError(f"src {tuple(src.shape)} and dst "
                             f"{tuple(dst.shape)} differ in shape")
        if len(taps.coeffs) > MAX_TAPS:
            raise ValueError(f"{len(taps.coeffs)} taps exceed MAX_TAPS="
                             f"{MAX_TAPS}")
        if src.dtype != dst.dtype or src.dtype not in BUILDS:
            raise TypeError(f"{self.name} takes src and dst of one dtype in "
                            f"{[str(d) for d in BUILDS]}, got {src.dtype} "
                            f"and {dst.dtype}")
        if src.device.type == "cpu" and dst.device.type == "cpu":
            return self.plain(src, dst, taps)
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
        tile = tile_shape(self.ndim, taps.frame, taps.levels)
        offs = np.ascontiguousarray(taps.offsets, dtype=np.int32)
        coefs = np.ascontiguousarray(taps.coeffs, dtype=np.float32)
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, self.name + BUILDS[src.dtype])(
                src.data_ptr(), dst.data_ptr(), *src.shape,
                offs.ctypes.data, coefs.ctypes.data, len(coefs),
                taps.levels, taps.reach, taps.frame, *tile, stream)
        if err:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{lib.stencil_error_string(err).decode()}")
        self.launches += 1
        return dst


stencil2d_levels = LevelsKernel("stencil2d_levels", 2, stencil2d_levels_ref)
stencil3d_levels = LevelsKernel("stencil3d_levels", 3, stencil3d_levels_ref)
KERNELS = (stencil2d_levels, stencil3d_levels)


def kernel_for(ndim: int) -> LevelsKernel:
    return KERNELS[ndim - 2]


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
