"""The streaming kernel under domain decomposition — the port of
``drstencil_tpu/parallel/stream_shard.py``.

The single-device kernel (``ops/stream.py``) composed with the mesh of
``parallel/halo.py``: the grid's leading axis is sharded over a 1-axis
mesh, every device holds its slab with ``H`` ghost rows (planes in 3D) on
each side of axis 0, and every application

1. copies each shard's ``H`` edge rows of the SOURCE into its neighbours'
   ghost rows (:class:`HaloExchange`); the ghost rows at the two global
   edges are never written and stay zero, which is what the single-device
   kernel reads outside the domain;
2. runs the shard-local kernel (``build_stream_kernel(..., row_frame=
   False)``: ``stencil{2,3}d_levels_shard``, or in factor mode
   ``stencil2d_factor_levels_shard``) on every shard: interior shards
   store all their rows, computed from the received ghost rows;
3. leaves the global Dirichlet row frame frozen: the two edge shards are
   given a store range that stops ``H`` rows short of the global edge.

Destinations are updated in place, so a destination's ghost rows are only
ever written by the exchange.  The result equals the single-device
``StencilProgram``'s on the global grid, cell for cell: every stored cell
runs the same operations on the same values.

Ordering across devices.  Every kernel launches on its own device's
current stream, and the exchange uses ``Tensor.copy_``, which for two CUDA
devices runs on the source device's current stream after waiting for the
destination device's current stream, and makes the destination's stream
wait for the copy (events recorded by PyTorch's peer copy).  So a copy
reads a neighbour's rows only after that neighbour's previous kernel, and
a kernel starts only after its ghost rows have landed, with no
``torch.cuda.synchronize()`` per application.  With all shards on one card
and one stream, the launches order themselves.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np
import torch

from drstencil_tpu_torch.ir.passes import Analysis, analyze
from drstencil_tpu_torch.ir.spec import StencilSpec
from drstencil_tpu_torch.ops import stream as stream_mod
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.parallel.halo import Mesh
from drstencil_tpu_torch.utils.profiling import span


def local_analysis(spec: StencilSpec, cfg: KernelConfig,
                   n_shards: int) -> Analysis:
    """Analysis of the shard-local problem (leading axis divided)."""
    dims = spec.dims
    if dims[0] % n_shards:
        raise ValueError(
            f"leading axis {dims[0]} not divisible by {n_shards} shards"
        )
    local_dims = (dims[0] // n_shards,) + tuple(dims[1:])
    local = StencilSpec(spec.name, local_dims, spec.iterations, spec.taps)
    return analyze(local, step=cfg.step, distance=cfg.distance,
                   merge_forward=cfg.merge_forward)


class HaloExchange:
    """Copies every shard's ``halo`` edge rows into its neighbours' ghost
    rows: ``2 * (n - 1)`` copies of ``halo * prod(dims[1:]) * itemsize``
    bytes per call.  ``calls``, ``copies`` and ``bytes`` count the calls
    and what they copied.  Each call is the span ``drstencil.halo``
    (:func:`utils.profiling.span`), whose ``gpu_user_annotation`` on a
    card covers the copies it issued there."""

    SPAN = "drstencil.halo"

    def __init__(self, halo: int, local_rows: int):
        self.halo = halo
        self.local_rows = local_rows
        self.calls = 0
        self.copies = 0
        self.bytes = 0

    def __call__(self, slabs: Sequence[torch.Tensor]) -> None:
        h, rows = self.halo, self.local_rows
        with span(self.SPAN):
            for lower, upper in zip(slabs[:-1], slabs[1:]):
                # the lower shard's last real rows -> the upper's low
                # ghosts, the upper's first real rows -> the lower's high
                # ghosts
                for dst, src in ((upper[:h], lower[rows:rows + h]),
                                 (lower[h + rows:], upper[h:2 * h])):
                    dst.copy_(src, non_blocking=True)
                    self.copies += 1
                    self.bytes += src.numel() * src.element_size()
        self.calls += 1


@dataclass
class ShardGeometry:
    """The sharded state's layout: the global ``dims``, ``local_rows`` of
    axis 0 per shard, the ghost width ``halo``, the state's ``dtype``, the
    ``mesh`` and the ``exchange`` (with its counters)."""

    mesh: Mesh
    dims: tuple
    local_rows: int
    halo: int
    dtype: torch.dtype
    exchange: HaloExchange = field(repr=False, default=None)

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def slab_dims(self) -> tuple:
        return (self.local_rows + 2 * self.halo,) + tuple(self.dims[1:])

    def store_rows(self, k: int) -> tuple:
        """The ``(lo, hi)`` range of slab rows shard ``k`` stores: its local
        rows, less the global frame on the two edge shards."""
        h, rows = self.halo, self.local_rows
        return (2 * h if k == 0 else h,
                rows if k == self.n_shards - 1 else h + rows)


def build_sharded_stream(spec: StencilSpec, cfg: KernelConfig, mesh: Mesh):
    """Build ``(apply, geometry)`` for the sharded streaming kernel.

    ``apply(a, b) -> b`` takes two sharded states (lists of ghosted slabs,
    :func:`shard_state`), exchanges ``a``'s halo rows and applies the fused
    operator to the global interior in place in ``b``, preserving ``b``'s
    global frame — identical semantics to the single-device kernel (and to
    ``halo.make_sharded_apply``).
    """
    if len(mesh.shape) != 1:
        raise ValueError("the sharded streaming kernel takes a 1-axis mesh")
    n_shards = mesh.size
    an = local_analysis(spec, cfg, n_shards)
    kernels = [stream_mod.build_stream_kernel(an, cfg, dev, row_frame=False)
               for dev in mesh.devices]
    h, local_rows = an.halo, an.spec.dims[0]
    if local_rows < h:
        raise ValueError(f"local slab {local_rows} rows < row halo {h}")
    g = ShardGeometry(mesh=mesh, dims=tuple(spec.dims),
                      local_rows=local_rows, halo=h,
                      dtype=stream_mod.state_dtype(cfg.dtype),
                      exchange=HaloExchange(h, local_rows))
    rows = [g.store_rows(k) for k in range(n_shards)]

    def apply_fn(a: List[torch.Tensor], b: List[torch.Tensor]):
        g.exchange(a)
        for k, f in enumerate(kernels):
            f(a[k], b[k], rows[k])
        return b

    return apply_fn, g


def shard_state(x, g: ShardGeometry) -> List[torch.Tensor]:
    """Split a real global array (numpy or tensor) into per-shard slabs of
    ``g.dtype`` on the mesh's devices, each with ``g.halo`` zero ghost rows
    on both sides of axis 0."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if tuple(x.shape) != tuple(g.dims):
        raise ValueError(f"state {tuple(x.shape)} is not {tuple(g.dims)}")
    h = g.halo
    slabs = []
    for block, dev in zip(torch.chunk(x, g.n_shards, dim=0), g.mesh.devices):
        slab = torch.zeros(g.slab_dims, dtype=g.dtype, device=dev)
        slab[h:h + g.local_rows] = block.to(device=dev, dtype=g.dtype)
        slabs.append(slab)
    return slabs


def unshard_state(slabs: Sequence[torch.Tensor], g: ShardGeometry) -> np.ndarray:
    """Inverse of :func:`shard_state`: the real global array as float32
    numpy (which holds a bfloat16 state exactly)."""
    h = g.halo
    real = [s[h:h + g.local_rows].detach().to("cpu", torch.float32)
            for s in slabs]
    return torch.cat(real, dim=0).numpy()


# NVLink on H100 SXM: 900 GB/s between the cards of one host, 450 GB/s each
# way (NVIDIA's data sheet; not measured here).  The per-copy latency has no
# data-sheet figure: callers pass the one they measured.
NVLINK_BW_BYTES_PER_S = 4.5e11


def halo_traffic_model(an: Analysis, step: int, n_shards: int,
                       ms_per_step_single: float | None = None,
                       itemsize: int = 4,
                       link_bw: float = NVLINK_BW_BYTES_PER_S,
                       latency_s: float = 0.0) -> dict:
    """Cost model of the halo exchange in :func:`build_sharded_stream`.

    Exactly what :class:`HaloExchange` does (``tests/test_torch_parallel.py``
    holds its counters to these bytes): per fused apply (= ``step`` plain
    timesteps) an interior shard sends its first ``halo`` real rows to one
    neighbour and its last to the other, two copies of ``halo *
    prod(dims[1:]) * itemsize`` bytes each; the mesh makes ``2 * (n_shards
    - 1)`` such copies.  There is no other traffic between devices.

    Returns the per-apply byte/time accounting over a link of ``link_bw``
    bytes/s each way (default: NVLink's data-sheet figure) with
    ``latency_s`` per copy (default 0: pass a measured one) plus, when the
    measured single-device ``ms_per_step_single`` is given, the MODELLED
    weak-scaling efficiency  t_comp / (t_comp + t_halo): each device keeps
    the full single-device problem, so per-step compute time is unchanged
    and the only addition is the (unoverlapped, worst-case serial) exchange.
    """
    row_cells = int(np.prod(an.spec.dims[1:]))
    bytes_per_copy = an.halo * row_cells * itemsize
    t_halo_s = 2 * (bytes_per_copy / link_bw + latency_s)
    out = {
        "halo": an.halo, "row_cells": row_cells, "step": step,
        "n_shards": n_shards, "itemsize": itemsize,
        "bytes_per_copy": bytes_per_copy,
        "bytes_per_apply": 2 * bytes_per_copy,      # one interior shard
        "copies_per_apply_mesh": 2 * (n_shards - 1),
        "bytes_per_apply_mesh": 2 * (n_shards - 1) * bytes_per_copy,
        "link_bytes_per_s": link_bw, "latency_s": latency_s,
        "halo_ms_per_apply": t_halo_s * 1e3,
        "halo_ms_per_step": t_halo_s * 1e3 / step,
    }
    if ms_per_step_single is not None:
        out["ms_per_step_single"] = ms_per_step_single
        out["weak_scaling_efficiency"] = ms_per_step_single / (
            ms_per_step_single + out["halo_ms_per_step"])
    return out


def sharded_stream_pair(spec: StencilSpec, cfg: KernelConfig, mesh: Mesh):
    """The ping-pong pair ``(a, b) -> (a, b)`` on the sharded ghosted state,
    both updated in place — the multi-device analogue of
    ``runner.StencilProgram.pair_fn``.  Returns ``(pair, geometry)``."""
    apply_fn, g = build_sharded_stream(spec, cfg, mesh)

    def pair(a, b):
        apply_fn(a, b)
        apply_fn(b, a)
        return a, b

    return pair, g
