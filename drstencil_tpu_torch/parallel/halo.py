"""Spatial domain decomposition across a mesh of devices with halo exchange —
the port of ``drstencil_tpu/parallel/halo.py``.

The JAX package shards the grid over a ``jax.sharding.Mesh`` and exchanges
``halo``-row slabs with ``ppermute`` inside ``shard_map``, all in one
process.  The counterpart is one process too: a :class:`Mesh` is an ordered
grid of ``torch.device``s, a sharded array is a list of per-shard tensors
(row-major over the mesh), and the exchange copies neighbours' edge rows
from device to device (``Tensor.to`` / ``Tensor.copy_``: a device-to-device
copy on one card, a peer copy over NVLink between cards).  A mesh may name
one device several times, which is how one card or the CPU stands in for
several.

This module is the plain decomposition: the fused operator as a
shifted-slice sum in plain torch on each shard, in the state's own dtype
(the JAX functions leave it to XLA; no kernel is involved).  The sharded
streaming kernel is ``parallel/stream_shard.py``.

Semantics identical to the single-device path: one application applies the
fused operator to the *global* interior; the global boundary frame is
frozen.  Destinations are updated in place, as everywhere in the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from drstencil_tpu_torch.ir.passes import Analysis
from drstencil_tpu_torch.ops.stream import resolve_device


@dataclass(frozen=True)
class Mesh:
    """An ordered grid of devices: ``devices`` row-major over ``shape``
    (one or two axes), sharding the leading ``len(shape)`` grid axes."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def put(self, x, dtype: torch.dtype | None = None) -> List[torch.Tensor]:
        """Split a global array (numpy or tensor) over the mesh: one
        contiguous block per device, row-major."""
        x = torch.as_tensor(x)
        for a, n in enumerate(self.shape):
            if x.shape[a] % n:
                raise ValueError(
                    f"axis {a} of {tuple(x.shape)} not divisible by mesh "
                    f"axis {n}")
        blocks = [x]
        for a, n in enumerate(self.shape):
            blocks = [c for b in blocks for c in torch.chunk(b, n, dim=a)]
        return [b.to(device=dev, dtype=dtype).contiguous()
                for b, dev in zip(blocks, self.devices)]

    def gather(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global array of a sharded one, on the CPU."""
        blocks = [s.detach().to("cpu") for s in shards]
        for a in reversed(range(len(self.shape))):
            n = self.shape[a]
            blocks = [torch.cat(blocks[i:i + n], dim=a)
                      for i in range(0, len(blocks), n)]
        return blocks[0]


def _devices(n: int, devices) -> Tuple[torch.device, ...]:
    """``n`` mesh devices: the caller's list (names may repeat), or the
    visible CUDA devices.  The CPU is taken only when the caller names it."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
    elif torch.cuda.is_available():
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = []
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return tuple(devs[:n])


def make_mesh(n_devices: int, devices: Sequence | None = None) -> Mesh:
    """A 1-axis mesh of ``n_devices`` devices sharding grid axis 0."""
    return Mesh(_devices(n_devices, devices), (n_devices,))


def make_mesh_2d(shape: tuple, devices: Sequence | None = None) -> Mesh:
    """A 2-axis mesh sharding grid axes 0 and 1."""
    shape = (int(shape[0]), int(shape[1]))
    return Mesh(_devices(shape[0] * shape[1], devices), shape)


def _fused_sum(ext: torch.Tensor, taps, h: int) -> torch.Tensor:
    """The gold's shifted-slice sum (taps in sorted order) on a block whose
    sharded axes carry ``h`` received halo cells on each side: the result
    covers the whole block on those axes and the interior of the others."""
    inner = [s - 2 * h for s in ext.shape]
    acc = None
    for off, coe in taps:
        sl = ext[tuple(slice(h + o, h + o + n) for o, n in zip(off, inner))]
        term = coe * sl
        acc = term if acc is None else acc + term
    return acc


def _with_neighbours(blocks, index, n: int, stride: int, h: int, axis: int):
    """``blocks[index]`` extended along ``axis`` by its mesh neighbours'
    ``h`` edge cells (``stride`` apart in the flat list; ``n`` shards on
    this mesh axis), zeros at the global edges."""
    me = blocks[index]
    pos = (index // stride) % n
    edge = list(me.shape)
    edge[axis] = h
    before = (blocks[index - stride].narrow(axis, me.shape[axis] - h, h)
              .to(me.device) if pos > 0 else me.new_zeros(edge))
    after = (blocks[index + stride].narrow(axis, 0, h).to(me.device)
             if pos < n - 1 else me.new_zeros(edge))
    return torch.cat([before, me, after], dim=axis)


def _store_unfrozen(dst, acc, h: int, first: Sequence[bool],
                    last: Sequence[bool]) -> None:
    """Write ``acc`` into ``dst`` over the sharded axes (all of them, less
    ``h`` cells of the global frame where this shard is ``first`` / ``last``
    on that mesh axis) and the interior of the other axes."""
    region = []
    for a, s in enumerate(dst.shape):
        if a < len(first):
            region.append(slice(h if first[a] else 0,
                                max(s - h, 0) if last[a] else s))
        else:
            region.append(slice(h, s - h))
    src = tuple(slice(r.start, r.stop) if a < len(first)
                else slice(None) for a, r in enumerate(region))
    dst[tuple(region)] = acc[src]


def make_sharded_apply(an: Analysis, mesh: Mesh):
    """Build ``f(src, dst) -> dst`` on arrays sharded along axis 0.

    ``src`` and ``dst`` are lists of per-shard tensors (``mesh.put``); the
    fused operator is applied to the global interior, in place in ``dst``;
    ``dst``'s global boundary frame is preserved.  The halo exchange moves
    ``2 * h`` rows per neighbouring device pair per application.
    """
    taps = sorted(an.fused.items())
    h = an.halo
    dims = an.spec.dims
    (n_shards,) = mesh.shape
    if dims[0] % n_shards != 0:
        raise ValueError(
            f"streaming axis {dims[0]} not divisible by mesh axis {n_shards}"
        )
    local_rows = dims[0] // n_shards
    if local_rows < h:
        raise ValueError(f"local slab {local_rows} rows < halo {h}")

    def f(src, dst):
        exts = [_with_neighbours(src, k, n_shards, 1, h, 0)
                for k in range(n_shards)]
        for k, ext in enumerate(exts):
            _store_unfrozen(dst[k], _fused_sum(ext, taps, h), h,
                            (k == 0,), (k == n_shards - 1,))
        return dst

    return f


def make_sharded_apply_2d(an: Analysis, mesh: Mesh):
    """2-axis spatial decomposition: grid axis 0 over mesh axis 0, axis 1
    over mesh axis 1, with halo exchanges along both (two phases per
    application; the second moves the rows received in the first, so the
    corners come along)."""
    taps = sorted(an.fused.items())
    h = an.halo
    dims = an.spec.dims
    nx, ny = mesh.shape
    if dims[0] % nx or dims[1] % ny:
        raise ValueError(
            f"grid {dims[:2]} not divisible by mesh {nx}x{ny}"
        )
    lx, ly = dims[0] // nx, dims[1] // ny
    if lx < h or ly < h:
        raise ValueError("local slab smaller than the halo")

    def f(src, dst):
        n = nx * ny
        ext = [_with_neighbours(src, k, nx, ny, h, 0) for k in range(n)]
        ext = [_with_neighbours(ext, k, ny, 1, h, 1) for k in range(n)]
        for k in range(n):
            ix, iy = divmod(k, ny)
            _store_unfrozen(dst[k], _fused_sum(ext[k], taps, h), h,
                            (ix == 0, iy == 0), (ix == nx - 1, iy == ny - 1))
        return dst

    return f


def sharded_pair(an: Analysis, mesh: Mesh):
    """The ping-pong pair ``(a, b) -> (a, b)`` on the sharded state, both
    updated in place."""
    f = make_sharded_apply(an, mesh)

    def pair(a, b):
        f(a, b)
        f(b, a)
        return a, b

    return pair
