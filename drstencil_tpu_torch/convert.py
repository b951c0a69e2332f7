"""Carry specs, configs and state across from the JAX package.

The port imports nothing of ``drstencil_tpu``, so objects cross as plain
fields and numpy arrays: a JAX ``StencilSpec`` as its fields, a
``KernelConfig`` as its dict (its TPU tile sizes left behind), and
ping-pong state as the JAX side's
real-shaped arrays (already unpadded by its ``unpad_state``).  A bfloat16
state crosses through float32, which holds every bfloat16 value exactly.
The plain-tile experiment's state crosses as the real-shaped data block:
each package pads it into its own ``(R + 2 * tm, C)`` buffer.
A sharded state crosses as the global array: each package splits it into
its own shards (the JAX side's ``stream_shard.shard_state`` into padded
tall buffers, the port's into ghosted slabs) and joins them back.
"""

from __future__ import annotations

import numpy as np
import torch

from drstencil_tpu_torch.ir.spec import StencilSpec
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import resolve_device, state_dtype
from drstencil_tpu_torch.parallel import stream_shard
from drstencil_tpu_torch.tune.tuned import tpu_config


def spec_from_fields(name: str, dims, iterations: int, taps) -> StencilSpec:
    return StencilSpec(name=name, dims=tuple(dims), iterations=int(iterations),
                       taps=dict(taps))


def config_from_dict(d: dict) -> KernelConfig:
    """A JAX ``KernelConfig``'s dict as the port's config, without the TPU
    tile sizes ``tm`` and ``ch``: on Hopper they name the CTA's segment
    and column, which the TPU's values are not."""
    return tpu_config(d)


def state_from_numpy(a: np.ndarray, b: np.ndarray, device=None,
                     dtype: str = "float32") -> dict:
    """Ping-pong state ``{"a", "b"}`` as tensors of ``dtype`` (a
    ``KernelConfig.dtype`` name) on ``device`` (``None`` = CUDA), copied
    from real-shaped numpy arrays.  A JAX bfloat16 array is passed as its
    float32 upcast (``np.asarray(x, np.float32)``), which is exact, so the
    port's state equals it bit for bit."""
    device = resolve_device(device)
    dt = state_dtype(dtype)
    return {k: torch.tensor(np.asarray(x, dtype=np.float32)).to(device, dt)
            for k, x in (("a", a), ("b", b))}


def state_to_numpy(state: dict, dtype=np.float32) -> tuple:
    """(a, b) as numpy copies of the state's buffers, cast to the numpy
    ``dtype``.  numpy has no bfloat16: the float32 default holds a bfloat16
    state exactly, and the JAX side casts it back
    (``jnp.asarray(x, jnp.bfloat16)``) bit for bit."""
    return tuple(state[k].detach().to("cpu", torch.float32, copy=True)
                 .numpy().astype(dtype, copy=False) for k in ("a", "b"))


def sharded_state_from_numpy(a: np.ndarray, b: np.ndarray, g) -> dict:
    """Sharded ping-pong state ``{"a", "b"}`` for the geometry ``g`` of
    ``parallel.stream_shard.build_sharded_stream``: each global real-shaped
    numpy array split into ghosted slabs of ``g.dtype`` on ``g.mesh``'s
    devices (through float32, as :func:`state_from_numpy`)."""
    return {k: stream_shard.shard_state(np.asarray(x, dtype=np.float32), g)
            for k, x in (("a", a), ("b", b))}


def sharded_state_to_numpy(state: dict, g, dtype=np.float32) -> tuple:
    """(a, b) as global real-shaped numpy arrays joined from the sharded
    state's slabs, cast to the numpy ``dtype``."""
    return tuple(stream_shard.unshard_state(state[k], g)
                 .astype(dtype, copy=False) for k in ("a", "b"))


def padded_state_from_numpy(a: np.ndarray, tm: int, device=None) -> torch.Tensor:
    """The ``(R + 2 * tm, C)`` fp32 buffer of ``tuning/exp_tile2d.py``'s
    layout on ``device`` (``None`` = CUDA): the real-shaped ``(R, C)`` numpy
    array ``a`` in data rows ``[tm, tm + R)``, zero pad rows around it."""
    a = np.asarray(a, dtype=np.float32)
    buf = torch.zeros((a.shape[0] + 2 * tm, a.shape[1]), dtype=torch.float32,
                      device=resolve_device(device))
    buf[tm:tm + a.shape[0]] = torch.from_numpy(a)
    return buf


def padded_state_to_numpy(buf: torch.Tensor, tm: int) -> np.ndarray:
    """The data rows ``[tm, rows - tm)`` of a padded buffer as numpy."""
    return buf[tm:buf.shape[0] - tm].detach().to("cpu", copy=True).numpy()
