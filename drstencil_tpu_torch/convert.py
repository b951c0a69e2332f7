"""Carry specs, configs and state across from the JAX package.

The port imports nothing of ``drstencil_tpu``, so objects cross as plain
fields and numpy arrays: a JAX ``StencilSpec`` as its fields, a
``KernelConfig`` as its dict, and ping-pong state as the JAX side's
real-shaped arrays (already unpadded by its ``unpad_state``).
"""

from __future__ import annotations

import numpy as np
import torch

from drstencil_tpu_torch.ir.spec import StencilSpec
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import resolve_device


def spec_from_fields(name: str, dims, iterations: int, taps) -> StencilSpec:
    return StencilSpec(name=name, dims=tuple(dims), iterations=int(iterations),
                       taps=dict(taps))


def config_from_dict(d: dict) -> KernelConfig:
    return KernelConfig.from_dict(d)


def state_from_numpy(a: np.ndarray, b: np.ndarray, device=None) -> dict:
    """Ping-pong state ``{"a", "b"}`` as float32 tensors on ``device``
    (``None`` = CUDA), copied from real-shaped numpy arrays."""
    device = resolve_device(device)
    return {
        "a": torch.tensor(np.asarray(a, dtype=np.float32), device=device),
        "b": torch.tensor(np.asarray(b, dtype=np.float32), device=device),
    }


def state_to_numpy(state: dict) -> tuple:
    """(a, b) as numpy copies of the state's buffers."""
    return tuple(state[k].detach().to("cpu", copy=True).numpy()
                 for k in ("a", "b"))
