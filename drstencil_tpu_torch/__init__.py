"""drstencil_tpu_torch — the PyTorch/CUDA port of drstencil_tpu.

The same stencil-compiler framework, run on an NVIDIA Hopper GPU:

- the ``.stc`` front-end and the analysis passes (temporal fusion,
  data-reuse partition, halo analysis) live in :mod:`drstencil_tpu_torch.ir`,
  pure Python copies of the JAX package's modules;
- the streaming stencil kernel of ``drstencil_tpu.ops.stream`` becomes
  hand-written CUDA kernels, written as text per plan
  (:mod:`drstencil_tpu_torch.ops.codegen`) and built and bound in
  :mod:`drstencil_tpu_torch.ops.kernels`: levels streamed along axis 0
  through shared-memory rings that never write a frame cell, for 2D and
  3D, with shard-local builds for the multi-device path and a factor-mode
  build for 2D radius-2 operators;
- :mod:`drstencil_tpu_torch.ops.runner` runs the warmup, timed ping-pong
  and golden-check protocol on torch tensors;
- :mod:`drstencil_tpu_torch.parallel` decomposes the grid over a mesh of
  devices with halo exchange, and :mod:`drstencil_tpu_torch.entry` holds
  the single-device and multi-device entry points.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``,
where every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"

from drstencil_tpu_torch.ir.spec import StencilSpec, parse_stc, load_stc
from drstencil_tpu_torch.ir.passes import (
    fuse,
    order_of,
    default_distance,
    partition,
    Partition,
    analyze,
    Analysis,
)

__all__ = [
    "StencilSpec",
    "parse_stc",
    "load_stc",
    "fuse",
    "order_of",
    "default_distance",
    "partition",
    "Partition",
    "analyze",
    "Analysis",
]
