"""Kernel configuration — a copy of ``drstencil_tpu.ops.config``.

``KernelConfig`` keeps every field, ``from_dict`` and ``label()`` of the
JAX package unchanged, so the entries of ``benchmarks/tuned.json`` load
as they are and name the same configurations.  Most fields were tuned for
the TPU's Mosaic pipeline; on Hopper they mean:

- ``step``, ``distance``, ``merge_forward``: unchanged (analysis knobs);
- ``trapezoid``, ``block``: unchanged — they pick the tap table and the
  number of levels each launch applies (``ops/stream.level_plan``);
- ``tm``, ``ch``: the CTA's tile (``ops/codegen.geometry``), ``None`` for
  the generator's own.  ``tm`` is the segment: the planes (2D: rows) of
  axis 0 one CTA walks, as the JAX package's ``tm`` is the tile's rows
  along the streamed axis; shorter than the segment's warm-up
  (``Geometry.warmup``) it is rejected unless it covers the whole
  interior.  ``ch`` is the column: the CTA's output cells across the
  other axes, a 2D strip's width ``ex - 2 * hx`` for an ``ex`` of
  ``codegen.STRIP_2D``, a 3D column's ``TY * TX`` for a pair of
  ``codegen.COLUMNS_3D``, named before either is cut to the grid; a value
  that names no entry, or whose rings exceed shared memory, is rejected.
  The TPU's values (``benchmarks/tuned.json``) mean other things and
  never reach this geometry (``tune/tuned.tpu_config``);
- ``lane_mode``, ``jfix``: no-ops — lane rolls and the j-frame restore
  have no counterpart; the frozen frame falls out of never writing it.
  ``lane_mode`` still gates ``vfuse`` as in the JAX package, so both
  reject the same configs;
- ``prefetch``: a no-op — the Mosaic window-fetch depth (K9).  The
  streamed kernels always stage ahead (``ops/codegen.py``: the next source
  plane is requested before a step's levels and staged after them, a
  windowed 2D plan's rows several steps ahead by TMA or ``cp.async``);
  staging where the plane is used measured slower on every tuned winner
  in both dtypes (PERF.md), so the depth is the generator's constant and
  not a knob;
- ``vfuse``: the same kernel as the scratch trapezoid (levels chain
  through shared-memory rings either way);
- ``factor=True``: a 2D radius-2 operator runs as ``2 * step`` levels of
  its 3x3 factors V1 and V2 plus the residual read two levels back
  (``ir/factor.py``, kernel ``stencil2d_factor_levels``); other tables
  and 3D grids are rejected with the JAX package's messages;
- ``dtype``: the state's storage type, ``"float32"`` or ``"bfloat16"``.
  Both run through the same kernels' fp32 or bf16 builds; either way every
  level is computed in fp32 and rounded to the state's type once per
  launch, as the JAX kernel does;
- ``interpret``: ignored — the CPU path is chosen by the tensors' device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class KernelConfig:
    """Configuration for one stencil kernel (see the module docstring for
    what each TPU-era field does on Hopper)."""

    variant: str = "stream"
    step: int = 1
    distance: int = 0  # 0 = auto (fused extent >> 1)
    merge_forward: int = 5
    tm: Optional[int] = None
    ch: Optional[int] = None
    dtype: str = "float32"
    lane_mode: Optional[str] = None
    trapezoid: bool = False
    factor: bool = False
    vfuse: bool = False
    block: int = 1
    jfix: str = "outer"
    prefetch: int = 2
    interpret: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        """Build from a (possibly legacy) dict, ignoring unknown keys —
        ledgers/tuned.json may carry fields from older versions."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def replace(self, **kw) -> "KernelConfig":
        return dataclasses.replace(self, **kw)

    def replace_variant(self, variant: str) -> "KernelConfig":
        return dataclasses.replace(self, variant=variant)

    def label(self) -> str:
        """Compact config name for logs, identical to the JAX package's
        (e.g. 'stream_fu4_tm128_trap_vf_roll')."""
        parts = [self.variant, f"fu{self.step}"]
        if self.distance:
            parts.append(f"d{self.distance}")
        if self.tm is not None:
            parts.append(f"tm{self.tm}")
        if self.ch is not None:
            parts.append(f"ch{self.ch}")
        if self.trapezoid:
            parts.append("trap" if self.block == 1 else f"trap_b{self.block}")
        if self.vfuse:
            parts.append("vf")
        if self.factor:
            parts.append("fac")
        if self.lane_mode:
            parts.append(self.lane_mode)
        if self.prefetch != 2:
            parts.append(f"pf{self.prefetch}")
        if self.jfix != "outer":
            parts.append("jfk")
        if self.dtype != "float32":
            parts.append(self.dtype)
        return "_".join(parts)
