"""Host side of the streaming stencil kernel, ported to Hopper.

The JAX package's ``build_stream_kernel`` (``drstencil_tpu/ops/stream.py``)
builds one Pallas kernel whose modes all compute the same thing: ``L``
levels of a linear tap operator on the interior ``[H, dim - H)``, with a
frozen frame of width ``H = an.halo`` on every axis:

- ``L = 1``: the coefficient-fused operator ``an.fused`` (K1);
- ``L = step``: the base taps (trapezoids K2, K3 and K4);
- ``L = step / block``: ``fuse(base, block)`` (block-hybrid K7);
- factor mode (K6): ``2 * step`` levels alternating the 3x3 factors V1 and
  V2 of a 2D radius-2 operator, each V2 level adding the residual R read
  from the level two back (``ir/factor.py``).

Here that becomes a level schedule (:func:`level_plan`) handed to one of
the CUDA kernels of ``ops/kernels.py``, built per plan from specialised
text (``ops/codegen.py``).  ``row_frame=False`` (K8) builds
the shard-local function of the multi-device path on a ghosted slab, in
factor mode too (``stencil2d_factor_levels_shard``).  The TPU geometry — tall layout,
padding, strips, frame slabs — has no counterpart; only its rejection
rules and the config checks are kept, so that both packages accept and
reject the same configurations.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from drstencil_tpu_torch.ir.factor import factor_tap_lists
from drstencil_tpu_torch.ir.passes import Analysis, fuse
from drstencil_tpu_torch.ops import kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.kernels import FactorTaps, LevelTaps
from drstencil_tpu_torch.utils.profiling import span

# trapezoid depth the JAX package compiles as a fori_loop; kept for
# vfuse's rejection rule and device_check's deep gold
DEEP_LEVELS = 5
# KernelConfig.dtype -> the state's torch dtype
STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def state_dtype(name: str) -> torch.dtype:
    """The torch dtype of the state for ``KernelConfig.dtype`` ``name``."""
    try:
        return STATE_DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype {name!r}: the port runs "
                         f"{sorted(STATE_DTYPES)} state") from None


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Asking for CUDA where there is none raises:
    the CPU path is taken only when the caller passes ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def tap_table(tap_map):
    """Taps sorted by offset (``to_rowlane``'s order, kept N-D) as
    (offsets (n, ndim) int32, coeffs (n,) float32)."""
    items = sorted(tap_map.items())
    offsets = np.array([off for off, _ in items], dtype=np.int32)
    coeffs = np.array([c for _, c in items], dtype=np.float32)
    return offsets, coeffs


def check_geometry(an: Analysis) -> None:
    """The JAX ``make_geometry`` rejections (stream.py:122-143): the frame
    is the fused axis-0 order on every axis, so a stencil wider off-axis,
    or reaching further backward on axis 0, would corrupt interior cells."""
    h = an.halo
    for a in range(1, len(an.spec.dims)):
        ra = max(abs(off[a]) for off in an.fused)
        if ra > h:
            raise ValueError(
                f"axis-{a} radius {ra} of the fused stencil exceeds its "
                f"axis-0 order {h}; asymmetric stencils wider off-axis "
                "are not supported by the streaming kernel"
            )
    neg0 = -min(off[0] for off in an.fused)
    if neg0 > h:
        raise ValueError(
            f"axis-0 negative extent {neg0} of the fused stencil exceeds "
            f"its axis-0 order {h}; asymmetric stencils reaching further "
            "backward than forward are not supported by the streaming kernel"
        )


def n_levels(an: Analysis, cfg: KernelConfig) -> int:
    """Trapezoid level count: step base applications, or step/block
    applications of the block-step coefficient-fused operator."""
    if not (cfg.trapezoid and an.step > 1):
        return 1
    blk = cfg.block or 1
    if blk == 1:
        return an.step
    if an.step % blk or blk >= an.step:
        raise ValueError(
            f"block={blk} requires step % block == 0 and block < step "
            f"(step={an.step}; block == step is plain coefficient fusion)"
        )
    return an.step // blk


def is_deep(an: Analysis, cfg: KernelConfig) -> bool:
    return (bool(cfg.trapezoid) and not cfg.factor
            and n_levels(an, cfg) >= DEEP_LEVELS)


def _lane_padded(an: Analysis, cfg: KernelConfig) -> bool:
    """Whether the JAX kernel would pad lanes (``pc > 0``); only vfuse's
    rejection rule reads it."""
    n = an.spec.dims[-1]
    return cfg.lane_mode == "slice" or (cfg.lane_mode is None and n >= 2048)


def _factor_table(tap_list):
    """A ``factor_tap_lists`` list as (offsets (n, 2) int32, coeffs (n,)
    float32), order kept."""
    return (np.array([(d, s) for d, s, _ in tap_list], dtype=np.int32),
            np.array([c for _, _, c in tap_list], dtype=np.float32))


@functools.lru_cache(maxsize=64)
def _factor_tables(taps: tuple):
    """V1, V2 and R of the tap table ``taps`` (its sorted items) as
    :func:`_factor_table`s, or None; the search runs once per table (about
    a second), not once per shard of a mesh."""
    fac = factor_tap_lists(dict(taps))
    return None if fac is None else tuple(_factor_table(t) for t in fac)


def factor_plan(an: Analysis) -> FactorTaps:
    """Factor mode's schedule (stream.py:459-474): ``2 * step`` levels of
    reach ``H / (2 * step)`` alternating V1 and V2, with the residual R on
    every V2 level; the JAX package's rejections word for word."""
    if len(an.spec.dims) != 2:
        raise ValueError("factor mode is 2D-only")
    if an.step >= DEEP_LEVELS:
        raise ValueError("factor mode requires step < DEEP_LEVELS")
    tables = _factor_tables(tuple(sorted(an.spec.taps.items())))
    if tables is None:
        raise ValueError(
            "no well-conditioned radius-2 factorization for this table"
        )
    levels = 2 * an.step
    reach = an.halo // levels
    assert reach * levels == an.halo, "fused halo must be 2*step*factor reach"
    v1, v2, r = tables
    return FactorTaps(v1=v1, v2=v2, r=r, levels=levels, reach=reach,
                      frame=an.halo)


def level_plan(an: Analysis, cfg: KernelConfig):
    """The level schedule of one application (stream.py:452-507): which
    tap table, how many levels, and each level's reach ``H / L`` — a
    ``LevelTaps``, or a ``FactorTaps`` for ``cfg.factor`` — carrying the
    CTA's segment ``cfg.tm`` and column ``cfg.ch`` (``codegen.geometry``
    checks them against a grid) and the timesteps a level advances
    (``LevelTaps.block``, which the plan counters read)."""
    check_geometry(an)
    state_dtype(cfg.dtype)
    for knob in ("tm", "ch"):
        value = getattr(cfg, knob)
        if value is not None and (isinstance(value, bool)
                                  or not isinstance(value, int) or value < 1):
            raise ValueError(f"{knob}={value!r} must be a positive int "
                             "or None")
    s_levels = n_levels(an, cfg)
    if cfg.block > 1 and not (cfg.trapezoid and an.step > 1):
        raise ValueError("block > 1 requires trapezoid with step > 1")
    if cfg.block > 1 and cfg.factor:
        raise ValueError("block > 1 is incompatible with factor mode")
    plan = factor_plan(an) if cfg.factor else None
    if cfg.vfuse:
        if not (cfg.trapezoid and an.step > 1):
            raise ValueError("vfuse requires trapezoid with step > 1")
        if cfg.factor:
            raise ValueError("vfuse is incompatible with factor mode")
        if s_levels >= DEEP_LEVELS:
            raise ValueError("vfuse requires levels < DEEP_LEVELS")
        if _lane_padded(an, cfg):
            raise ValueError(
                "vfuse requires roll lane-mode (pc=0): slice-mode inners "
                "are width N, but chained levels need width-wb inputs"
            )
    if plan is not None:
        return dataclasses.replace(plan, segment=cfg.tm, column=cfg.ch)
    # taps, and the timesteps one level of them advances
    if s_levels == 1:
        taps, block = an.fused, an.step
    elif cfg.block > 1:
        taps, block = fuse(an.spec.taps, cfg.block), cfg.block
    else:
        taps, block = an.spec.taps, 1
    h = an.halo
    reach = h // s_levels
    assert reach * s_levels == h, "fused halo must be levels*level reach"
    offsets, coeffs = tap_table(taps)
    assert int(np.abs(offsets).max()) <= reach, "a tap exceeds its level reach"
    if len(coeffs) > kernels.MAX_TAPS:
        raise ValueError(
            f"{len(coeffs)} taps per level exceed the kernels' table of "
            f"{kernels.MAX_TAPS}; use trapezoid levels instead")
    return LevelTaps(offsets=offsets, coeffs=coeffs, levels=s_levels,
                     reach=reach, frame=h, segment=cfg.tm, column=cfg.ch,
                     block=block)


def build_stream_kernel(an: Analysis, cfg: KernelConfig, device=None,
                        row_frame: bool = True):
    """Build ``f(src, dst)``: one application of the fused operator.

    ``f`` writes the interior ``[H, dim - H)`` of ``dst`` in place from
    ``src`` and leaves ``dst``'s frame untouched; it returns ``dst``.
    Both are real-shaped contiguous tensors of ``cfg.dtype`` on ``device``
    (``None`` = CUDA; ``"cpu"`` runs the kernels' plain versions).

    ``row_frame=False`` builds the shard-local function of the multi-device
    path (``parallel/stream_shard.py``), ``f(src, dst, rows)``: ``an`` is
    the analysis of one shard's slab, ``src`` and ``dst`` are that slab with
    ``H`` ghost rows (planes in 3D) on each side of axis 0, and ``rows`` is
    the ``(lo, hi)`` range of axis 0, in slab coordinates, that ``f``
    stores: every local row for an interior shard, all but the global frame
    for a shard at the edge of the mesh.  The off-axis frame stays frozen.

    On a CUDA device the plan's kernel is built here (or found in
    ``build/plans``) for the device's SM count, not at the first call: a
    failed build raises now.  On every device the plan's geometry is
    checked here, so that a segment or column the kernel would refuse
    (``codegen.geometry``) is refused on the CPU too.

    Each call of ``f`` is the span ``drstencil.apply <kernel> <plan>``
    (:func:`utils.profiling.span`): ``<plan>`` is the stem of the plan's
    library (``plan_<hash16>``), or ``plain`` on the CPU.
    """
    device = resolve_device(device)
    plan = level_plan(an, cfg)
    dtype = state_dtype(cfg.dtype)
    dims = tuple(an.spec.dims)
    if kernels.is_factor(plan):
        kernel = (kernels.stencil2d_factor_levels if row_frame
                  else kernels.stencil2d_factor_levels_shard)
    else:
        kernel = kernels.kernel_for(len(dims), shard=not row_frame)
    if not row_frame:
        dims = (dims[0] + 2 * plan.frame,) + dims[1:]
    sms = kernels.sm_count(device)
    kernels.geometry(plan, dims, sms)
    library = "plain"
    if device.type == "cuda":
        library = kernels.plan_kernel(plan, dims, dtype, not row_frame,
                                      sms).stem
    # the span's name, built once: its gpu_user_annotation names the plan
    # of each kernel in the card's rows of a trace
    name = f"drstencil.apply {kernel.name} {library}"

    def f(src: torch.Tensor, dst: torch.Tensor, *rows) -> torch.Tensor:
        with span(name):
            if src.device != device or dst.device != device:
                raise ValueError(f"tensors on {src.device}/{dst.device}, "
                                 f"kernel built for {device}")
            if tuple(src.shape) != dims:
                raise ValueError(f"grid {tuple(src.shape)} is not {dims}")
            if src.dtype != dtype or dst.dtype != dtype:
                raise TypeError(f"tensors of {src.dtype}/{dst.dtype}, "
                                f"kernel built for {dtype}")
            return kernel(src, dst, plan, *rows)

    return f
