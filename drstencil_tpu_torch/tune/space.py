"""Autotuner search space and validity filter — the port of
``drstencil_tpu/tune/space.py``.

The JAX space sweeps every knob of the TPU kernel.  On Hopper only some of
them change the kernel that runs (``ops/config.py``): ``variant``,
``step``, ``trapezoid``, ``block``, ``dtype``, and the CTA's tile: ``tm``
(the segment of axis 0 it walks) and ``ch`` (its column).  The space keeps
the JAX rules on the first of those axes — the distance fallback, the
trapezoid gate, the 2D block levels and their gates, the bf16 slab and one
``xla`` candidate per step — and collapses the TPU-only axes
(``lane_mode``, ``vfuse``, ``jfix``, ``prefetch``) to one representative
each (:func:`representative`), so that no kernel is measured twice under
two labels.  ``distance`` shapes only the analysis' partition, which no
kernel reads: every valid distance gives the same kernel text
(``tests/test_torch_dist_invariance.py``), so the one distance per step
that the JAX rules pick stands for all.

The tile is swept beside every fp32 stream candidate, whose own tile is
the generator's (``tm=None, ch=None``): :func:`tile_candidates` adds the
segments of twice and of half as many segments per column and the next
narrower columns (two strips in 2D, one column in 3D, whose candidates
take three times as long to measure), each with the other knob left to
the generator, and drops a value whose geometry is the default's.  bf16
and xla candidates keep the generator's tile: bf16 shares the fp32
geometry, and the xla gold has none.

The VMEM budget becomes :func:`smem_estimate`: a config is valid when
``analyze``, ``ops/stream.level_plan`` (frame rules, ``MAX_TAPS``) and
``ops/kernels.tile_shape`` (the window's rings within 227 KB of shared
memory, a segment and column the geometry names) all accept it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

from drstencil_tpu_torch.ir.passes import (AnalysisError, analyze,
                                           default_distance, fuse, order_of,
                                           partition)
from drstencil_tpu_torch.ir.spec import StencilSpec
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops import stream as stream_mod
from drstencil_tpu_torch.ops.config import KernelConfig

STEPS = (1, 2, 3, 4, 5, 6, 8)
# narrower columns swept beside a candidate's own, by rank: a 2D strip's
# candidates cost a third of a 3D column's to measure
NARROWER = {2: 2, 3: 1}
# coefficient fusion and block levels past this many fused taps are left
# to the trapezoid (the JAX space's gate, kept so both spaces agree)
MAX_FUSED_TAPS = 64


@dataclass(frozen=True)
class Candidate:
    cfg: KernelConfig
    smem_bytes: int
    tile: Tuple[int, ...]


def representative(cfg: KernelConfig, ndim: int) -> KernelConfig:
    """``cfg`` with every knob that does nothing on Hopper set to the one
    value the space uses: ``lane_mode`` "roll" in 2D and None in 3D,
    ``vfuse=False``, ``jfix="outer"``, ``prefetch=2``,
    ``interpret=False``.  ``tm`` and ``ch`` are kept: they are the CTA's
    segment and column."""
    return cfg.replace(lane_mode="roll" if ndim == 2 else None,
                       vfuse=False, jfix="outer", prefetch=2,
                       interpret=False)


def _plan(spec: StencilSpec, cfg: KernelConfig):
    an = analyze(spec, step=cfg.step, distance=cfg.distance,
                 merge_forward=cfg.merge_forward)
    return stream_mod.level_plan(an, cfg)


def smem_estimate(spec: StencilSpec,
                  cfg: KernelConfig) -> Optional[Candidate]:
    """The streaming kernel's shared memory per CTA (its levels' rings of
    planes) and its tile (segment and column), or None where the config is
    invalid for this stencil (the FilterParams role)."""
    try:
        g = kernels.geometry(_plan(spec, cfg), spec.dims)
    except ValueError:  # AnalysisError included
        return None
    return Candidate(cfg=cfg, tile=g.tile, smem_bytes=g.smem_bytes)


def tile_candidates(spec: StencilSpec,
                    cfg: KernelConfig) -> Iterator[Candidate]:
    """``cfg`` (a valid stream config at the generator's tile) with the
    tile moved next to its default: ``tm`` the segment of twice and of
    half as many segments per column (a wave more or fewer where the
    default fills one), ``ch`` the next narrower columns (``NARROWER``: two
    strips in 2D, one column in 3D; each with the generator's segment for
    it); each valid, none whose geometry equals the default's."""
    plan = _plan(spec, cfg)
    g = kernels.geometry(plan, spec.dims)
    n, interior = g.n_segments, g.interior
    values = [(-(-interior // k), None) for k in (2 * n, -(-n // 2))
              if interior]
    names = codegen.columns(plan, spec.dims)
    for i, name in enumerate(names):
        try:
            here = kernels.geometry(dataclasses.replace(plan, column=name),
                                    spec.dims)
        except ValueError:      # rings past shared memory
            continue
        if here.tile[1:] == g.tile[1:]:     # the default's column
            narrower = names[i + 1:i + 1 + NARROWER[len(spec.dims)]]
            values += [(None, c) for c in narrower]
            break
    seen = {g}
    for tm, ch in values:
        try:
            gv = kernels.geometry(dataclasses.replace(
                plan, segment=tm, column=ch), spec.dims)
        except ValueError:
            continue
        if gv in seen:
            continue
        seen.add(gv)
        yield Candidate(cfg=cfg.replace(tm=tm, ch=ch), tile=gv.tile,
                        smem_bytes=gv.smem_bytes)


def _step_distance(spec: StencilSpec, step: int) -> Optional[int]:
    """Distance of ``step``'s representative: 0 (auto) where the default
    partition works, else the largest valid distance in the reference
    tuner's range [(step-1)*order, step*order] (pure-diagonal stencils at
    odd steps), else None (no valid distance: the step is skipped)."""
    fused = fuse(spec.taps, step)
    try:
        partition(fused, default_distance(fused))
        return 0
    except AnalysisError:
        pass
    order = order_of(spec.taps)
    for d in range(step * order, max(1, (step - 1) * order) - 1, -1):
        try:
            partition(fused, d)
            return d
        except AnalysisError:
            continue
    return None


def default_space(spec: StencilSpec) -> Iterator[Candidate]:
    """Valid candidates for one stencil: per step, the streaming kernel's
    (trapezoid, block) modes in fp32, the bf16 slab, and the xla gold.
    Factor mode stays an opt-in config (``KernelConfig.factor``) that the
    space does not sweep, as in the JAX package."""
    is3d = spec.ndim == 3
    order = order_of(spec.taps)
    seen = set()

    def emit(cfg):
        cand = smem_estimate(spec, representative(cfg, spec.ndim))
        if cand is None or cand.cfg.label() in seen:
            return
        seen.add(cand.cfg.label())
        yield cand
        if cfg.dtype == "float32":
            for tile in tile_candidates(spec, cand.cfg):
                seen.add(tile.cfg.label())
                yield tile

    for step in STEPS:
        distance = _step_distance(spec, step)
        if distance is None:
            continue
        n_fused = len(fuse(spec.taps, step))
        if step == 1:
            traps = (False,)
        elif step <= 3 and n_fused <= MAX_FUSED_TAPS:
            traps = (False, True)
        else:
            traps = (True,)
        for trap in traps:
            blocks = [1]
            # 2D block-fused levels (the JAX space leaves 3D ones out);
            # the gates are the JAX space's, so both spaces agree
            if trap and not is3d:
                blocks += [b for b in (2, 3)
                           if step % b == 0 and b < step and b * order < 6
                           and len(fuse(spec.taps, b)) <= MAX_FUSED_TAPS]
            for blk in blocks:
                yield from emit(KernelConfig(
                    variant="stream", step=step, distance=distance,
                    trapezoid=trap, block=blk))
        # bf16 state: half the bytes per cell
        for trap in traps:
            yield from emit(KernelConfig(
                variant="stream", step=step, distance=distance,
                trapezoid=trap, dtype="bfloat16"))
        cfg = KernelConfig(variant="xla", step=step, distance=distance)
        if cfg.label() not in seen:
            seen.add(cfg.label())
            yield Candidate(cfg=cfg, smem_bytes=0, tile=())
