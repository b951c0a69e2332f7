"""Property-based differential fuzzing of the port, after
``tests/test_fuzz.py``: random 2D / 3D stencils x step x trapezoid x block
x the CTA's tile (``tm``, ``ch``) through ``StencilProgram(device="cpu")``
(the kernels' plain versions) and through the plan's kernel text
(``codegen.cuda_source``) compiled by ``g++`` against
``tests/cuda_emulation``, both against the fp64 golden model at
``test_fuzz.py``'s tolerance.

A config that one package rejects is rejected by the other, with one
exception: ``tm`` and ``ch`` mean different things in the two packages (the
TPU strip's rows and accumulation chunk; the Hopper CTA's segment and
column), so each package gets values valid in its own meaning, and a
rejection that the JAX package words in terms of ``tm`` is not compared.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from drstencil_tpu.ir.passes import AnalysisError as JAnalysisError
from drstencil_tpu.ops.config import KernelConfig as JConfig
from drstencil_tpu.ops.runner import StencilProgram as JProgram
from drstencil_tpu_torch import convert
from drstencil_tpu_torch.ir import golden
from drstencil_tpu_torch.ir.passes import AnalysisError
from drstencil_tpu_torch.ops import codegen
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.ops.stream import level_plan

from test_fuzz import random_spec, ratio_spec
from test_torch_codegen import emulated

REJECTED = (AnalysisError, JAnalysisError, ValueError)


def accepted(make):
    """(whether ``make()`` builds, the rejection's message)."""
    try:
        make()
    except REJECTED as e:
        return False, str(e)
    return True, ""


def random_tile(rng, an, cfg):
    """A ``(tm, ch)`` valid for ``cfg``'s plan on ``an``'s grid, each knob
    ``None`` (the generator's) or drawn from what the geometry names."""
    plan = level_plan(an, cfg)
    g = codegen.geometry(plan, an.spec.dims)
    segs = [None]
    if g.interior >= g.warmup:
        segs.append(int(rng.integers(g.warmup, g.interior + 1)))
    cols = [None]
    for c in codegen.columns(plan, an.spec.dims):
        try:
            codegen.geometry(plan, an.spec.dims, column=c)
            cols.append(c)
        except ValueError:
            continue
    return (segs[int(rng.integers(0, len(segs)))],
            cols[int(rng.integers(0, len(cols)))])


def fuzz_case(tmp_path, rng, jspec, step, trap, blk, vf, lane, jtm, seed):
    """One random config in both packages: the same acceptance, then the
    port at a random tile against the fp64 golden, on the CPU and as its
    kernel text under the emulation."""
    spec = convert.spec_from_fields(jspec.name, jspec.dims, jspec.iterations,
                                    jspec.taps)
    jcfg = JConfig(variant="stream", step=step, tm=jtm, trapezoid=trap,
                   lane_mode=lane, vfuse=vf, block=blk, interpret=True)
    cfg = convert.config_from_dict(asdict(jcfg.replace(interpret=False)))
    j_ok, j_msg = accepted(lambda: JProgram(jspec, jcfg))
    p_ok, p_msg = accepted(lambda: StencilProgram(spec, cfg, device="cpu"))
    if j_ok or "tm" not in j_msg:
        assert j_ok == p_ok, (cfg.label(), j_msg, p_msg)
    if not p_ok:
        return None
    prog = StencilProgram(spec, cfg, device="cpu")
    tm, ch = random_tile(rng, prog.an, cfg)
    cfg = cfg.replace(tm=tm, ch=ch)
    prog = StencilProgram(spec, cfg, device="cpu")
    scale = max(1.0, abs(sum(spec.taps.values()))) ** (2 * step) * 100
    max_err, _ = prog.check(seed=seed, pairs=1)
    assert max_err < 1e-5 * scale, f"{cfg.label()}: max_err={max_err}"

    # the kernel text of the same plan: one pair under the emulation
    plan = level_plan(prog.an, cfg)
    launch = emulated(codegen.cuda_source(plan, spec.dims, "float32", False),
                      tmp_path)
    a0, b0 = golden.random_state(spec, seed)
    a, b = (torch.from_numpy(x.astype(np.float32)) for x in (a0, b0))
    b = launch(a, b)
    a = launch(b, a)
    ga, gb = (x.astype(np.float32).astype(np.float64) for x in (a0, b0))
    gb = golden.apply_interior(ga, gb, prog.an.fused, prog.an.halo)
    ga = golden.apply_interior(gb, ga, prog.an.fused, prog.an.halo)
    max_err, _ = golden.check_error(a.numpy(), ga, prog.an.halo)
    assert max_err < 1e-5 * scale, f"{cfg.label()} emulated: {max_err}"
    return cfg


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_2d(tmp_path, seed):
    rng = np.random.default_rng(500 + seed)
    jspec = random_spec(rng, 2, (48, 256))
    step = int(rng.integers(1, 7))
    trap = bool(rng.integers(0, 2)) and step > 1
    lane = str(rng.choice(["roll", "slice"]))
    vf = bool(rng.integers(0, 2)) and trap and lane == "roll"
    blk = 1
    if trap and bool(rng.integers(0, 2)):
        cands = [b for b in (2, 3) if step % b == 0 and b < step]
        if cands:
            blk = int(rng.choice(cands))
    fuzz_case(tmp_path, rng, jspec, step, trap, blk, vf, lane,
              int(rng.choice([16, 24, 32])), seed)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_column_tables(tmp_path, seed):
    """``test_fuzz.py``'s ratio tables (columns that are multiples of each
    other), radius 2: the port has no column chains, so they are one more
    corpus of dense 5x5 tables."""
    rng = np.random.default_rng(700 + seed)
    jspec = ratio_spec(rng, (48, 256))
    step = int(rng.integers(1, 3))
    fuzz_case(tmp_path, rng, jspec, step, step > 1, 1, False, "roll", 24,
              seed)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_3d(tmp_path, seed):
    rng = np.random.default_rng(600 + seed)
    jspec = random_spec(rng, 3, (24, 16, 128))
    step = int(rng.integers(1, 3))
    trap = bool(rng.integers(0, 2)) and step > 1
    vf = bool(rng.integers(0, 2)) and trap
    fuzz_case(tmp_path, rng, jspec, step, trap, 1, vf, None,
              8 * (2 + 4 * step), seed)


def test_fuzz_draws_tiles():
    """The corpus is not vacuous: over the 2D seeds, draws of
    ``test_fuzz_2d`` take tiles of their own."""
    tiles = 0
    for seed in range(8):
        rng = np.random.default_rng(500 + seed)
        jspec = random_spec(rng, 2, (48, 256))
        step = int(rng.integers(1, 7))
        trap = bool(rng.integers(0, 2)) and step > 1
        lane = str(rng.choice(["roll", "slice"]))
        vf = bool(rng.integers(0, 2)) and trap and lane == "roll"
        blk = 1
        if trap and bool(rng.integers(0, 2)):
            cands = [b for b in (2, 3) if step % b == 0 and b < step]
            if cands:
                blk = int(rng.choice(cands))
        spec = convert.spec_from_fields(jspec.name, jspec.dims,
                                        jspec.iterations, jspec.taps)
        cfg = KernelConfig(step=step, trapezoid=trap, lane_mode=lane,
                           vfuse=vf, block=blk)
        ok, _ = accepted(lambda: StencilProgram(spec, cfg, device="cpu"))
        if not ok:
            continue
        prog = StencilProgram(spec, cfg, device="cpu")
        int(rng.choice([16, 24, 32]))
        if random_tile(rng, prog.an, cfg) != (None, None):
            tiles += 1
    assert tiles >= 2
