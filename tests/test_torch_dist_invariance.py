"""``distance`` is analysis-only in the port too, after
``tests/test_dist_invariance.py``: ``ops/stream.level_plan`` reads the fused
table, the base taps, the halo and the step, never the partition, so the
emitted program's kernel (``CUDA_SOURCE``) must be IDENTICAL across the
reference's whole valid distance window ((step-1)*order <= dist <=
step*order, intersected with what the analysis accepts).  Only the
provenance lines that echo the distance back — the command, the analysis
summary, the plan line's config label and the kernel's first comment line
(the label again) — are normalized away.

It also settles what the tuner's space assumes: one distance per step
stands for all (``tune/space.py``'s docstring).
"""

import os
import re

import numpy as np
import pytest

from drstencil_tpu_torch import emit as emit_mod
from drstencil_tpu_torch.ir.passes import analyze, order_of
from drstencil_tpu_torch.ir.spec import load_stc
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import level_plan

from conftest import ALL_STENCILS, BENCH_DIR
from test_dist_invariance import valid_dists as jax_valid_dists


def stc_path(name):
    return os.path.join(BENCH_DIR, name + ".stc")


def valid_dists(name: str, step: int):
    """The reference's validity window, intersected with the distances the
    port's analysis accepts."""
    spec = load_stc(stc_path(name))
    order = order_of(spec.taps)
    out = []
    for dist in range(max((step - 1) * order, 1), step * order + 1):
        try:
            analyze(spec, step=step, distance=dist)
        except Exception:
            continue
        out.append(dist)
    return out


def normalize(text: str) -> str:
    """Drop the provenance lines that echo the distance back."""
    text = re.sub(r"^// (\w+) \[[^\]]*\]:", r"// \1 []:", text, flags=re.M)
    return "\n".join(
        ln for ln in text.splitlines()
        if not ln.startswith(("#   command :", "#   analysis:",
                              "#   plan    :")))


def cuda_source_of(text: str) -> str:
    return text.split("CUDA_SOURCE = r'''\n")[1].split("'''")[0]


def plan_fields(plan):
    return (plan.offsets.tobytes(), plan.coeffs.tobytes(), plan.levels,
            plan.reach, plan.frame)


@pytest.mark.parametrize("step", [1, 2, 3])
@pytest.mark.parametrize("name", ALL_STENCILS)
@pytest.mark.parametrize("trapezoid", [False, True], ids=["fused", "trap"])
def test_emitted_kernel_invariant_across_dist(name, step, trapezoid):
    dists = valid_dists(name, step)
    # the port accepts the distances the JAX package accepts; the default
    # distance (0) is held against them too
    assert dists == jax_valid_dists(name, step)
    spec = load_stc(stc_path(name))
    with open(stc_path(name)) as f:
        stc = f.read()
    texts, plans, rejected = {}, {}, {}
    for dist in [0] + dists:
        cfg = KernelConfig(step=step, distance=dist, trapezoid=trapezoid)
        try:
            texts[dist] = emit_mod.emit(stc, name, step=step, distance=dist,
                                        trapezoid=trapezoid)
            plans[dist] = plan_fields(level_plan(analyze(spec, step, dist),
                                                 cfg))
        except ValueError as e:
            rejected[dist] = str(e)
    # the default distance may reuse nothing (3d9pt_cross at odd steps);
    # a plan past the kernels' table is rejected at every distance alike
    if "No data to reuse" in rejected.get(0, ""):
        del rejected[0]
    assert len(set(rejected.values())) <= 1
    assert not rejected or not texts, (rejected, sorted(texts))
    if not texts:
        return
    base = min(texts)
    for dist, text in texts.items():
        assert normalize(cuda_source_of(text)) == normalize(
            cuda_source_of(texts[base])), (name, step, base, dist)
        assert normalize(text) == normalize(texts[base]), (name, step, dist)
        assert plans[dist] == plans[base]
    # the labels, which name the distance, are all that told them apart
    labels = {re.search(r"config=(\S+)", t).group(1) for t in texts.values()}
    assert len(labels) == len(texts)


def test_the_fused_table_and_halo_ignore_the_distance():
    """What ``level_plan`` reads of the analysis is the same at every valid
    distance of every benchmark stencil at steps 1-3."""
    for name in ALL_STENCILS:
        spec = load_stc(stc_path(name))
        for step in (1, 2, 3):
            ans = [analyze(spec, step, d) for d in valid_dists(name, step)]
            for an in ans[1:]:
                assert an.fused == ans[0].fused and an.halo == ans[0].halo
                assert an.step == ans[0].step
                assert np.array_equal(sorted(an.spec.taps),
                                      sorted(ans[0].spec.taps))
