"""Flops the levels kernels computed per stencil-cell update they stored:
``kernels.plan_counters()["flops"]`` over ``["cell_steps"]`` when the metric
is read, summed over every launch on the card since the process started.
``flops`` counts ``2 * taps - 1`` of a level's table for every cell its
levels computed, trapezoid recompute included; ``cell_steps`` the cells a
launch stored times the timesteps it advanced. A block-fused plan (K7) pays
its fused table's taps once for ``block`` timesteps. None where nothing was
counted (the CPU's plain versions, or a program without these counters)."""


def read(ctx):
    from drstencil_tpu_torch.ops import kernels

    count = kernels.plan_counters()
    if not count.get("cell_steps"):
        return None
    return count["flops"] / count["cell_steps"]
