"""Shared-memory loads the levels kernels ran for their taps per
stencil-cell update they stored: ``kernels.plan_counters()["smem_loads"]``
over ``["cell_steps"]`` when the metric is read, summed over every launch on
the card since the process started. ``smem_loads`` counts, per thread, the
load instructions of each level's quad step for every quad its levels
computed, trapezoid recompute included (a load that only a warp's end lanes
run, for those lanes); the feeds' staging and factor mode's levels add
none. ``cell_steps`` is the cells a launch stored times the timesteps it
advanced. None where nothing was counted (the CPU's plain versions, or a
program without these counters)."""


def read(ctx):
    from drstencil_tpu_torch.ops import kernels

    count = kernels.plan_counters()
    if not count.get("smem_loads") or not count.get("cell_steps"):
        return None
    return count["smem_loads"] / count["cell_steps"]
