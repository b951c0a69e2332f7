"""Wall seconds the port has spent in its plan cache when the metric is
read: the kernel's text, its hash, ``nvcc`` where the library was not in
``build/plans``, and loading it (``kernels.plan_counters()["plan_s"]``), all
within ``setup_s``. None where the program made no plan (the CPU's plain
versions)."""


def read(ctx):
    from drstencil_tpu_torch.ops import kernels

    count = kernels.plan_counters()
    if count["disk_hits"] + count["builds"] == 0:
        return None
    return count["plan_s"]
