"""The gold operator in plain PyTorch — the port of ``ops/xla_ref.py``.

The JAX package leaves this operator to XLA: the fused stencil as a sum of
statically shifted slices over the interior.  Here it is plain torch, the
on-card gold for ``StencilProgram.device_check`` and the ``"xla"`` variant.
The kernel path never calls it.
"""

from __future__ import annotations

import torch

from drstencil_tpu_torch.ir.passes import Analysis


def apply_interior(an: Analysis):
    """Return ``f(src, dst) -> dst`` writing the fused operator of ``src``
    into the interior of ``dst`` in place; boundary cells of ``dst`` keep
    their values (reference semantics: kernels never write outside
    ``[halo, dim - halo)``)."""
    taps = sorted(an.fused.items())
    halo = an.halo
    dims = an.spec.dims
    nd = len(dims)
    inner = tuple(d - 2 * halo for d in dims)
    interior = tuple(slice(halo, halo + n) for n in inner)

    def f(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        acc = None
        for off, coe in taps:
            sl = src[tuple(slice(halo + off[a], halo + off[a] + inner[a])
                           for a in range(nd))]
            # accumulate in fp32 whatever the state dtype and round once
            # at the store, as the JAX gold does (xla_ref.py:39-48)
            term = float(coe) * sl.to(torch.float32)
            acc = term if acc is None else acc.add_(term)
        dst[interior] = acc.to(dst.dtype)
        return dst

    return f
