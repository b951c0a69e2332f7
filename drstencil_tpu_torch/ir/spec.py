"""`.stc` stencil-spec front-end.

File format (compatible with the reference's whitespace-token format,
reference: drstencil.hpp:52-78 / drstencil_2d.hpp:48-73):

    [L <int>]          # 3D only: size of the outermost (streaming) axis
    M <int>
    N <int>
    iterations <int>
    stencil
    <off...> <coeff>   # one line per tap: ndim ints then a float

Unlike the reference parser (which silently ignores unknown tokens and
leaves fields uninitialized — e.g. the shipped ``2d9pt_cross.stc`` contains
the typo ``iteratioins`` and the generated program reads uninitialized
memory), this parser reports unknown tokens with a did-you-mean hint and
validates that every required field is present.

A copy of ``drstencil_tpu/ir/spec.py``: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Mapping, Tuple

Offset = Tuple[int, ...]
Taps = Mapping[Offset, float]

_KNOWN_KEYS = ("L", "M", "N", "iterations", "stencil")


class StcError(ValueError):
    """Raised on malformed .stc input."""


@dataclass(frozen=True)
class StencilSpec:
    """A parsed stencil specification.

    ``dims`` is ``(M, N)`` for 2D or ``(L, M, N)`` for 3D; offsets in
    ``taps`` use the same axis order, with axis 0 the streaming axis
    (j in 2D, k in 3D — matching the reference's tuple conventions).
    """

    name: str
    dims: Tuple[int, ...]
    iterations: int
    taps: Mapping[Offset, float] = field(hash=False)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def npoints(self) -> int:
        return len(self.taps)

    def __post_init__(self):
        if self.ndim not in (2, 3):
            raise StcError(f"only 2D/3D stencils supported, got ndim={self.ndim}")
        for off in self.taps:
            if len(off) != self.ndim:
                raise StcError(
                    f"tap offset {off} has {len(off)} coords, expected {self.ndim}"
                )
        if not self.taps:
            raise StcError("stencil has no taps")

    def sorted_taps(self):
        """Taps in sorted offset order (matches C++ std::map iteration)."""
        return sorted(self.taps.items())

    def radius(self) -> Tuple[int, ...]:
        """Per-axis max |offset| — the true halo extent per axis."""
        return tuple(
            max(abs(off[a]) for off in self.taps) for a in range(self.ndim)
        )

    def to_stc(self) -> str:
        """Serialize back to .stc text (round-trips through parse_stc)."""
        keys = ("L", "M", "N") if self.ndim == 3 else ("M", "N")
        lines = [f"{k} {v}" for k, v in zip(keys, self.dims)]
        lines += ["", f"iterations {self.iterations}", "", "stencil"]
        for off, coe in self.sorted_taps():
            lines.append(" ".join(str(x) for x in off) + f" {coe!r}")
        return "\n".join(lines) + "\n"


def _suggest(token: str) -> str:
    best, score = None, 0.0
    for key in _KNOWN_KEYS:
        common = sum(1 for a, b in zip(token, key) if a == b)
        s = common / max(len(token), len(key))
        if s > score:
            best, score = key, s
    return f" (did you mean '{best}'?)" if best and score >= 0.5 else ""


def parse_stc(text: str, name: str = "stencil") -> StencilSpec:
    """Parse `.stc` text into a :class:`StencilSpec`.

    Mirrors the reference token stream (drstencil.hpp:52-78) but with
    strict validation and error reporting.
    """
    # strip '#' comments (extension over the reference grammar — its
    # parser silently ignores unknown tokens; ours must not)
    text = "\n".join(line.split("#", 1)[0] for line in text.splitlines())
    tokens = text.split()
    sizes: dict[str, int] = {}
    iterations = None
    taps: dict[Offset, float] = {}
    i = 0
    n = len(tokens)
    in_stencil = False

    def take_int(key: str) -> int:
        nonlocal i
        if i >= n:
            raise StcError(f"'{key}' at end of file with no value")
        tok = tokens[i]
        i += 1
        try:
            return int(tok)
        except ValueError:
            raise StcError(f"expected integer after '{key}', got {tok!r}") from None

    while i < n:
        tok = tokens[i]
        i += 1
        if tok in ("L", "M", "N"):
            sizes[tok] = take_int(tok)
        elif tok == "iterations":
            iterations = take_int(tok)
        elif tok == "stencil":
            in_stencil = True
            break
        else:
            raise StcError(f"unknown token {tok!r} in {name}.stc{_suggest(tok)}")

    if in_stencil:
        ndim = 3 if "L" in sizes else 2
        rest = tokens[i:]
        if len(rest) % (ndim + 1) != 0:
            raise StcError(
                f"stencil table in {name}.stc has {len(rest)} tokens, "
                f"not a multiple of {ndim + 1} (offsets + coeff)"
            )
        for row in range(0, len(rest), ndim + 1):
            try:
                off = tuple(int(t) for t in rest[row : row + ndim])
                coe = float(rest[row + ndim])
            except ValueError:
                raise StcError(
                    f"bad stencil row {rest[row:row + ndim + 1]} in {name}.stc"
                ) from None
            if not math.isfinite(coe):
                raise StcError(f"non-finite coefficient at offset {off}")
            taps[off] = taps.get(off, 0.0) + coe

    for key in ("M", "N"):
        if key not in sizes:
            raise StcError(f"missing grid size '{key}' in {name}.stc")
    if iterations is None:
        raise StcError(f"missing 'iterations' in {name}.stc")
    if not taps:
        raise StcError(f"missing or empty 'stencil' table in {name}.stc")

    dims = (
        (sizes["L"], sizes["M"], sizes["N"]) if "L" in sizes else (sizes["M"], sizes["N"])
    )
    return StencilSpec(name=name, dims=dims, iterations=iterations, taps=taps)


def load_stc(path: str) -> StencilSpec:
    """Load a `.stc` file; the spec name is the file stem."""
    name = os.path.splitext(os.path.basename(path))[0]
    with open(path, "r") as f:
        return parse_stc(f.read(), name=name)
