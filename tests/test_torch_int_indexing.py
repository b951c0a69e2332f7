"""Grids past 2**31 cells on the sharded main path, and the exchange's span.

- ``ops/kernels.check_grid`` admits what the generated text can index: the
  four-card cell's slab of 776 x 2048 x 2048 fp32 cells (given as meta
  tensors, which hold no storage), and no axis of ``AXIS_LIMIT`` cells;
  ``codegen.geometry`` refuses a staged plane of 2**31 quads.
- Every global address in every text the library builds (the manifest of
  ``test_torch_geometry.py`` and the cell's slab) reaches ``size_t`` before
  its first product with an extent, read from the text by a small
  expression parser; a text fed by TMA reads the source through a tensor
  map of 64-bit extents and strides; every launch grid fits CUDA's limits.
- The one-card cells' plans keep their text byte for byte.
- On a mesh of four CPU entries the port's sharded pair of the cell's table,
  cut small, equals the one-device program bit for bit and the benchmark's
  plain fp64 reference (``stencilbench/reference.py``) within its limit.
- ``HaloExchange`` is the span ``drstencil.halo`` once a call under a
  profiler session and the shared null context otherwise; its counters
  agree with the mesh.
"""

import dataclasses
import json
import os
import re
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import StencilSpec, load_stc
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.ops.stream import level_plan
from drstencil_tpu_torch.parallel import halo, stream_shard
from drstencil_tpu_torch.tune.tuned import best_config
from drstencil_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from stencilbench import reference, work  # noqa: E402

CONFIGS = os.path.join(ROOT, "stencilbench", "configs")
MANIFEST = json.load(open(os.path.join(HERE, "torch_geometry_manifest.json")))
CELL = "3d7pt_star-3072x2048x2048"
CARDS = 4
# the cell cut small in the same four blocks (stencilbench/conftest.SMALL)
SMALL = (128, 24, 20)
TIMESTEPS = 48
MAX_REL_ERR = 2e-4          # workloads/<cell>.json's limit
# CUDA's launch limits: grid.x, grid.y and grid.z, threads a block
GRID_LIMITS = (2**31 - 1, 65535, 65535)
MAX_THREADS = 1024
# codegen.source_hash of the one-card cells' plans at 132 SMs (H100 SXM),
# fp32: the 2D cell's as the tree measured before the slab limit changed,
# the 3D cell's since its planes arrive by TMA and its winner is re-tuned
ONE_CARD_HASHES = {"2d25pt_box": "35d09af25e2685e7",
                   "3d7pt_star": "e076617eeada1f7a"}


def cell_spec(dims=None):
    spec = load_stc(os.path.join(CONFIGS, CELL + ".stc"))
    if dims is None:
        return spec
    return StencilSpec(spec.name, tuple(dims), spec.iterations, spec.taps)


def slab_plan(spec, cfg, n=CARDS):
    """(plan, slab dims) of one card's shard kernel."""
    an = stream_shard.local_analysis(spec, cfg, n)
    plan = level_plan(an, cfg)
    dims = (an.spec.dims[0] + 2 * plan.frame,) + tuple(an.spec.dims[1:])
    return plan, dims


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- the grid check -------------------------------------------------------------

def test_check_grid_admits_the_cell_slab():
    plan, dims = slab_plan(cell_spec(), best_config("3d7pt_star"))
    assert dims == (776, 2048, 2048)
    src, dst = meta(dims), meta(dims)
    assert src.numel() == 3254779904 > 2**31
    for t in (src, dst):
        kernels.check_grid("stencil3d_levels_shard", t)
    kernels.check_grid("k", meta((kernels.AXIS_LIMIT - 1, 4, 4)))


@pytest.mark.parametrize("shape,match", [
    ((kernels.AXIS_LIMIT, 2048, 2048), "axis 0"),
    ((776, 2048, kernels.AXIS_LIMIT), "axis 2"),
    ((8192, kernels.AXIS_LIMIT), "axis 1"),
], ids=["axis0", "axis2", "2d-axis1"])
def test_check_grid_refuses_what_int_cannot_index(shape, match):
    with pytest.raises(ValueError, match=match):
        kernels.check_grid("k", meta(shape))


def test_geometry_refuses_a_plane_past_int():
    """The text indexes a CTA's staged plane's quads in ``int`` too; a
    frame wide enough for 2**31 quads is refused long before, by the
    shared memory its rings would take."""
    plan, dims = slab_plan(cell_spec(), best_config("3d7pt_star"))
    frame = 2**15 + 2**14
    entries = codegen._column_entries(dims, frame)
    assert max(ey * ex for _, _, (ey, ex) in entries) // codegen.QUAD >= 2**31
    with pytest.raises(ValueError, match="shared.memory"):
        codegen.geometry(dataclasses.replace(plan, frame=frame), dims)


# -- the text's global addresses ------------------------------------------------

TOKEN = re.compile(r"\s*(\(size_t\)|[A-Za-z_]\w*|\d+|[-+*()])")


def _tokens(expr):
    out, pos = [], 0
    expr = expr.strip()
    while pos < len(expr):
        m = TOKEN.match(expr, pos)
        assert m, f"cannot read {expr[pos:]!r} in {expr!r}"
        out.append(m.group(1))
        pos = m.end()
    return out


def int_products(expr):
    """The products of two ``int`` operands in ``expr`` (C's precedence and
    left-to-right order, a cast binding tighter than ``*``): each is
    ``(left, right)`` as text.  Names and literals are ``int``; a
    ``(size_t)`` cast makes its operand ``size_t``, and so is any sum or
    product with one ``size_t`` operand."""
    toks, found = _tokens(expr), []

    def primary(i):
        if toks[i] == "(size_t)":
            _, text, j = primary(i + 1)
            return True, "(size_t)" + text, j
        if toks[i] == "(":
            wide, text, j = total(i + 1)
            assert toks[j] == ")", expr
            return wide, f"({text})", j + 1
        return False, toks[i], i + 1

    def product(i):
        wide, text, i = primary(i)
        while i < len(toks) and toks[i] == "*":
            w2, t2, i = primary(i + 1)
            if not (wide or w2):
                found.append((text, t2))
            wide, text = wide or w2, f"{text} * {t2}"
        return wide, text, i

    def total(i):
        wide, text, i = product(i)
        while i < len(toks) and toks[i] in "+-":
            op = toks[i]
            w2, t2, i = product(i + 1)
            wide, text = wide or w2, f"{text} {op} {t2}"
        return wide, text, i

    _, _, end = total(0)
    assert end == len(toks), expr
    return found


def global_offsets(text):
    """The offset added to ``src`` or ``dst`` in each address of ``text``:
    what follows ``src +`` or ``dst +`` up to the first ``,``, ``;``,
    ``:`` or ``?`` or unmatched ``)``."""
    out = []
    for m in re.finditer(r"\b(src|dst)\s*\+", text):
        depth, i = 0, m.end()
        while True:
            c = text[i]
            if c == "(":
                depth += 1
            elif c == ")":
                if depth == 0:
                    break
                depth -= 1
            elif c in ",;:?" and depth == 0:
                break
            i += 1
        out.append((m.group(1), text[m.end():i]))
    return out


def test_the_parser_finds_an_int_product():
    assert int_products("((size_t)g0 * M + gy) * N + gx") == []
    assert int_products("(size_t)(g0 + c) * C + gx") == []
    assert int_products("(g0 * M + gy) * N") == [("g0", "M"),
                                                  ("(g0 * M + gy)", "N")]
    assert int_products("(size_t)g0 + gy * N") == [("gy", "N")]
    assert global_offsets("in ? src + (size_t)g0 * N + gx : src, x);") == [
        ("src", " (size_t)g0 * N + gx ")]


def _manifest_text(item):
    spec = load_stc(os.path.join(ROOT, "benchmarks", item["stencil"] + ".stc"))
    if item["key"].startswith("tile2d"):
        an = analyze(spec, step=item["step"], require_partition=False)
        taps = kernels.tile2d_taps(an.fused, an.halo)
        args = (taps, spec.dims[0], spec.dims[1], item["tm"])
        return (codegen.tile2d_source(*args),
                codegen.tile2d_geometry(*args))
    cfg = KernelConfig.from_dict(item["config"])
    plan = level_plan(analyze(spec, cfg.step, cfg.distance,
                              cfg.merge_forward), cfg)
    dims = tuple(item["dims"])
    return (codegen.cuda_source(plan, dims, cfg.dtype, item["shard"]),
            codegen.geometry(plan, dims))


def _cell_text(dtype):
    plan, dims = slab_plan(cell_spec(), best_config("3d7pt_star"))
    return (codegen.cuda_source(plan, dims, dtype, True),
            codegen.geometry(plan, dims))


TEXTS = ([(i["key"], lambda i=i: _manifest_text(i)) for i in MANIFEST["items"]]
         + [(f"{CELL} slab {dt}", lambda dt=dt: _cell_text(dt))
            for dt in codegen.DTYPES])


@pytest.mark.parametrize("make", [m for _, m in TEXTS],
                         ids=[k for k, _ in TEXTS])
def test_global_addresses_are_size_t_and_grids_fit(make):
    text, g = make()
    offsets = global_offsets(text)
    tma = getattr(g, "tma", False)     # a tile2d_fused text has no feed
    assert {name for name, _ in offsets} == ({"dst"} if tma
                                             else {"src", "dst"})
    if tma and g.ndim == 3:
        assert "const unsigned long long dims[3] = {N, M, D};" in text
        assert ("const cuuint64_t strides[2] = {dims[0] * elem, "
                "dims[0] * dims[1] * elem};") in text
    elif tma:       # a 2D map of 8-byte elements
        assert ("const unsigned long long dims[2] = {N * sizeof(T) / 8, M};"
                in text)
        assert "const cuuint64_t strides[1] = {dims[0] * elem};" in text
    for name, expr in offsets:
        assert int_products(expr) == [], f"{name} + {expr.strip()}"
    assert len(g.grid) in (2, 3)
    for n, limit in zip(g.grid, GRID_LIMITS):
        assert 1 <= n <= limit
    assert g.threads <= MAX_THREADS


@pytest.mark.parametrize("name", sorted(ONE_CARD_HASHES))
def test_one_card_cells_keep_their_text(name):
    spec = load_stc(os.path.join(CONFIGS, name + ".stc"))
    cfg = best_config(name)
    plan = level_plan(analyze(spec, cfg.step, cfg.distance,
                              cfg.merge_forward), cfg)
    text = codegen.cuda_source(plan, tuple(spec.dims), "float32", False,
                               sms=132)
    assert codegen.source_hash(text) == ONE_CARD_HASHES[name]


# -- the cell's table on a CPU mesh ---------------------------------------------

def test_sharded_cell_equals_one_device_and_the_reference():
    spec = cell_spec(SMALL)
    cfg = best_config("3d7pt_star")
    field = torch.cat([work.make_block(SMALL, CARDS, k, 2**31 + 19, "cpu")
                       for k in range(CARDS)])
    pair, g = stream_shard.sharded_stream_pair(
        spec, cfg, halo.make_mesh(CARDS, devices=["cpu"] * CARDS))
    step = stream_shard.local_analysis(spec, cfg, CARDS).step
    pairs = work.pairs_per_request(TIMESTEPS, step)
    assert g.local_rows == SMALL[0] // CARDS
    a = stream_shard.shard_state(field, g)
    b = stream_shard.shard_state(torch.zeros(SMALL), g)
    for _ in range(pairs):
        pair(a, b)
    got = torch.from_numpy(stream_shard.unshard_state(a, g))

    prog = StencilProgram(spec, cfg, device="cpu")
    state = prog.run_pairs({"a": field.clone(), "b": torch.zeros(SMALL)},
                           pairs)
    assert torch.equal(got, state["a"])
    assert g.exchange.calls == 2 * pairs

    _, taps = reference.load_stc(os.path.join(CONFIGS, CELL + ".stc"))
    ref = reference.solve(field, taps, step, pairs)
    assert reference.max_rel_err(got, ref) <= MAX_REL_ERR


# -- the exchange's span and counters -------------------------------------------

def _sharded(n):
    spec = cell_spec((8 * n, 12, 8))
    cfg = KernelConfig(step=1)
    return stream_shard.sharded_stream_pair(
        spec, cfg, halo.make_mesh(n, devices=["cpu"] * n)), spec


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("traced", [False, True])
def test_the_exchange_is_one_span_a_call(tmp_path, monkeypatch, n, traced):
    (pair, g), spec = _sharded(n)
    if not traced:
        def refuse(name):
            raise AssertionError(f"record_function({name!r}) was built")

        monkeypatch.setattr(profiling, "record_function", refuse)
    a = stream_shard.shard_state(torch.ones(spec.dims), g)
    b = stream_shard.shard_state(torch.zeros(spec.dims), g)
    pairs = 3
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(pairs):
                pair(a, b)
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "user_annotation"]
        assert names.count("drstencil.halo") == 2 * pairs
        applies = [s for s in names if s.startswith("drstencil.apply ")]
        assert len(applies) == n * 2 * pairs
    else:
        for _ in range(pairs):
            pair(a, b)
    ex = g.exchange
    assert ex.calls == 2 * pairs
    assert ex.copies == 2 * (n - 1) * ex.calls
    M, N = spec.dims[1:]
    assert ex.bytes == ex.copies * g.halo * M * N * g.dtype.itemsize
