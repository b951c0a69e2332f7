"""The texts the benchmark's cells run, and the feeds and widths that
``test_torch_geometry.test_default_tile_text_is_unchanged`` does not reach,
pinned by SHA-256 (at ``codegen.SM_COUNT``, the SMs of an H100 SXM).

A plan's library is named by the hash of its text (``codegen.source_hash``),
so an unchanged text loads the same binary and keeps its span name.  The
pins, in ``torch_text_pins.json``:

- each cell's plan in fp32 and bf16: ``2d25pt_box`` ``fu3`` at the
  generator's tile on 8192² (a windowed 2D plan fed by TMA, its levels in
  partial sums), and at the earlier winner's ``tm=132``,
  ``3d7pt_star`` at the generator's tile on 512³ (a windowed 3D plan fed
  by TMA), and its shard build on the 776 x 2048 x 2048 slab of the
  four-card cell (``stream_shard.local_analysis`` over four shards, with
  ``2 * frame`` ghost planes);
- in fp32 and bf16 on widths no multiple of 4 or of 8: a windowed 3D plan
  on the register feed, a windowed 2D plan on the register feed, a 3D ring
  plan and a factor plan.
"""

import hashlib
import json
import os

import pytest

from drstencil_tpu_torch.ir.passes import analyze
from drstencil_tpu_torch.ir.spec import StencilSpec, load_stc
from drstencil_tpu_torch.ops import codegen
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import level_plan
from drstencil_tpu_torch.parallel import stream_shard

from conftest import BENCH_DIR

HERE = os.path.dirname(os.path.abspath(__file__))
PINS = json.load(open(os.path.join(HERE, "torch_text_pins.json")))


def pinned_text(item):
    """``codegen.cuda_source`` of one pin: the plan of ``config`` on the
    stencil at ``spec_dims`` (over ``shards`` shards: a slab), on the grid
    ``dims``."""
    spec = load_stc(os.path.join(BENCH_DIR, item["stencil"] + ".stc"))
    spec = StencilSpec(spec.name, tuple(item["spec_dims"]), spec.iterations,
                       spec.taps)
    cfg = KernelConfig.from_dict(item["config"])
    if item["shards"] > 1:
        an = stream_shard.local_analysis(spec, cfg, item["shards"])
    else:
        an = analyze(spec, cfg.step, cfg.distance, cfg.merge_forward)
    return codegen.cuda_source(level_plan(an, cfg), tuple(item["dims"]),
                               cfg.dtype, item["shards"] > 1,
                               sms=codegen.SM_COUNT)


@pytest.mark.parametrize("item", PINS["items"],
                         ids=[i["key"] for i in PINS["items"]])
def test_pinned_text_is_unchanged(item):
    text = pinned_text(item)
    # the path the pin is there for
    for mark in item["marks"]:
        assert mark in text
    assert hashlib.sha256(text.encode()).hexdigest() == item["sha256"]
