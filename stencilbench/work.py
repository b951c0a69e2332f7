"""What one request is: its input field, its timesteps and its least time.

A request advances a fresh field ``timesteps`` timesteps. The program runs
ping-pong pairs of ``2 * step`` fused timesteps, so it computes
``pairs * 2 * step`` timesteps, at least the requested ones. The work that
``kernel_roofline_pct`` holds the kernels to does not depend on how the
program implements it: ``2 * taps - 1`` flops per cell per requested
timestep (one product and ``taps - 1`` fused multiply-adds of the `.stc`
table), and one read of the input field and one write of the result.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from dataclasses import dataclass

import torch

PEAKS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def make_field(dims, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    """The initial field of ``seed``: uniform in [0, 100), made on
    ``device`` by one call of its own generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    field = torch.rand(tuple(dims), generator=gen, device=device,
                       dtype=torch.float32).mul_(100.0)
    return field.to(dtype)


def block_seed(seed: int, block: int) -> int:
    """The seed of axis-0 block ``block`` of a field made per block: 64
    bits of the SHA-256 of ``"<seed>/<block>"``."""
    digest = hashlib.sha256(f"{seed}/{block}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def make_block(dims, blocks: int, block: int, seed: int, device,
               dtype=torch.float32) -> torch.Tensor:
    """Block ``block`` of ``blocks`` equal blocks along axis 0 of a field
    made per block: ``make_field`` of the block's own shape and seed."""
    if dims[0] % blocks:
        raise ValueError(f"axis 0 of {tuple(dims)} is not {blocks} blocks")
    shape = (dims[0] // blocks,) + tuple(dims[1:])
    return make_field(shape, block_seed(seed, block), device, dtype)


def field_of(config: dict, dims, seed: int, device,
             dtype=torch.float32) -> torch.Tensor:
    """The initial field of a configuration: ``make_field`` of the whole
    grid, or where the configuration states ``field_blocks``, its axis-0
    blocks made one by one (``make_block``) and joined."""
    blocks = config.get("field_blocks", 1)
    if blocks == 1:
        return make_field(dims, seed, device, dtype)
    return torch.cat([make_block(dims, blocks, k, seed, device, dtype)
                      for k in range(blocks)])


def pairs_per_request(timesteps: int, step: int) -> int:
    return -(-timesteps // (2 * step))


def computed_timesteps(timesteps: int, step: int) -> int:
    return pairs_per_request(timesteps, step) * 2 * step


def card_peaks(name: str):
    """``(bytes/s, flop/s)`` of the card named ``name``, or None for a card
    the table does not hold."""
    with open(PEAKS_PATH) as f:
        for fragment, bps, fps in json.load(f)["cards"]:
            if fragment in name:
                return bps, fps
    return None


@dataclass(frozen=True)
class Work:
    """The counts of one request of a configuration."""

    cells: int
    taps: int
    timesteps: int
    step: int
    itemsize: int

    @property
    def flops(self) -> int:
        return (2 * self.taps - 1) * self.cells * self.timesteps

    @property
    def bytes(self) -> int:
        return 2 * self.cells * self.itemsize

    @property
    def computed_timesteps(self) -> int:
        return computed_timesteps(self.timesteps, self.step)

    def least_seconds(self, peaks) -> float:
        """The least time the card takes for the request's work: the larger
        of its bytes at the HBM peak and its flops at the fp32 peak."""
        bps, fps = peaks
        return max(self.bytes / bps, self.flops / fps)


def work_of(dims, taps: int, timesteps: int, step: int, dtype: str) -> Work:
    return Work(cells=math.prod(dims), taps=taps, timesteps=timesteps,
                step=step, itemsize=ITEMSIZE[dtype])
