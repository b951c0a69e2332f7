"""The bench of a cell on more than one card: the port's sharded main path.

``ShardedSolve`` keeps ``harness.Solve``'s interface, so a loop of
``drivers/`` runs it unchanged. It builds
``parallel.stream_shard.sharded_stream_pair`` of the port's winner over a
one-axis mesh of the cell's cards (``cuda:0`` to ``cuda:<chips - 1>``; on
the CPU, the CPU named once a card), which splits axis 0 in equal blocks,
one slab a card with ``H`` ghost planes on each side. Each card makes its
own block of the field (``work.make_block``, as the configuration's
``field_blocks`` states) and keeps it as its slab of the reset source; no
global field exists on a card or on the host. A request copies each block
into the real planes of its slab of ``a`` and runs ``pairs`` sharded pairs.

The check is on dependence cones (``cones``): at ``load``, before any
request, the crops of the initial field around the boxes are cut from the
blocks into host memory; a kept answer is the boxes of ``a``, copied on
each card into buffers made at ``load``; after the run each box is held to
the fp64 reference run on its crop.
"""

from __future__ import annotations

import random

import torch
from drstencil_tpu_torch.ir.spec import load_stc as port_load_stc
from drstencil_tpu_torch.parallel import halo, stream_shard
from drstencil_tpu_torch.tune.tuned import best_config

from stencilbench import cones, reference
from stencilbench.work import (Work, computed_timesteps, make_block,
                               pairs_per_request, work_of)


def _extent(sl) -> tuple:
    return tuple(s.stop - s.start for s in sl)


class ShardedSolve:
    """The sharded program for a cell of ``chips`` > 1, its sharded
    ping-pong state, each card's block of the field of the seed loaded
    last, and the boxes of the answers kept for the check (the same
    requests as ``harness.Solve`` keeps). ``dtype`` overrides the
    configuration's state dtype."""

    def __init__(self, cell, device, dtype=None):
        spec = port_load_stc(cell.stc_path)
        if list(spec.dims) != list(cell.config["dims"]):
            raise ValueError(f"{cell.stc_path} is {spec.dims}, its "
                             f"configuration says {cell.config['dims']}")
        n = cell.chips
        if cell.config.get("field_blocks", 1) != n:
            raise ValueError(f"{cell.name} runs on {n} cards: its "
                             f"configuration makes its field in "
                             f"{cell.config.get('field_blocks', 1)} blocks")
        if not cell.box:
            raise ValueError(f"workloads/{cell.name}.json states no box "
                             "for the cone check")
        self.cell = cell
        self.cfg = best_config(cell.config["stencil"]).replace(
            dtype=dtype or cell.config["dtype"])
        names = ([device] * n if torch.device(device).type == "cpu" else
                 [f"cuda:{i}" for i in range(n)])
        mesh = halo.make_mesh(n, devices=names)
        self.pair, self.g = stream_shard.sharded_stream_pair(spec, self.cfg,
                                                             mesh)
        self.devices = mesh.devices
        self.device = self.devices[0]
        self.step = stream_shard.local_analysis(spec, self.cfg, n).step
        self.pairs = pairs_per_request(cell.traffic["timesteps"], self.step)
        self.state = {key: [torch.zeros(self.g.slab_dims, dtype=self.g.dtype,
                                        device=dev) for dev in self.devices]
                      for key in ("a", "b")}
        self.a0 = [None] * n

    def _part(self, b: cones.Box, k: int, offset: int):
        """Slices of box ``b`` inside block ``k``, axis 0 shifted by
        ``offset`` (the ghost planes of a slab), or None outside it."""
        (lo, hi), rows = b, self.g.local_rows
        first, last = max(lo[0], k * rows), min(hi[0], (k + 1) * rows)
        if first >= last:
            return None
        shift = offset - k * rows
        return ((slice(first + shift, last + shift),)
                + tuple(slice(a, z) for a, z in zip(lo[1:], hi[1:])))

    def load(self, seed: int) -> None:
        """Make each card's block of the field of ``seed``, cut the crops
        of its boxes, and draw the requests to keep."""
        g, mix = self.g, self.cell.traffic
        self.seed = seed
        _, taps = reference.load_stc(self.cell.stc_path)
        widen = cones.widening(taps, computed_timesteps(mix["timesteps"],
                                                        self.step))
        self.boxes = cones.boxes(g.dims, g.n_shards, seed, self.cell.box)
        crops = {label: cones.crop(b, g.dims, widen)
                 for label, b in self.boxes.items()}
        pieces = {label: [] for label in self.boxes}
        for k, dev in enumerate(self.devices):
            self.a0[k] = None
            block = make_block(g.dims, g.n_shards, k, seed, dev)
            for label, c in crops.items():
                sl = self._part(c, k, 0)
                if sl is not None:
                    pieces[label].append(block[sl].to("cpu"))
            self.a0[k] = block.to(g.dtype)
            del block
        self.crops = {label: (c, torch.cat(pieces[label]))
                      for label, c in crops.items()}
        self._parts = {label: [(k, sl) for k in range(g.n_shards)
                               if (sl := self._part(b, k, g.halo))
                               is not None]
                       for label, b in self.boxes.items()}
        self._snaps = [] if mix["readback"] else [
            {label: [torch.empty(_extent(sl), dtype=g.dtype,
                                 device=self.devices[k]) for k, sl in parts]
             for label, parts in self._parts.items()}
            for _ in range(mix["check_samples"])]
        self.samples = sorted(random.Random(seed).sample(
            range(mix["sample_from"]), mix["check_samples"]))
        self.forget()

    def reset(self) -> None:
        h, rows = self.g.halo, self.g.local_rows
        for slab, block in zip(self.state["a"], self.a0):
            slab[h:h + rows].copy_(block)

    def solve(self) -> None:
        a, b = self.state["a"], self.state["b"]
        for _ in range(self.pairs):
            self.pair(a, b)

    def readback(self):
        return stream_shard.unshard_state(self.state["a"], self.g)

    def _live(self) -> dict:
        """The boxes of ``a`` as it stands: per box, its parts' views."""
        a = self.state["a"]
        return {label: [a[k][sl] for k, sl in parts]
                for label, parts in self._parts.items()}

    def answered(self, index: int, out=None) -> None:
        """Keep request ``index``'s boxes if it is sampled: cut from the
        returned host array, or copied on each card where nothing is
        returned."""
        self.last = out
        if index in self.samples:
            if out is None:
                snaps = self._snaps[self.samples.index(index)]
                out = {label: [buf.copy_(view) for buf, view in
                               zip(snaps[label], views)]
                       for label, views in self._live().items()}
            self.kept[index] = out

    def forget(self) -> None:
        self.kept: dict = {}
        self.last = None

    def sync(self) -> None:
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def work(self) -> Work:
        dims, taps = reference.load_stc(self.cell.stc_path)
        return work_of(dims, len(taps), self.cell.traffic["timesteps"],
                       self.step, self.cfg.dtype)

    def _on_host(self, kept) -> dict:
        """Box label -> the box's cells in host memory, from a returned
        global array or from per-card parts."""
        if isinstance(kept, dict):
            return {label: torch.cat([p.to("cpu") for p in parts])
                    for label, parts in kept.items()}
        return {label: torch.from_numpy(kept[cones.within(b)])
                for label, b in self.boxes.items()}

    def answers(self) -> dict:
        """The kept answers' boxes by label; the last one's are cut from
        ``a`` itself where the mix returns nothing."""
        out = {f"request {i}": self._on_host(v)
               for i, v in sorted(self.kept.items())}
        out["last request"] = self._on_host(
            self._live() if self.last is None else self.last)
        return out

    def release(self) -> dict:
        """Free the program and its state on every card; return the
        answers' boxes."""
        answers = self.answers()
        self.pair = self.state = self._snaps = None
        self.a0 = [None] * len(self.devices)
        self.forget()
        for dev in self.devices:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    torch.cuda.empty_cache()
        return answers

    def check(self, answers: dict) -> dict:
        """Each answer's ``max_rel_err`` on each box against the fp64
        reference of its crop, run on the first card."""
        _, taps = reference.load_stc(self.cell.stc_path)
        refs = {label: cones.reference_box(field.to(self.device),
                                           self.boxes[label], c, taps,
                                           self.step, self.pairs)
                for label, (c, field) in self.crops.items()}
        return {f"{name}, {label}": reference.max_rel_err(boxes[label], ref)
                for name, boxes in answers.items()
                for label, ref in refs.items()}
