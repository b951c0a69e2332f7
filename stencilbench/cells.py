"""Finds a cell and everything it names, by name, in files of their own.

- ``workloads/<cell>.json``: the limit of each number the cell's
  correctness check compares and, for a cell on more than one card, the
  ``box`` its cone check compares (``cones``);
- ``configs/<config>.json``: the configuration, beside its frozen `.stc`;
- ``traffic/<mix>.json``: the mix's parameters, which name a loop in
  ``drivers/<driver>.py``;
- ``metrics/<metric>.py``: one reader per metric, ``read(ctx)`` returning a
  number or None where it finds nothing to read;
- ``BENCHMARK.json`` beside this folder: a cell's configuration, traffic mix
  and chips, and which metrics it reports, with their units.

A later cell, mix, loop or metric is added as files and entries; nothing
here names one. A cell's ``chips`` picks its bench: ``harness.Solve`` on
one card, ``sharded.ShardedSolve`` on more.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _path(root: str, kind: str, name: str, ext: str) -> str:
    if not _NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(root, kind, name + ext)
    if not os.path.isfile(path):
        raise ValueError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                         f"named {name!r} ({path})")
    return path


def load_json(root: str, kind: str, name: str) -> dict:
    with open(_path(root, kind, name, ".json")) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """``<root>/<kind>/<name>.py`` as a module of its own."""
    path = _path(root, kind, name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"stencilbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: str) -> dict:
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    root: str
    config: dict
    stc_path: str
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list
    box: Optional[list] = None

    def driver(self):
        return load_module(self.root, "drivers", self.traffic["driver"])

    def metrics(self, trace: bool) -> list:
        """``(name, unit, reader)`` of the metrics this cell reports: its
        end-to-end ones, or with ``trace`` its per-layer ones."""
        return [(m["name"], m["unit"],
                 load_module(self.root, "metrics", m["name"]).read)
                for m in (self.per_layer if trace else self.end_to_end)
                if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise ValueError(f"BENCHMARK.json has no cell named {name!r}")
    config = load_json(root, "configs", entry["config"])
    check = load_json(root, "workloads", name)
    return Cell(name=name, root=root, config=config,
                stc_path=os.path.join(root, "configs", config["stc"]),
                traffic=load_json(root, "traffic", entry["traffic"]),
                limits=check["limits"], chips=entry["chips"],
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                box=check.get("box"))
