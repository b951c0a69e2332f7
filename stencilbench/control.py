"""Readings that set a cell's limits: the compared number of the program on
many seeds, and of the control, one precision below the cell's state, on a
few.

    python3 -m stencilbench.control --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--out readings.jsonl]

The control (``control_bench``) of a float32 cell is the program's own
bfloat16 state. A bfloat16 cell's is ``Bits4``: the plain reference in the
program's place, its state held to float8 e4m3's four significant bits.
Each seed runs one request through the cell's own loop (reset, solve and,
where the mix returns results, ``final_a``) on the card at the cell's size,
and its answer is held to the plain reference. Prints one JSON line per
seed, naming the cell's control, and with ``--out`` appends them to that
file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from stencilbench import cells, harness, reference

# the control of each state dtype: the nearest precision below it
CONTROLS = {"float32": "bfloat16", "bfloat16": "bits4"}


def hold4(x: torch.Tensor) -> torch.Tensor:
    return reference.round_bits_(x, 4)


class Bits4(harness.Solve):
    """The control of a bfloat16 cell: the plain reference put in the
    program's place and computed one precision below the cell's state. The
    program's fused operator, frame and ping-pong in fp32 arithmetic, with
    the state held to 4 significant bits (float8 e4m3's precision, its
    exponent unbounded): the input once, then each application's
    destination, rounded to nearest even at the store, as the program rounds
    its bfloat16 state. It solves on the bench's own state, at the cell's
    size; the values it keeps are bfloat16 exactly."""

    def solve(self) -> None:
        _, taps = reference.load_stc(self.cell.stc_path)
        a = self.state["a"]
        a.copy_(reference.solve(a, taps, self.step, self.pairs,
                                torch.float32, store=hold4))


def control_of(cell) -> str:
    """The name of the cell's control: the precision one below its state's."""
    dtype = cell.config["dtype"]
    if dtype not in CONTROLS:
        raise ValueError(f"{cell.name}: no control below {dtype!r} state")
    return CONTROLS[dtype]


def control_bench(cell, device):
    """The bench that runs the cell's control in the program's place."""
    control = control_of(cell)
    if control == "bfloat16":
        return harness.bench_for(cell, device, "bfloat16")
    if cell.chips > 1:
        raise ValueError(f"{cell.name}: the {control} control runs on one "
                         "card")
    return Bits4(cell, device)


def readings(cell, seeds, device, control=False):
    """``(seed, max_rel_err, reference seconds)`` of one request per seed,
    of the program or, with ``control``, of the cell's control."""
    bench = (control_bench(cell, device) if control
             else harness.bench_for(cell, device))
    driver = cell.driver()
    for seed in seeds:
        bench.load(seed)
        driver.run(bench, cell.traffic, requests=1)
        t0 = time.perf_counter()
        errors = bench.check(bench.answers())
        yield seed, max(errors.values()), time.perf_counter() - t0
    bench.release()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m stencilbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    control = control_of(cell)
    runs = (("program", False, cell.config["dtype"], args.seeds),
            ("control", True, control, args.control_seeds))
    for role, is_control, dtype, seeds in runs:
        seeds = [int(s) for s in seeds.split(",") if s]
        if not seeds:
            continue
        for seed, err, ref_s in readings(cell, seeds, "cuda", is_control):
            line = json.dumps({"workload": cell.name, "role": role,
                               "control": control, "dtype": dtype,
                               "seed": seed, harness.CHECKED: err,
                               "reference_s": ref_s})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
