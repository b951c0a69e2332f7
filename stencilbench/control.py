"""Readings that set a cell's limits: the compared number of the program on
many seeds, and of the control, the program's own bfloat16 state, on a few.

    python3 -m stencilbench.control --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--out readings.jsonl]

Each seed runs one request through the cell's own loop (reset, solve and,
where the mix returns results, ``final_a``) on the card at the cell's size,
and its answer is held to the plain reference. Prints one JSON line per
seed, and with ``--out`` appends them to that file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from stencilbench import cells, harness


def readings(cell, seeds, dtype, device):
    """``(seed, max_rel_err, reference seconds)`` of one request per seed."""
    bench = harness.bench_for(cell, device, dtype)
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
    runs = (("program", None, args.seeds),
            ("control", "bfloat16", args.control_seeds))
    for role, dtype, seeds in runs:
        seeds = [int(s) for s in seeds.split(",") if s]
        if not seeds:
            continue
        for seed, err, ref_s in readings(cell, seeds, dtype, "cuda"):
            line = json.dumps({"workload": cell.name, "role": role,
                               "dtype": dtype or cell.config["dtype"],
                               "seed": seed, harness.CHECKED: err,
                               "reference_s": ref_s})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
