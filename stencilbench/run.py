"""Run one cell of the benchmark once, on the card:

    python3 -m stencilbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the card's name and power limit, then as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, the
number compared with its limit. Those numbers are also the last lines of
standard error. Exits non-zero, printing no result, where CUDA or the cards
the cell asks for are missing, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# top-level module names that may not be loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "drstencil_tpu")


def forbidden_modules(names) -> list:
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m stencilbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from stencilbench import cells, harness

    cell = cells.load_cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"stencilbench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {found}", file=sys.stderr)
        return 2
    result, lines, card = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print(f"stencilbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(card), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
