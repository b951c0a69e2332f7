"""``python -m drstencil_tpu_torch.cli`` — front door to the compiler.

The port of ``drstencil_tpu/cli.py``: the same flags, emitting a standalone
program specialised to one stencil + config whose kernel is CUDA C++ for
Hopper (``drstencil_tpu_torch/emit.py``).  ``--bx`` sets ``tm`` and
``--ch`` sets ``ch`` as in the JAX CLI, here the CTA's segment (rows of
axis 0 it walks) and column (0 = the generator's choice); the TPU-only
flags (``--lane-mode``, ``--jfix``, ``--prefetch``) are accepted, checked
as the JAX emitter checks them and recorded in the program's header; they
change nothing else.

    python -m drstencil_tpu_torch.cli benchmarks/2d5pt_star.stc --step 4 \
        --trapezoid --check -o out.py && python out.py --check
"""

from __future__ import annotations

import argparse
import sys

from drstencil_tpu_torch import emit as emit_mod


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        prog="drstencil",
        description="Generate a data-reusing GPU stencil program (CUDA).",
    )
    ap.add_argument("stc", help="input .stc file")
    ap.add_argument("-o", "--output", default="out.py")
    ap.add_argument("--step", type=int, default=1)
    ap.add_argument("--dist", type=int, default=0)
    ap.add_argument("--bx", type=int, default=0,
                    help="rows (planes in 3D) of axis 0 one CTA streams "
                    "through: the segment (0 = auto)")
    ap.add_argument("--merge-forward", type=int, default=5)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--trapezoid", action="store_true",
                    help="for --step > 1: apply the base stencil step "
                    "times through shared memory instead of coefficient "
                    "fusion (FLOPs linear in step)")
    ap.add_argument("--lane-mode", default="", choices=["", "slice", "roll"],
                    help="TPU lane-shift strategy; recorded, and gates "
                    "--vfuse as in the JAX package")
    ap.add_argument("--ch", type=int, default=0,
                    help="output cells of one CTA across the other axes: a "
                    "2D strip's width, a 3D column's TY*TX (0 = auto)")
    ap.add_argument("--vfuse", action="store_true",
                    help="with --trapezoid: the JAX package's value-fused "
                    "levels; the same kernel here")
    ap.add_argument("--block", type=int, default=1,
                    help="with --trapezoid: each level applies the "
                    "block-step coefficient-fused base operator "
                    "(step/block levels; default 1)")
    ap.add_argument("--jfix", default="outer", choices=["outer", "kernel"],
                    help="TPU 3D j-frame restoration; recorded, no effect")
    ap.add_argument("--prefetch", type=int, default=2, choices=[1, 2],
                    help="TPU window-fetch pipeline depth; recorded, no "
                    "effect")
    ap.add_argument("--shard", type=int, default=0,
                    help="emit the multi-device program over n shards "
                    "(ghosted slabs, halo rows copied between devices)")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--gold", action="store_true")
    ap.add_argument("--dump-analysis", action="store_true")
    args = ap.parse_args(argv)

    with open(args.stc) as f:
        text = f.read()
    name = args.stc.rsplit("/", 1)[-1].rsplit(".", 1)[0]

    try:
        if args.dump_analysis:
            print(emit_mod.dump_analysis(
                text, name, step=args.step, distance=args.dist,
                merge_forward=args.merge_forward))
            return 0
        program = emit_mod.emit(
            text, name, step=args.step, distance=args.dist,
            merge_forward=args.merge_forward, tm=args.bx,
            check=args.check, gold_only=args.gold, dtype=args.dtype,
            trapezoid=args.trapezoid, lane_mode=args.lane_mode, ch=args.ch,
            shards=args.shard, vfuse=args.vfuse, block=args.block,
            prefetch=args.prefetch, jfix=args.jfix,
            cli_line=" ".join(argv),
        )
    except ValueError as e:  # StcError, AnalysisError, EmitError, level_plan
        print(str(e), file=sys.stderr)
        return 1
    with open(args.output, "w", encoding="utf-8") as f:
        f.write(program)
    return 0


if __name__ == "__main__":
    sys.exit(main())
