"""Program emitter — the port of ``native/emit.hpp`` + ``native_bridge.emit``.

``emit()`` writes a self-contained Python program specialised to one
analysed stencil + config, as the JAX package's emitter does, with the
target changed from a Pallas kernel to a CUDA one:

- the constants (``DIMS``, ``ITERATIONS``, ``STEP``, ``H``, ``LEVELS``,
  ``REACH``, ``TILE``, ``DTYPE``) are module globals;
- ``CUDA_SOURCE`` holds the specialised kernel as text: the library's
  own kernel of that one plan (``ops/codegen.cuda_source``, which
  ``ops/kernels.plan_kernel`` builds for the library), streamed along
  axis 0 with four outputs per thread, with column, segment, frame,
  levels and dims as ``constexpr``, the segments sized for
  ``codegen.SM_COUNT`` SMs (an H100 SXM's; the library sizes them for the
  card it runs on), the levels written out one by one,
  and the taps of a level unrolled into straight-line ``fmaf``s with
  immediate shared-memory offsets and float literals — no tap table is
  passed.  ``build_call("cuda")`` compiles it with ``nvcc`` for ``sm_90a``
  at first use and binds it with ``ctypes``;
- the same specialised operator is emitted as plain torch code (unrolled
  slices in the library's summation order), which ``build_call("cpu")``
  returns: the role ``--interpret`` plays in the JAX artifact;
- ``init_state``, ``golden_apply``, and a ``main()`` with the warmup +
  timed ping-pong protocol and the fp64 NumPy gold check (``--check``);
- ``gold_only`` emits the golden-model-only program, ``shards=n`` the
  multi-device program (one process, ghosted slabs on ``--devices``, the
  kernel with an axis-0 store range, halo rows by ``Tensor.copy_``).

The emitted file imports ``torch``, ``numpy`` and the standard library,
and nothing of this package.

This module is written on the port's own IR (``ir/passes.analyze``,
``ops/stream.level_plan``, ``ops/kernels.tile_shape``).  It takes
``native_bridge.emit``'s arguments.  ``tm`` and ``ch`` (``--bx`` and
``--ch``, 0 = the generator's choice) are the CTA's segment and column
(``ops/config.py``), rejected where the geometry names no such tile; the
TPU-only ones (``lane_mode``, ``jfix``, ``prefetch``) are checked as the
JAX emitter checks them, recorded in the program's header, and change
nothing else.  Factor mode has no emitter in either package.
"""

from __future__ import annotations

import json
from typing import Union

from drstencil_tpu_torch.ir.passes import Analysis, analyze
from drstencil_tpu_torch.ir.spec import StencilSpec, parse_stc
from drstencil_tpu_torch.ops import codegen, kernels
from drstencil_tpu_torch.ops.codegen import (EmitError, cuda_source,
                                             float32_literal, literal_value)
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.stream import level_plan

__all__ = ["EmitError", "analysis_json", "cuda_source", "dump_analysis",
           "emit", "float32_literal", "literal_value", "plain_level_source"]


def analysis_json(an: Analysis) -> dict:
    """The analysis as ``native_bridge.analyze`` returns it (the keys and
    ordering of ``drs::to_json``): order, distance, window, low, high, the
    fused taps and the forward/backward sets in sorted-offset order."""
    return {
        "order": an.order,
        "distance": an.distance,
        "window": an.part.window,
        "low": an.part.low,
        "high": an.part.high,
        "fused": [[list(p), c] for p, c in sorted(an.fused.items())],
        "forward": [[list(p) for p in sorted(g)] for g in an.part.forward],
        "backward": [list(p) for p in sorted(an.part.backward)],
    }


def _dims_tuple(dims) -> str:
    return "(" + "".join(f"{d}, " for d in dims) + ")"


def _load_spec(spec_or_stc_text: Union[StencilSpec, str],
               name: str) -> StencilSpec:
    if isinstance(spec_or_stc_text, StencilSpec):
        return spec_or_stc_text
    return parse_stc(spec_or_stc_text, name or "stencil")


def emit(spec_or_stc_text: Union[StencilSpec, str], name: str = "stencil",
         step: int = 1, distance: int = 0, merge_forward: int = 5,
         tm: int = 0, check: bool = False, gold_only: bool = False,
         dtype: str = "float32", trapezoid: bool = False,
         lane_mode: str = "", ch: int = 0, shards: int = 0,
         vfuse: bool = False, block: int = 1, prefetch: int = 2,
         jfix: str = "outer", factor: bool = False,
         cli_line: str = "(via drstencil_tpu_torch.emit)") -> str:
    """Emit a specialised standalone program; returns its text.

    ``spec_or_stc_text`` is a ``StencilSpec`` or ``.stc`` text (parsed
    under ``name``).  With ``shards=n`` the leading dim is divided by
    ``n`` for the kernel's geometry and ``DIMS`` stays global.  Raises
    ``EmitError`` (or the IR's ``StcError``/``AnalysisError``, or
    ``level_plan``'s ``ValueError``) on what the JAX emitter and library
    reject."""
    spec = _load_spec(spec_or_stc_text, name)
    if factor:
        raise EmitError("factor mode has no emitter: an artifact would hold "
                        "the unfactored kernel under a '_fac' label")
    if shards < 0:
        raise EmitError("shards must be >= 0")
    if shards > 0:
        if spec.dims[0] % shards:
            raise EmitError("leading dim not divisible by shards")
        spec = StencilSpec(spec.name, (spec.dims[0] // shards,)
                           + tuple(spec.dims[1:]), spec.iterations, spec.taps)
    if prefetch not in (1, 2):
        raise EmitError("prefetch depth must be 1 or 2")
    block = block if block > 0 else 1
    an = analyze(spec, step, distance, merge_forward)
    h = an.halo
    if jfix not in ("outer", "kernel"):
        raise EmitError("--jfix must be 'outer' or 'kernel'")
    if jfix == "kernel" and spec.ndim != 3:
        raise EmitError("--jfix kernel is 3D-only")
    if jfix == "kernel" and (spec.dims[1] % 8 or 2 * h > 8):
        raise EmitError("--jfix kernel needs M % 8 == 0 and 2*halo <= 8")
    trap = trapezoid and an.step > 1
    if vfuse and not trap:
        raise EmitError("--vfuse requires --trapezoid with --step > 1")
    if block > 1 and not trap:
        raise EmitError("--block requires --trapezoid with --step > 1")
    if trap and block > 1 and (an.step % block or block >= an.step):
        raise EmitError(
            "--block requires step % block == 0 and block < step "
            "(block == step is plain coefficient fusion)")
    cfg = KernelConfig(
        variant="stream", step=step, distance=distance,
        merge_forward=merge_forward, tm=tm or None, ch=ch or None,
        dtype=dtype, lane_mode=lane_mode or None, trapezoid=trapezoid,
        vfuse=vfuse, block=block, jfix=jfix, prefetch=prefetch)
    plan = level_plan(an, cfg)      # the library's remaining rejections
    slab = ((spec.dims[0] + 2 * plan.frame,) + tuple(spec.dims[1:])
            if shards else tuple(spec.dims))
    tile = kernels.tile_shape(plan, slab, codegen.SM_COUNT)

    global_dims = ((spec.dims[0] * shards,) + tuple(spec.dims[1:])
                   if shards else tuple(spec.dims))
    o = []
    o.append("#!/usr/bin/env python3")
    o.append("# Generated by drstencil_tpu_torch (Hopper/CUDA target) — "
             "do not edit.")
    o.append(f"#   source  : {spec.name}.stc  dims={_dims_tuple(spec.dims)}"
             f" iterations={spec.iterations}")
    o.append(f"#   command : drstencil {cli_line}")
    o.append(f"#   analysis: step={an.step} order={an.order} "
             f"dist={an.distance} window={an.part.window} "
             f"taps(fused)={len(an.fused)}")
    o.append(f"#   plan    : levels={plan.levels} reach={plan.reach} "
             f"frame={plan.frame} taps/level={len(plan.coeffs)} "
             f"tile={'x'.join(map(str, tile))} config={cfg.label()}")
    o.append(f"#   tile    : bx={tm} ch={ch} (0 = the generator's), "
             f"segments sized for {codegen.SM_COUNT} SMs")
    o.append("#   knobs recorded (TPU-only, no effect here): "
             f"lane_mode={lane_mode or 'auto'} jfix={jfix} "
             f"prefetch={prefetch}")
    o.append("import argparse, time")
    o.append("import numpy as np")
    o.append("")
    o.append(f"DIMS = {_dims_tuple(global_dims)}")
    if shards:
        o.append(f"DIMS_LOCAL = {_dims_tuple(spec.dims)}"
                 "  # per-shard problem (the kernel's slab adds 2*H rows)")
        o.append(f"NSHARDS = {shards}")
    o.append(f"ITERATIONS = {spec.iterations}")
    o.append(f"STEP = {an.step}")
    o.append(f"H = {h}")
    o.append(f'DTYPE = "{dtype}"')
    o.append("FUSED_TAPS = [  # (offset, coefficient) — fused operator")
    for off, coe in sorted(an.fused.items()):
        o.append(f"    ({_dims_tuple(off)}, {float(coe)!r}),")
    o.append("]")
    text = "\n".join(o) + "\n" + _GOLDEN
    if gold_only:
        return text + _GOLD_MAIN

    o = [""]
    o.append("import ctypes, hashlib, os, shutil, subprocess, tempfile")
    o.append("import torch")
    o.append("import torch.nn.functional as F")
    o.append("")
    o.append(f"NDIM = {spec.ndim}")
    o.append(f"LEVELS = {plan.levels}   # levels one launch applies")
    o.append(f"REACH = {plan.reach}    # cells one level reaches; "
             "H = LEVELS * REACH")
    o.append(f"TILE = {_dims_tuple(tile)}  # output cells of one CTA: a "
             "segment of axis 0, then its column")
    o.append(f"GRID_DIMS = {_dims_tuple(slab)}  # what one launch takes"
             + ("  (a ghosted slab)" if shards else ""))
    o.append(f"SHARD = {bool(shards)}")
    o.append(f"CHECK = {bool(check)}  # emitted with --check")
    o.append("")
    o.append("CUDA_SOURCE = r'''")
    o.append(cuda_source(plan, slab, dtype, bool(shards), spec.name,
                         cfg.label(), sms=codegen.SM_COUNT))
    o.append("'''")
    o.append("")
    o.append(plain_level_source(plan))
    text += "\n".join(o) + _RUNTIME
    return text + (_SHARD_MAIN if shards else _MAIN)


# -- the specialised plain torch version ---------------------------------------

def plain_level_source(plan: kernels.LevelTaps) -> str:
    """Python text of ``_level(cur)``: one 'valid' level of the plan as
    unrolled shifted slices, in ``ops/kernels._valid_level``'s order and
    arithmetic (a float32 coefficient times a float32 slice, summed left
    to right), so that both give the same bits."""
    ndim, r = plan.ndim, plan.reach
    o = ["def _level(cur):",
         '    """One level: the unrolled taps on the cells at least REACH '
         'from every face."""']
    for a in range(ndim):
        o.append(f"    n{a} = cur.shape[{a}] - {2 * r}")
    first = True
    for off, c in zip(plan.offsets.tolist(), plan.coeffs.tolist()):
        sl = ", ".join(f"{r + d}:{r + d} + n{a}" for a, d in enumerate(off))
        term = f"{float(c)!r} * cur[{sl}]"
        o.append("    acc = " + (term if first else f"acc + {term}"))
        first = False
    o.append("    return acc")
    return "\n".join(o) + "\n"


# -- static program text --------------------------------------------------------

_GOLDEN = r'''

def golden_apply(src, dst):
    """fp64 reference: fused operator on the interior, frame preserved."""
    out = dst.copy()
    nd = src.ndim
    inner = tuple(d - 2 * H for d in src.shape)
    acc = np.zeros(inner, dtype=src.dtype)
    for off, coe in FUSED_TAPS:
        sl = tuple(slice(H + off[a], src.shape[a] - H + off[a]) for a in range(nd))
        acc += coe * src[sl]
    out[tuple(slice(H, d - H) for d in src.shape)] = acc
    return out


def init_state(seed, dtype):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 100.0, size=DIMS).astype(dtype)
    b = np.zeros(DIMS, dtype=dtype)
    return a, b
'''

_GOLD_MAIN = r'''

def main(argv=None):
    ap = argparse.ArgumentParser(description="golden-model program")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=max(1, -(-ITERATIONS // (2 * STEP))))
    args = ap.parse_args(argv)
    a, b = init_state(args.seed, np.float64)
    t0 = time.perf_counter()
    for _ in range(args.pairs):
        b = golden_apply(a, b)
        a = golden_apply(b, a)
    print(f"golden computation time: {1000*(time.perf_counter()-t0):.3f} ms")
    print(f"checksum: {a[H:-H].sum():.6e}")


if __name__ == "__main__":
    main()
'''

_RUNTIME = r'''

def plain_apply(src, dst, rows=None):
    """Plain torch version of the kernel: zero-pad by H, LEVELS unrolled
    levels in fp32, one rounding into the stored region of ``dst``
    (``rows`` = the axis-0 store range of a slab, default [H, dim - H))."""
    cur = F.pad(src.to(torch.float32), (H,) * (2 * src.dim()))
    for _ in range(LEVELS):
        cur = _level(cur)
    lo, hi = rows if rows is not None else (H, dst.shape[0] - H)
    region = (slice(lo, max(lo, hi)),) + tuple(
        slice(H, s - H) for s in dst.shape[1:])
    dst[region] = cur[region].to(dst.dtype)
    return dst


NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}[DTYPE]


def build_dir():
    """Where the kernel is built: ``build/emitted`` of the checkout this
    file lies in (a directory that holds ``drstencil_tpu_torch/csrc``),
    else a directory under the system's temporary one."""
    d = os.path.dirname(os.path.abspath(__file__))
    while True:
        if os.path.isdir(os.path.join(d, "drstencil_tpu_torch", "csrc")):
            return os.path.join(d, "build", "emitted")
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.join(tempfile.gettempdir(), "drstencil_emitted")
        d = parent


def _nvcc():
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def compile_kernel():
    """Compile CUDA_SOURCE with nvcc for sm_90a unless a library of the
    same source and flags is there; returns (path, compiler log)."""
    digest = hashlib.sha256(
        (CUDA_SOURCE + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]
    out_dir = build_dir()
    path = os.path.join(out_dir, f"libemitted_{digest}.so")
    log = ""
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        cu = os.path.join(out_dir, f"emitted_{digest}.{os.getpid()}.cu")
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(cu, "w") as f:
            f.write(CUDA_SOURCE)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, cu],
                                  capture_output=True, text=True)
        finally:
            os.remove(cu)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    return path, log


class Kernel:
    """The compiled kernel: ``kernel(src, dst[, rows])`` writes the stored
    region of ``dst`` in place and returns it.  ``launches`` counts its
    launches; ``build_log`` is what nvcc printed (empty on a cache hit)."""

    def __init__(self):
        path, self.build_log = compile_kernel()
        self._lib = ctypes.CDLL(path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        self._lib.launch.argtypes = [ptr, ptr] + [i32] * (2 * SHARD) + [ptr]
        self._lib.launch.restype = i32
        self._lib.error_string.argtypes = [i32]
        self._lib.error_string.restype = ctypes.c_char_p
        self.launches = 0

    def __call__(self, src, dst, rows=None):
        for x in (src, dst):
            if (tuple(x.shape) != GRID_DIMS or x.dtype != TORCH_DTYPE
                    or x.device.type != "cuda" or not x.is_contiguous()):
                raise ValueError(
                    f"the kernel takes contiguous {DTYPE} CUDA tensors of "
                    f"{GRID_DIMS}, got {tuple(x.shape)} {x.dtype} on "
                    f"{x.device}")
        if src.device != dst.device:
            raise ValueError("src and dst lie on two devices")
        if src.untyped_storage().data_ptr() == dst.untyped_storage().data_ptr():
            raise ValueError("src and dst share storage")
        if SHARD != (rows is not None):
            raise ValueError("rows is the store range of a --shard program's "
                             "kernel, and only of it")
        store = tuple(int(v) for v in rows) if SHARD else ()
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._lib.launch(src.data_ptr(), dst.data_ptr(), *store,
                                   stream)
        if err:
            raise RuntimeError("kernel launch failed: "
                               + self._lib.error_string(err).decode())
        self.launches += 1
        return dst


def build_call(device):
    """``apply(src, dst[, rows])`` for tensors on ``device``: the compiled
    kernel on a CUDA device (raises if nvcc or the launch fails), the
    plain torch version on the CPU only."""
    device = torch.device(device)
    if device.type == "cpu":
        return plain_apply
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; run with --device cpu "
                           "for the plain PyTorch version")
    return Kernel()


def to_state(x, device):
    """A numpy fp64 array rounded once to the state's dtype, on ``device``."""
    return torch.from_numpy(x).to(TORCH_DTYPE).to(device)


def time_pairs(pair, warmup, pairs, devices):
    """ms of ``pairs`` calls of ``pair`` after ``warmup`` calls: CUDA events
    on one card, the host's clock around synchronizes otherwise."""
    cuda = [d for d in dict.fromkeys(devices) if d.type == "cuda"]

    def sync():
        for d in cuda:
            torch.cuda.synchronize(d)

    for _ in range(warmup):
        pair()
    sync()
    if len(cuda) == 1 and len(set(devices)) == 1:
        with torch.cuda.device(cuda[0]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(pairs):
                pair()
            end.record()
            end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(pairs):
        pair()
    sync()
    return 1000 * (time.perf_counter() - t0)


def report(ms, on_cuda, launches, got, a0, b0, applications, check):
    """Print the time and, with ``check``, the three [Test] lines against
    the fp64 golden run from the same rounded initial state."""
    what = "GPU" if on_cuda else "CPU (plain version)"
    print(f"{what} computation time: {ms:.3f} ms")
    print(f"kernel launches: {launches}")
    out = {"ms": ms, "launches": launches}
    if check:
        ga, gb = (torch.from_numpy(x).to(TORCH_DTYPE).to(torch.float64).numpy()
                  for x in (a0, b0))
        for _ in range(applications):
            gb = golden_apply(ga, gb)
            ga = golden_apply(gb, ga)
        itr = tuple(slice(H, d - H) for d in DIMS)
        diff = np.abs(got[itr].astype(np.float64) - ga[itr])
        rms = float(np.sqrt(np.mean(diff ** 2)))
        print(f"[Test] Max Error: {float(diff.max()):e}")
        print(f"[Test] RMS Error: {rms:e}")
        # growing operators inflate absolute errors (values scale by
        # sum(coeffs) per timestep, warmup included) — the relative
        # number is the meaningful one
        scale = max(float(np.max(np.abs(ga[itr]))), 1.0)
        print(f"[Test] Max Relative Error: {float(diff.max()) / scale:e}")
        out.update(max_error=float(diff.max()), rms_error=rms,
                   max_relative_error=float(diff.max()) / scale)
    return out
'''

_MAIN = r'''

def main(argv=None):
    ap = argparse.ArgumentParser(description="generated GPU stencil program")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=max(1, -(-ITERATIONS // (2 * STEP))))
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the compiled kernel) or cpu (the plain "
                    "PyTorch version of the same specialised operator)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    call = build_call(device)
    a0, b0 = init_state(args.seed, np.float64)
    a, b = to_state(a0, device), to_state(b0, device)

    def pair():
        call(a, b)
        call(b, a)

    ms = time_pairs(pair, args.warmup, args.pairs, [a.device])
    got = a.detach().to("cpu", torch.float32).numpy()
    return report(ms, device.type == "cuda", getattr(call, "launches", 0),
                  got, a0, b0, args.warmup + args.pairs, args.check)


if __name__ == "__main__":
    main()
'''

_SHARD_MAIN = r'''

def store_rows(k):
    """The (lo, hi) slab rows shard ``k`` stores: its local rows, less the
    global frame on the two edge shards."""
    rows = DIMS_LOCAL[0]
    return (2 * H if k == 0 else H, rows if k == NSHARDS - 1 else H + rows)


def exchange(slabs):
    """Copy every shard's H edge rows into its neighbours' ghost rows; the
    ghost rows at the two global edges are never written and stay zero."""
    rows = DIMS_LOCAL[0]
    for lower, upper in zip(slabs[:-1], slabs[1:]):
        upper[:H].copy_(lower[rows:rows + H], non_blocking=True)
        lower[H + rows:].copy_(upper[H:2 * H], non_blocking=True)


def shard_state(x, devices):
    """Global real array (numpy fp64) -> ghosted slabs on ``devices``."""
    slabs = []
    for block, dev in zip(np.split(x, NSHARDS, axis=0), devices):
        slab = torch.zeros(GRID_DIMS, dtype=TORCH_DTYPE, device=dev)
        slab[H:H + DIMS_LOCAL[0]] = to_state(np.ascontiguousarray(block), dev)
        slabs.append(slab)
    return slabs


def unshard_state(slabs):
    real = [s[H:H + DIMS_LOCAL[0]].detach().to("cpu", torch.float32)
            for s in slabs]
    return torch.cat(real, dim=0).numpy()


def build_sharded(devices):
    """``apply(a, b) -> b`` on lists of ghosted slabs, one per device of
    ``devices`` (a device may repeat): exchange ``a``'s halo rows, then
    the kernel on every shard with its store range."""
    if len(devices) != NSHARDS:
        raise SystemExit(f"need {NSHARDS} devices, got {len(devices)}")
    calls = {}
    for d in devices:
        if d.type not in calls:
            calls[d.type] = build_call(d)
    rows = [store_rows(k) for k in range(NSHARDS)]

    def apply_fn(a, b):
        exchange(a)
        for k, d in enumerate(devices):
            calls[d.type](a[k], b[k], rows[k])
        return b

    apply_fn.calls = calls
    return apply_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description="generated sharded GPU stencil program")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=max(1, -(-ITERATIONS // (2 * STEP))))
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--devices", default="",
                    help=f"{NSHARDS} comma-separated devices, one per shard "
                    "(a device may repeat; cpu runs the plain PyTorch "
                    f"version); default cuda:0 .. cuda:{NSHARDS - 1}")
    args = ap.parse_args(argv)

    names = (args.devices.split(",") if args.devices
             else [f"cuda:{k}" for k in range(NSHARDS)])
    devices = [torch.device(n) for n in names]
    apply_fn = build_sharded(devices)
    a0, b0 = init_state(args.seed, np.float64)
    a, b = shard_state(a0, devices), shard_state(b0, devices)

    def pair():
        apply_fn(a, b)
        apply_fn(b, a)

    ms = time_pairs(pair, args.warmup, args.pairs, devices)
    launches = sum(getattr(c, "launches", 0) for c in apply_fn.calls.values())
    on_cuda = all(d.type == "cuda" for d in devices)
    return report(ms, on_cuda, launches, unshard_state(a), a0, b0,
                  args.warmup + args.pairs, args.check)


if __name__ == "__main__":
    main()
'''


def dump_analysis(spec_or_stc_text: Union[StencilSpec, str],
                  name: str = "stencil", step: int = 1, distance: int = 0,
                  merge_forward: int = 5) -> str:
    """The analysis of one spec as a JSON line (``--dump-analysis``)."""
    spec = _load_spec(spec_or_stc_text, name)
    return json.dumps(analysis_json(analyze(spec, step, distance,
                                            merge_forward)))
