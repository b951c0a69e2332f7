"""``overlap_probe`` (``drstencil_tpu_torch/csrc/experiments.cu``) as a
program on the CPU, under the g++ emulation of ``tests/cuda_emulation``.

The source has no PyTorch headers, so g++ compiles it after three
substitutions: the block of PTX helpers (TMA bulk copy and ``mbarrier``)
becomes ``bulk_copy.h``, where a copy is a ``memcpy`` and a byte count and
a barrier's phase completes when its arrival and all its bytes are in; the
``<<<...>>>`` launch becomes ``EMU_LAUNCH`` (a CTA's threads as
``std::thread``s, one CTA after another); the dynamic shared array becomes
a pointer to one static array poisoned with NaN before each CTA.  The C
entry runs in a process of its own on host buffers and is held against
``overlap_probe_ref``: the written rows within 1e-5 of max|plain| (the same
fp32 operations in the same order; bit-equality is expected), the other
rows keep their fill, and variant C's carry is equal.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from drstencil_tpu_torch.ops import kernels

EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "cuda_emulation")
R, N, TM, HK = 200, 256, 48, 8      # the sizes of tests/test_torch_overlap.py
REL_TOL = 1e-5

RUNNER = """
import ctypes, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
x = np.fromfile(sys.argv[2], dtype=np.float32)
out = np.fromfile(sys.argv[3], dtype=np.float32)
carry = np.fromfile(sys.argv[4], dtype=np.float32)
ptr, i32 = ctypes.c_void_p, ctypes.c_int
lib.overlap_probe.argtypes = [ptr, ptr, ptr] + [i32] * 8 + [ptr]
lib.overlap_probe.restype = i32
args = [int(v) for v in sys.argv[5:]]
err = lib.overlap_probe(x.ctypes.data, out.ctypes.data, carry.ctypes.data,
                        *args, None)
out.tofile(sys.argv[3])
carry.tofile(sys.argv[4])
sys.exit(err)
"""


def emulated_text(cuda: str) -> str:
    """``experiments.cu`` with the three substitutions."""
    text, n = re.subn(
        r"// ---- TMA bulk copy and mbarrier \(PTX\) -+\n.*?"
        r"// ---- end of PTX -+\n", '#include "bulk_copy.h"\n', cuda,
        flags=re.S)
    assert n == 1
    text, n = re.subn(
        r"(\w+)<<<(\w+), (\w+), \w+, \(cudaStream_t\)stream>>>\(\s*",
        r"EMU_LAUNCH(\1, \2, \3, ", text)
    assert n == 1
    text, n = re.subn(r"extern __shared__ __align__\(128\) float smem\[\];",
                      "float* const smem = g_smem;", text)
    assert n == 1
    return text


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to emulate the kernel with")
    with open(kernels.EXPERIMENTS_SOURCE) as f:
        text = emulated_text(f.read())
    tmp = tmp_path_factory.mktemp("probe")
    src, lib = tmp / "experiments.cc", tmp / "experiments.so"
    src.write_text(text)
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-I", EMU_DIR, "-o", str(lib), str(src)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return str(lib), tmp


def run_probe(probe_lib, x, out, variant, depth, tm, hk, n_ctas, load=True):
    """The emulated C entry on ``x`` into a copy of ``out``: returns
    ``(exit code, out, carry)``."""
    lib, tmp = probe_lib
    R_, N_ = out.shape
    carry = np.zeros((n_ctas, hk, kernels.PROBE_TILE), np.float32)
    files = [tmp / "x.bin", tmp / "out.bin", tmp / "carry.bin"]
    for a, f in zip((x.numpy(), out.numpy(), carry), files):
        np.ascontiguousarray(a, dtype=np.float32).tofile(f)
    run = subprocess.run(
        [sys.executable, "-c", RUNNER, lib, *map(str, files),
         *map(str, (R_, N_, tm, hk, kernels.PROBE_VARIANTS.index(variant),
                    depth, int(load), n_ctas))],
        capture_output=True, text=True, timeout=300)
    got = torch.from_numpy(np.fromfile(files[1], np.float32)).view(R_, N_)
    got_carry = torch.from_numpy(np.fromfile(files[2], np.float32)).view(
        n_ctas, hk, kernels.PROBE_TILE)
    return run.returncode, run.stderr, got, got_carry


def inputs(variant, R_, N_, hk, seed=5):
    rng = np.random.default_rng(seed)
    rows = R_ if variant == "A" else R_ + 2 * hk
    x = torch.from_numpy(rng.uniform(0.0, 100.0, (rows, N_)).astype(
        np.float32))
    fill = torch.from_numpy(rng.uniform(-0.5, 0.5, (R_, N_)).astype(
        np.float32))
    return x, fill


def written_rows(R_, tm, hk):
    w = torch.zeros(R_, dtype=torch.bool)
    for i in range(R_ // tm):
        w[i * tm:i * tm + tm - 4 * hk] = True
    return w


def check_against_plain(probe_lib, variant, depth, R_, N_, n_ctas):
    x, fill = inputs(variant, R_, N_, HK)
    rc, err, got, carry = run_probe(probe_lib, x, fill, variant, depth, TM,
                                    HK, n_ctas)
    assert rc == 0, err[-3000:]
    want = fill.clone()
    _, want_carry = kernels.overlap_probe_ref(x, want, variant, TM, HK,
                                              n_ctas)
    w = written_rows(R_, TM, HK)
    assert not got.isnan().any()
    top = float(want[w].abs().max())
    assert float((got[w] - want[w]).abs().max()) <= REL_TOL * top
    assert torch.equal(got[~w], fill[~w])
    if variant == "C":
        assert torch.equal(carry, want_carry)
    return got, want


@pytest.mark.parametrize("variant", kernels.PROBE_VARIANTS)
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("ctas", ["every tile", "five", "one"])
def test_emulated_probe_equals_plain(probe_lib, variant, depth, ctas):
    """Two full strips and a ragged tail; one CTA per tile, five CTAs that
    loop over 16 tiles (each buffer's parity flips several times), and one
    CTA that walks them all."""
    ntiles = (R // TM) * (N // kernels.PROBE_TILE)
    n_ctas = {"every tile": ntiles, "five": 5, "one": 1}[ctas]
    check_against_plain(probe_lib, variant, depth, R, N, n_ctas)


@pytest.mark.parametrize("variant", kernels.PROBE_VARIANTS)
@pytest.mark.parametrize("depth", [1, 2])
def test_emulated_probe_one_tile_wraps_onto_itself(probe_lib, variant, depth):
    """N = PROBE_TILE: a window row is three copies, the tile's own columns
    on both sides."""
    check_against_plain(probe_lib, variant, depth, R, kernels.PROBE_TILE, 2)


def test_emulated_probe_is_bit_equal_to_plain(probe_lib):
    """The same fp32 operations in the same order, no contraction (g++
    -ffp-contract=off, as torch on the CPU)."""
    got, want = check_against_plain(probe_lib, "B", 2, R, N, 3)
    w = written_rows(R, TM, HK)
    assert torch.equal(got[w], want[w])


def test_emulated_probe_compute_only_runs(probe_lib):
    """``load=False``: no copy, no barrier wait; the windows are ones, so
    every written cell is two levels of ones."""
    x, fill = inputs("C", R, N, HK)
    rc, err, got, _ = run_probe(probe_lib, x, fill, "C", 2, TM, HK, 4,
                                load=False)
    assert rc == 0, err[-3000:]
    w = written_rows(R, TM, HK)
    ones = torch.ones((1, TM, N))
    level2 = kernels.probe_level_ref(kernels.probe_level_ref(
        ones, TM - 2 * HK), TM - 4 * HK)[0]
    assert torch.allclose(got[w], level2[0].expand(int(w.sum()), N))
    assert torch.equal(got[~w], fill[~w])


@pytest.mark.parametrize("args", [
    dict(n_ctas=17), dict(n_ctas=0), dict(N=N + 32), dict(tm=44),
    dict(variant=3), dict(depth=3)])
def test_emulated_probe_rejects_bad_arguments(probe_lib, args):
    lib = ctypes.CDLL(probe_lib[0])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.overlap_probe.argtypes = [ptr, ptr, ptr] + [i32] * 8 + [ptr]
    a = dict(R=R, N=N, tm=TM, hk=HK, variant=1, depth=2, load=1, n_ctas=16)
    a.update(args)
    buf = np.zeros(16, np.float32)     # never touched: the entry refuses
    assert lib.overlap_probe(buf.ctypes.data, buf.ctypes.data, None, a["R"],
                             a["N"], a["tm"], a["hk"], a["variant"],
                             a["depth"], a["load"], a["n_ctas"], None) != 0


def test_emulated_info_entry(probe_lib):
    """``overlap_probe_info`` reports the shared memory the wrapper
    computes."""
    lib = ctypes.CDLL(probe_lib[0])
    info = (ctypes.c_int * 4)()
    for v, variant in enumerate(kernels.PROBE_VARIANTS):
        for depth in (1, 2):
            assert lib.overlap_probe_info(v, depth, 1, 96, 8, info) == 0
            assert info[2] == kernels.OverlapProbeKernel.smem_bytes(
                variant, depth, 96, 8)
    assert lib.overlap_probe_info(0, 1, 1, 44, 8, info) != 0


def test_kernel_times_has_the_probe_rows():
    """``utils/kernel_times probe``: A/B/C at depths 1 and 2, with nothing
    to build per plan."""
    from drstencil_tpu_torch.utils import kernel_times
    assert kernel_times.expand(["probe"]) == [
        f"probe {v} d{d}" for v in "ABC" for d in (1, 2)]
    assert kernel_times.build_report(list(kernel_times.PROBE_ROWS),
                                     "float32") == {}
