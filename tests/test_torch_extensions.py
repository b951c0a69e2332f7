"""The extension stencils (2d13pt_star, 3d13pt_star, 3d27pt_box) through the
port, mirroring ``tests/test_extensions.py``'s two checks that no other
port test makes:

- the streaming program (``StencilProgram(device="cpu")``: the kernels'
  plain versions) at ``(step, trapezoid)`` = (1, F), (2, F), (2, T)
  against the fp64 golden model, under the JAX test's limits;
- the dense 27-point box at step 2: the emitted program's output equal to
  the port's library output bit for bit, both within the golden limit, and
  within 1e-5 of the JAX package's library runtime in interpret mode.

The other checks of that file are made elsewhere: every winner's golden
check (``test_torch_runner.py``), the tuning spaces
(``test_torch_tune.py``), the analysis against ``native_bridge``
(``test_torch_cli.py``).
"""

import numpy as np
import pytest

from drstencil_tpu.ops.config import KernelConfig as JConfig
from drstencil_tpu.ops.runner import StencilProgram as JProgram
from drstencil_tpu_torch.ir import golden
from drstencil_tpu_torch.ops.config import KernelConfig
from drstencil_tpu_torch.ops.runner import StencilProgram
from drstencil_tpu_torch.ops.stream import level_plan

from test_torch_emit import emit_for, load_program, port_spec

EXT_STENCILS = ["2d13pt_star", "3d13pt_star", "3d27pt_box"]
# tests/test_extensions.py's limits on the fp64 golden check
MAX_TOL = 5e-3
RMS_TOL = 1e-3
JAX_TOL = 1e-5      # fp32 vs the JAX runtime, relative to max|JAX|


@pytest.mark.parametrize("name", EXT_STENCILS)
@pytest.mark.parametrize("step,trapezoid", [(1, False), (2, False),
                                            (2, True)])
def test_extension_stream_matches_golden(name, step, trapezoid):
    _, spec = port_spec(name)
    prog = StencilProgram(spec, KernelConfig(step=step, trapezoid=trapezoid),
                          device="cpu")
    assert level_plan(prog.an, prog.cfg).levels == (
        step if trapezoid else 1)
    max_err, rms = prog.check(seed=0)
    assert max_err < MAX_TOL, f"max_err={max_err}"
    assert rms < RMS_TOL


def test_extension_emitted_program_matches_library():
    """The emitted program of the 27-point box at step 2 (one coefficient-
    fused level of 125 taps) runs the library's operations in its order:
    its plain path's output equals the library's bit for bit after one
    pair from the same state, both match the fp64 golden model, and they
    are within 1e-5 of the JAX package's library runtime."""
    name, dims, fields, seed = "3d27pt_box", (16, 16, 256), dict(step=2), 3
    jspec, spec = port_spec(name, dims)
    g = load_program(emit_for(spec, fields))
    assert len(g["FUSED_TAPS"]) == 125 and g["LEVELS"] == 1

    a0, b0 = g["init_state"](seed, np.float64)
    call = g["build_call"]("cpu")
    a, b = g["to_state"](a0, "cpu"), g["to_state"](b0, "cpu")
    call(a, b)
    call(b, a)
    gen = a.numpy()

    prog = StencilProgram(spec, KernelConfig(**fields), device="cpu")
    lib = prog.final_a(prog.run_pairs(prog.init_state(seed), 1))
    np.testing.assert_array_equal(gen, lib)

    gold = golden.run_golden(spec, step=2, seed=seed, pairs=1)
    h = int(gold["halo"])
    inner = tuple(slice(h, -h) for _ in range(spec.ndim))
    err = np.abs(lib[inner].astype(np.float64) - gold["a"][inner]).max()
    assert err < MAX_TOL, err

    jprog = JProgram(jspec, JConfig(variant="stream", step=2, tm=120,
                                    interpret=True))
    jout = np.asarray(jprog.final_a(jprog.run_pairs(jprog.init_state(seed),
                                                    1)), dtype=np.float32)
    rel = np.abs(gen - jout.reshape(dims)).max() / np.abs(jout).max()
    assert rel <= JAX_TOL, f"rel={rel}"
