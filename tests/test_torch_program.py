"""The PyTorch port's recording frontend and roll interpreter vs the JAX
reference.

The same programs, recorded through ``repro.core`` and ``repro_torch.core``
from the same NumPy inputs, must give the same results:

* ``jit`` (the roll interpreter) — **bitwise** at float32 and float64.  The
  reference runs under ``jax.disable_jit()`` so every JAX op rounds on its
  own, as torch's do; compiled, XLA's CPU backend contracts ``a·b + c``
  into fused multiply-adds and the two differ by an ulp.
* ``numpy`` — bitwise (both run the same NumPy expression).

The builders here are shared with ``test_torch_compiler.py`` and
``test_torch_engine.py``: each records one program into either package.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from conftest import heat_init
from repro.engine import RunOptions as RefOptions
from repro_torch.engine import RunOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- programs, recorded into either package (m = repro.core | repro_torch.core)

def build_heat(m, T0, steps, c=0.1):
    """The paper's Fig. 3 heat body."""
    wse = m.WSE_Interface()
    center = 1.0 - 6.0 * c
    T = m.WSE_Array("T_n", init_data=T0, dtype=T0.dtype)
    with m.WSE_For_Loop("t", steps):
        T[1:-1, 0, 0] = center * T[1:-1, 0, 0] + c * (
            T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0] + T[1:-1, 0, -1]
            + T[1:-1, -1, 0] + T[1:-1, 0, 1])
    return wse, T


def build_advdiff(m, T0, steps, kappa=0.05, ux=0.1, uy=0.07, chi=0.02):
    """examples/advection_diffusion.py: upwind advection, FTCS diffusion and
    off-axis cross-diffusion taps."""
    wse = m.WSE_Interface()
    T = m.WSE_Array("T_adv", init_data=T0, dtype=T0.dtype)
    with m.WSE_For_Loop("time_loop", steps):
        T[1:-1, 0, 0] = T[1:-1, 0, 0] \
            + kappa * (T[2:, 0, 0] + T[:-2, 0, 0]
                       + T[1:-1, 1, 0] + T[1:-1, -1, 0]
                       + T[1:-1, 0, 1] + T[1:-1, 0, -1]
                       - 6.0 * T[1:-1, 0, 0]) \
            - ux * (T[1:-1, 0, 0] - T[1:-1, -1, 0]) \
            - uy * (T[1:-1, 0, 0] - T[1:-1, 0, -1]) \
            + chi * (T[1:-1, 1, 1] + T[1:-1, -1, -1]
                     - 2.0 * T[1:-1, 0, 0])
    return wse, T


def build_negz(m, T0, steps):
    """tests/test_compiler.py's negative-start z spelling: on an nz=10
    column T[-9:-1] is the centre slice T[1:-1]."""
    wse = m.WSE_Interface()
    T = m.WSE_Array("T_n", init_data=T0, dtype=T0.dtype)
    with m.WSE_For_Loop("t", steps):
        T[1:-1, 0, 0] = 0.5 * T[-9:-1, 0, 0] + 0.25 * (
            T[2:, 0, 0] + T[:-2, 0, 0])
    return wse, T


def build_coupled(m, A0, B0, steps):
    """tests/test_compiler.py's two-field coupled body: B reads A's new
    value (dx = dy = 0) in the same loop body."""
    wse = m.WSE_Interface()
    A = m.WSE_Array("A", init_data=A0, dtype=A0.dtype)
    B = m.WSE_Array("B", init_data=B0, dtype=B0.dtype)
    with m.WSE_For_Loop("t", steps):
        A[1:-1, 0, 0] = A[1:-1, 0, 0] + 0.1 * (
            B[1:-1, 1, 0] + B[1:-1, -1, 0] - 2.0 * B[1:-1, 0, 0])
        B[1:-1, 0, 0] = B[1:-1, 0, 0] + 0.05 * A[1:-1, 0, 0]
    return wse, A


def build_varcoef(m, T0, C0, steps):
    """Variable-coefficient diffusion: 2-tap products with a coefficient
    field."""
    wse = m.WSE_Interface()
    T = m.WSE_Array("T_n", init_data=T0, dtype=T0.dtype)
    C = m.WSE_Array("C_f", init_data=C0, dtype=C0.dtype)
    with m.WSE_For_Loop("t", steps):
        T[1:-1, 0, 0] = T[1:-1, 0, 0] + C[1:-1, 0, 0] * (
            T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0] + T[1:-1, 0, -1]
            + T[1:-1, -1, 0] + T[1:-1, 0, 1] - 6.0 * T[1:-1, 0, 0])
    return wse, T


def build_wide(m, P0, Q0, R0, steps):
    """Edge cases of the fused kernel: halo 2, fields of different nz in one
    body (P: nz=9, Q: nz=7), a 2-tap product across them, a constant-only
    update, and a halo-free field R advanced in the same body."""
    wse = m.WSE_Interface()
    P = m.WSE_Array("P", init_data=P0, dtype=P0.dtype)
    Q = m.WSE_Array("Q", init_data=Q0, dtype=Q0.dtype)
    R = m.WSE_Array("R", init_data=R0, dtype=R0.dtype)
    with m.WSE_For_Loop("t", steps):
        P[1:-1, 0, 0] = 0.3 * P[1:-1, 0, 0] + 0.2 * (
            P[1:-1, 2, 0] + P[1:-1, -2, 1]) + Q[:, 0, 0] * Q[:, 1, -2]
        Q[2:5, 0, 0] = 0.0 * Q[2:5, 0, 0] + 1.5
        R[1:-1, 0, 0] = 0.5 * R[2:, 0, 0] + 0.5 * R[:-2, 0, 0]
    return wse, P


def program_inputs(name, dtype, seed=0):
    """(builder(m, steps) -> (wse, answer), Kelvin-scale?) for ``name``."""
    rng = np.random.default_rng(seed)
    if name == "heat":
        T0 = heat_init().astype(dtype)
        return (lambda m, n: build_heat(m, T0, n)), True
    if name == "advdiff":
        T0 = rng.uniform(0.0, 1.0, (9, 11, 8)).astype(dtype)
        return (lambda m, n: build_advdiff(m, T0, n)), False
    if name == "negz":
        T0 = rng.uniform(0.0, 1.0, (8, 9, 10)).astype(dtype)
        return (lambda m, n: build_negz(m, T0, n)), False
    if name == "coupled":
        A0 = rng.uniform(0.0, 1.0, (8, 8, 6)).astype(dtype)
        B0 = rng.uniform(0.0, 1.0, (8, 8, 6)).astype(dtype)
        return (lambda m, n: build_coupled(m, A0, B0, n)), False
    if name == "varcoef":
        T0 = (heat_init((8, 9, 10)) / 500.0).astype(dtype)
        C0 = rng.uniform(0.02, 0.15, T0.shape).astype(dtype)
        return (lambda m, n: build_varcoef(m, T0, C0, n)), False
    if name == "wide":
        P0 = rng.uniform(0.0, 1.0, (12, 13, 9)).astype(dtype)
        Q0 = rng.uniform(0.0, 0.1, (12, 13, 7)).astype(dtype)
        R0 = rng.uniform(0.0, 1.0, (12, 13, 6)).astype(dtype)
        return (lambda m, n: build_wide(m, P0, Q0, R0, n)), False
    raise KeyError(name)


def run_ref(build, steps, dtype, eager=False, **opts):
    """Run through ``repro`` (float64 under ``jax.enable_x64``; ``eager``
    evaluates op by op under ``jax.disable_jit``)."""
    with jax.enable_x64(np.dtype(dtype) == np.float64):
        if eager:
            with jax.disable_jit():
                wse, ans = build(ref_core, steps)
                return wse.make(answer=ans, options=RefOptions(**opts))
        wse, ans = build(ref_core, steps)
        return wse.make(answer=ans, options=RefOptions(**opts))


def run_port(build, steps, **opts):
    wse, ans = build(port_core, steps)
    return wse.make(answer=ans, options=RunOptions(device="cpu", **opts))


# -- the roll interpreter: bitwise ------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["heat", "advdiff", "negz", "coupled"])
def test_jit_matches_reference_bitwise(name, dtype):
    build, _ = program_inputs(name, dtype)
    ref = run_ref(build, 4, dtype, eager=True, backend="jit")
    out = run_port(build, 4, backend="jit")
    assert out.dtype == ref.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(out, ref)


def test_numpy_backend_matches_reference_bitwise():
    for name in ("heat", "advdiff"):
        build, _ = program_inputs(name, np.float32)
        ref = run_ref(build, 5, np.float32, backend="numpy")
        out = run_port(build, 5, backend="numpy")
        np.testing.assert_array_equal(out, ref)


# -- recording: the same validation, the same messages -----------------------

def _record_error(m, how):
    wse = m.WSE_Interface()
    try:
        T = m.WSE_Array("T", shape=(6, 6, 8))
        if how == "length":
            T[1:-1, 0, 0] = T[2:, 0, 0] + T[:, 0, 0]
        elif how == "target_offset":
            T[1:-1, 1, 0] = T[1:-1, 0, 0]
        elif how == "strided":
            T[1:-1:2, 0, 0] = T[1:-1:2, 0, 0]
    except Exception as e:  # noqa: BLE001 — the exception is the result
        return type(e).__name__, str(e)
    finally:
        wse.__exit__()
    return None


def test_record_errors_match_reference():
    for how in ("length", "target_offset", "strided"):
        ref = _record_error(ref_core, how)
        assert ref is not None
        assert _record_error(port_core, how) == ref


def test_heat_config_matches_reference():
    from repro.configs import heat3d as ref_cfg
    from repro_torch.compiler import lower_group
    from repro_torch.configs import heat3d as port_cfg

    import dataclasses
    rc, pc = ref_cfg.HeatConfig(), port_cfg.HeatConfig()
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    assert (pc.nx, pc.ny, pc.nz, pc.dtype) == (512, 512, 128, "float32")
    np.testing.assert_array_equal(port_cfg.make_field(pc.smoke()),
                                  ref_cfg.make_field(rc.smoke()))
    # record_heat records the README's Fig. 3 body with c = omega
    wse, T = port_cfg.record_heat(pc.smoke(), 3)
    try:
        g = lower_group(wse.program.ops)
    finally:
        wse.__exit__()
    wse2, T2 = build_heat(port_core, port_cfg.make_field(pc.smoke()), 3,
                          c=pc.omega)
    try:
        assert lower_group(wse2.program.ops) == g
    finally:
        wse2.__exit__()


def test_solve_is_not_ported_and_releases_the_program():
    """``solve`` is ported now; the test keeps its name, and checks that
    ``solve`` on an explicit ``ForLoop`` program (no ``Operator()`` /
    ``Rhs()`` group) raises the reference's ValueError and leaves no
    program active."""
    messages = []
    for core in (ref_core, port_core):
        wse, T = build_heat(core, heat_init(), 2)
        with pytest.raises(ValueError) as err:
            if core is port_core:
                wse.solve(answer=T, options=RunOptions(device="cpu"))
            else:
                wse.solve(answer=T)
        messages.append(str(err.value))
        core.WFAInterface().__exit__()   # no program left active
    assert messages[0] == messages[1]
    assert "Operator()/Rhs()" in messages[1]


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "print('N', len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "print('MISSING', [n for n in NEW if n not in sys.modules])\n"
    )
    # the legacy brick drivers and their kernels K5-K7 (slice 3)
    new = ["repro_torch.core.mesh", "repro_torch.core.halo",
           "repro_torch.core.explicit", "repro_torch.core.implicit",
           "repro_torch.kernels.stencil7", "repro_torch.kernels.spmv",
           "repro_torch.convert",
           # the halo-resident layout (slice 4)
           "repro_torch.engine.layout"]
    code = f"NEW = {new!r}\n" + code
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout
    assert "MISSING []" in out.stdout
    assert int(out.stdout.split("N ")[1].split()[0]) >= 21   # every module imported


def test_port_docstring_examples_run():
    import doctest
    import importlib

    for name in ("repro_torch", "repro_torch.convert", "repro_torch.core.mesh",
                 "repro_torch.core.program", "repro_torch.engine.layout",
                 "repro_torch.engine.options", "repro_torch.engine.stats"):
        res = doctest.testmod(importlib.import_module(name))
        assert res.attempted > 0 and res.failed == 0, (name, res)
