"""The PyTorch port's engine (plan + execute through ``make``) vs the JAX
reference, on the CPU.

``backend="pallas"`` runs the fused kernel's plain version here; the
reference runs its Pallas kernel in interpret mode.  Tolerance: the
reference's XLA CPU compiler contracts ``a·b + c`` into fused multiply-adds
inside the kernel, the port rounds every operation on its own (as the CUDA
kernel does, built with ``--fmad=false``), so the two differ by rounding:
at most 2 ulp of the field's magnitude per step, at float32 and float64,
and at most 2e-4 on Kelvin-scale fields.  (The arithmetic itself is held
bitwise in ``test_torch_compiler.py``.)  Structural results — launches,
tiles, halo exchanges, resident runs and repacks (both packages plan the
halo-resident layout here), kernel builds, cache hits, fallbacks, the
picked tile — must be equal.
"""
import warnings

import numpy as np
import pytest
import torch

import repro.compiler as ref_compiler
import repro.core as ref_core
import repro.engine as ref_engine
import repro_torch as rt
import repro_torch.compiler as port_compiler
import repro_torch.core as port_core
import repro_torch.engine as port_engine
from repro_torch.compiler import LoweringError
from repro_torch.convert import env_from_numpy, env_to_numpy
from repro_torch.engine import RunOptions
from repro_torch.engine.hooks import set_compile_hook
from test_torch_program import build_heat, program_inputs, run_port, run_ref


def _stats(engine, compiler):
    e, c = engine.stats, compiler.stats
    return {"steps_run": e.steps_run, "launches": e.launches,
            "tiles_fused": e.tiles_fused, "exchanges": e.exchanges,
            "resident_runs": e.resident_runs, "repacks": e.repacks,
            "segments_fused": e.segments_fused, "max_time_tile": e.max_time_tile,
            "kernels_built": c.kernels_built, "cache_hits": c.cache_hits,
            "fallbacks": c.fallbacks, "groups_fused": c.groups_fused}


def _reset(engine, compiler):
    engine.reset_stats()
    compiler.reset_stats()
    compiler.clear_cache()


def assert_rounding_close(out, ref, steps, kelvin):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    diff = np.abs(out.astype(np.float64) - ref.astype(np.float64)).max()
    tol = 2 * steps * float(np.spacing(np.abs(ref).max()))
    if kelvin and ref.dtype == np.float32:
        tol = min(tol, 2e-4)
    assert diff <= tol, (diff, tol)


@pytest.mark.parametrize("name,steps,time_tile", [
    ("heat", 5, 1),
    ("heat", 5, 2),        # 2 tiled launches + 1 remainder launch
    ("heat", 8, None),     # auto pick
    ("advdiff", 6, 2),
    ("negz", 4, 1),
    ("coupled", 5, 2),     # two written fields, remainder
    ("varcoef", 4, 2),
    ("wide", 5, 2),        # halo 2, mixed nz, const-only update, remainder
])
def test_make_pallas_matches_reference(name, steps, time_tile):
    build, kelvin = program_inputs(name, np.float32)
    _reset(ref_engine, ref_compiler)
    ref = run_ref(build, steps, np.float32, backend="pallas",
                  time_tile=time_tile)
    ref_stats = _stats(ref_engine, ref_compiler)
    _reset(port_engine, port_compiler)
    out = run_port(build, steps, backend="pallas", time_tile=time_tile)
    assert _stats(port_engine, port_compiler) == ref_stats
    assert ref_stats["fallbacks"] == 0 and ref_stats["launches"] > 0
    assert_rounding_close(out, ref, steps, kelvin)


@pytest.mark.parametrize("name", ["heat", "advdiff"])
def test_make_pallas_float64_matches_reference(name):
    build, kelvin = program_inputs(name, np.float64)
    ref = run_ref(build, 5, np.float64, backend="pallas", time_tile=2)
    out = run_port(build, 5, backend="pallas", time_tile=2)
    assert out.dtype == np.float64
    assert_rounding_close(out, ref, 5, kelvin)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tiled_equals_untiled_bitwise(dtype):
    """k sub-steps per launch (with a remainder launch) compute exactly what
    k single launches do: the trapezoid keeps each cell's arithmetic."""
    build, _ = program_inputs("advdiff", dtype)
    untiled = run_port(build, 7, backend="pallas", time_tile=1)
    tiled = run_port(build, 7, backend="pallas", time_tile=3)
    np.testing.assert_array_equal(tiled, untiled)


def test_pallas_matches_jit_and_numpy():
    build, _ = program_inputs("heat", np.float32)
    fused = run_port(build, 7, backend="pallas")
    for backend in ("jit", "numpy"):
        np.testing.assert_allclose(run_port(build, 7, backend=backend), fused,
                                   atol=2e-4, rtol=0)


def test_auto_tile_matches_reference():
    """The planner picks the same tile factor and clamps the same requests
    as the reference, with the same reasons."""
    from repro_torch.configs.heat3d import HeatConfig, make_field
    T0 = make_field(HeatConfig().smoke())
    for steps, requested in ((8, None), (12, None), (5, None), (4, 64)):
        picks = []
        for core, eng in ((ref_core, ref_engine), (port_core, port_engine)):
            wse, _ = build_heat(core, T0, steps)
            opts = dict(backend="pallas", time_tile=requested)
            if eng is port_engine:
                opts["device"] = "cpu"
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    p = eng.plan(wse.program, eng.RunOptions(**opts))
            finally:
                wse.__exit__()
            picks.append([(s.time_tile, s.reason) for s in p.segments])
        assert picks[1] == picks[0]


def test_options_of_later_slices_raise():
    """Every option of the reference is ported now: the health and adjoint
    options build (a recovery that is not a RecoveryPolicy is refused, as
    the reference refuses it), the overlap and the mesh as before."""
    from repro_torch.solver import RecoveryPolicy

    opts = RunOptions(differentiable=True, check_finite=5,
                      recovery=RecoveryPolicy(), device="cpu")
    assert (opts.differentiable, opts.check_finite) == (True, 5)
    with pytest.raises(TypeError, match="RecoveryPolicy"):
        RunOptions(recovery=object())
    with pytest.raises(ValueError, match="check_finite"):
        RunOptions(check_finite=-1)
    # the overlap slice is in: overlap=True is an ordinary option now
    assert RunOptions(overlap=True, device="cpu").overlap is True
    # the sharding slice is in: a mesh must be the port's own Mesh
    with pytest.raises(TypeError, match="Mesh"):
        RunOptions(mesh=object())


def test_cuda_default_without_a_card_raises(monkeypatch):
    """device="cuda" is the default; without a card the run raises instead
    of carrying on on the CPU (and releases the program)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build, _ = program_inputs("heat", np.float32)
    wse, T = build(port_core, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wse.make(answer=T, options=RunOptions(backend="pallas"))
    port_core.WFAInterface().__exit__()


def test_legacy_keywords_warn_once_and_forward():
    from repro_torch.engine import options as opts_mod
    opts_mod._WARNED.discard(("make", "time_tile"))
    port_engine.reset_stats()
    build, _ = program_inputs("heat", np.float32)
    with pytest.warns(DeprecationWarning, match="time_tile"):
        wse, T = build(port_core, 4)
        a = wse.make(answer=T, time_tile=2,
                     options=RunOptions(backend="pallas", device="cpu"))
    assert port_engine.stats.max_time_tile == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        wse, T = build(port_core, 4)
        b = wse.make(answer=T, time_tile=2,
                     options=RunOptions(backend="pallas", device="cpu"))
    np.testing.assert_array_equal(a, b)


def test_compile_hook_lowering_error_is_a_counted_fallback():
    def refuse(loop_name):
        raise LoweringError(f"injected for {loop_name}")

    build, _ = program_inputs("advdiff", np.float32)
    port_compiler.reset_stats()
    prev = set_compile_hook(refuse)
    try:
        out = run_port(build, 3, backend="pallas")
    finally:
        set_compile_hook(prev)
    assert port_compiler.stats.fallbacks == 1
    assert "injected for time_loop" in port_compiler.stats.fallback_reasons[0]
    np.testing.assert_array_equal(out, run_port(build, 3, backend="jit"))


def test_module_make_and_env_conversion():
    build, _ = program_inputs("heat", np.float64)
    wse, T = build(port_core, 3)
    out = rt.make(wse, T, options=RunOptions(backend="pallas", device="cpu"))
    assert out.dtype == np.float64
    env = {"T": out}
    back = env_to_numpy(env_from_numpy(env, "cpu"))
    assert back["T"].dtype == np.float64 and back["T"] is not out
    np.testing.assert_array_equal(back["T"], out)


@pytest.mark.cuda
def test_make_on_the_card_matches_the_cpu_bitwise():
    """On a card: make(backend="pallas") runs K1 and equals the plain
    version's CPU run bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.fused import launch_fused
    build, _ = program_inputs("coupled", np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        before = launch_fused.launches
        wse, A = build(port_core, 5)
        out[device] = wse.make(answer=A, options=RunOptions(
            backend="pallas", time_tile=2, device=device))
        assert launch_fused.launches - before == (3 if device == "cuda" else 0)
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
