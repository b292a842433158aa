"""The PyTorch port's IR, codegen and fused-kernel plain version vs the JAX
reference.

* Lowering is structural: the same recorded program lowers to equal tap
  tuples, and the same unlowerable bodies raise ``LoweringError`` with the
  same message.
* ``fused_step_ref`` (K1's plain PyTorch version) equals the reference
  kernel's arithmetic **bitwise** at float32 and float64: the reference's
  per-sub-step ``_apply_updates`` is evaluated op by op under
  ``jax.disable_jit`` over the same padded window, so no compiler contracts
  its multiplies and adds.
* The kernel-cache counters move as the reference's do.
* Off the card the CUDA path refuses CPU tensors, a failed ``nvcc`` build
  raises, and a body outside the kernel's limits raises instead of
  falling back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compiler as ref_compiler
import repro.core as ref_core
import repro_torch.compiler as port_compiler
import repro_torch.core as port_core
from repro.kernels import fused as ref_fused
from repro_torch.compiler.codegen import _field_specs, _wrap_pad
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.fused import (MAX_FIELDS, build_fused_call,
                                       fused_step_ref, launch_fused)
from test_torch_program import program_inputs, run_port, run_ref


def _lowered(m, compiler, build):
    wse, _ = build(m, 3)
    try:
        return compiler.lower_group(wse.program.ops)
    finally:
        wse.__exit__()


def _plain(group):
    """A lowered group as plain tuples, comparable across packages."""
    return (group.halo, tuple(
        (u.field, u.z0, u.zlen, u.const,
         tuple((c, tuple((t.field, t.dz, t.dx, t.dy) for t in taps))
               for c, taps in u.terms))
        for u in group.updates))


@pytest.mark.parametrize("name", ["heat", "advdiff", "negz", "coupled",
                                  "varcoef", "wide"])
def test_lowering_matches_reference(name):
    build, _ = program_inputs(name, np.float32)
    ref = _lowered(ref_core, ref_compiler, build)
    port = _lowered(port_core, port_compiler, build)
    assert _plain(port) == _plain(ref)
    assert port.fields_read() == ref.fields_read()
    assert port.fields_written() == ref.fields_written()


def _unlowerable(m, how):
    wse = m.WSE_Interface()
    try:
        A = m.WSE_Array("A", shape=(8, 8, 6))
        B = m.WSE_Array("B", shape=(8, 8, 6))
        if how == "degree3":
            A[1:-1, 0, 0] = A[1:-1, 0, 0] * A[1:-1, 0, 0] * A[1:-1, 1, 0]
        elif how == "div_field":
            A[1:-1, 0, 0] = A[1:-1, 0, 0] / (A[1:-1, 1, 0] + 2.0)
        elif how == "div_zero":
            A[1:-1, 0, 0] = A[1:-1, 0, 0] / 0.0
        elif how == "cross_tile":
            A[1:-1, 0, 0] = 0.5 * A[1:-1, 0, 0]
            B[1:-1, 0, 0] = B[1:-1, 0, 0] + 0.1 * A[1:-1, 1, 0]
        return wse.program.ops
    finally:
        wse.__exit__()


@pytest.mark.parametrize("how", ["degree3", "div_field", "div_zero",
                                 "cross_tile"])
def test_lowering_errors_match_reference(how):
    with pytest.raises(ref_compiler.LoweringError) as ref:
        ref_compiler.lower_group(_unlowerable(ref_core, how))
    with pytest.raises(port_compiler.LoweringError) as port:
        port_compiler.lower_group(_unlowerable(port_core, how))
    assert str(port.value) == str(ref.value)


def _three_update_body(m, A0, C0, B0):
    """Multi-field, off-axis, multi-update: a 2-tap coefficient product, B
    reading A's new value at dz = ±1, and A re-written from its own new
    value at dz = -1 (the CUDA kernel's in-place hazard path)."""
    wse = m.WSE_Interface()
    A = m.WSE_Array("A", init_data=A0, dtype=A0.dtype)
    C = m.WSE_Array("C", init_data=C0, dtype=C0.dtype)
    B = m.WSE_Array("B", init_data=B0, dtype=B0.dtype)
    with m.WSE_For_Loop("t", 4):
        A[1:-1, 0, 0] = A[1:-1, 0, 0] + 0.05 * (
            A[2:, 0, 0] + A[:-2, 0, 0] + A[1:-1, 1, 0] + A[1:-1, -1, 0]
            - 4.0 * A[1:-1, 0, 0]) + C[1:-1, 0, 0] * (
            A[1:-1, 1, 1] + A[1:-1, -1, -1] - 2.0 * A[1:-1, 0, 0])
        B[1:-1, 0, 0] = 0.5 * B[1:-1, 0, 0] + 0.25 * (
            A[2:, 0, 0] + A[:-2, 0, 0]) + 0.125
        A[2:-1, 0, 0] = A[2:-1, 0, 0] - 0.01 * A[1:-2, 0, 0]
    return wse


def _ref_kernel_eager(group, names, padded, nx, ny, k, h):
    """The reference kernel's sub-step loop (``_fused_body``) over one block
    covering the whole padded window, op by op."""
    nz_of = {n: a.shape[2] for n, a in zip(names, padded)}
    with jax.disable_jit():
        cur = {n: jnp.asarray(a) for n, a in zip(names, padded)}
        gx0 = gy0 = -k * h
        for s in range(k):
            out_x = nx + 2 * (k - s - 1) * h
            out_y = ny + 2 * (k - s - 1) * h
            gx0 += h
            gy0 += h
            cur = ref_fused._apply_updates(group.updates, cur, nz_of, h,
                                           out_x, out_y, gx0, gy0, nx, ny,
                                           True)
    return [np.asarray(cur[n]) for n in group.fields_written()]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_plain_version_matches_reference_kernel_bitwise(dtype, k):
    rng = np.random.default_rng(3)
    shape = (11, 9, 7)
    A0 = rng.uniform(0.0, 1.0, shape).astype(dtype)
    C0 = rng.uniform(0.0, 0.05, shape).astype(dtype)
    B0 = rng.uniform(0.0, 1.0, shape).astype(dtype)
    env = {"A": A0, "C": C0, "B": B0}
    wse = _three_update_body(port_core, A0, C0, B0)
    prog = wse.program
    wse.__exit__()
    group = port_compiler.lower_group(prog.ops)
    specs, (nx, ny) = _field_specs(group, {n: f.shape for n, f in prog.fields.items()},
                                   {n: f.dtype for n, f in prog.fields.items()})
    kernel, written = build_fused_call(group.updates, specs, group.halo, nx, ny,
                                       nx, ny, time_tile=k, wrap=True)
    assert kernel.hazard and written == ("A", "B")
    padded = [_wrap_pad(torch.tensor(env[n]), kernel.pad) for n in kernel.in_names]
    got = fused_step_ref(kernel, padded)
    with jax.enable_x64(np.dtype(dtype) == np.float64):
        want = _ref_kernel_eager(group, kernel.in_names,
                                 [p.numpy() for p in padded], nx, ny, k, 1)
    for g, w in zip(got, want):
        assert g.dtype == (torch.float64 if dtype == np.float64
                           else torch.float32)
        np.testing.assert_array_equal(g.numpy(), w)


def _counters(s):
    return (s.groups_fused, s.kernels_built, s.cache_hits, s.fallbacks)


def test_compiler_counters_match_reference():
    """Make the same sequence of programs in both packages: two identical
    heat makes (one build, one cache hit), a non-affine body (one
    fallback), the coupled body (one more build)."""
    seqs = {}
    for pkg, compiler, run in (
            ("ref", ref_compiler,
             lambda b, n: run_ref(b, n, np.float32, backend="pallas")),
            ("port", port_compiler,
             lambda b, n: run_port(b, n, backend="pallas"))):
        compiler.reset_stats()
        compiler.clear_cache()
        seq = []
        heat, _ = program_inputs("heat", np.float32)
        for _ in range(2):
            run(heat, 3)
            seq.append(_counters(compiler.stats))
        T0 = np.random.default_rng(1).uniform(0.5, 1.0, (8, 8, 6)).astype(np.float32)

        def nonaffine(m, n):
            wse = m.WSE_Interface()
            T = m.WSE_Array("T_nl", init_data=T0)
            with m.WSE_For_Loop("t", n):
                T[1:-1, 0, 0] = T[1:-1, 0, 0] * T[1:-1, 0, 0] * T[1:-1, 1, 0]
            return wse, T

        run(nonaffine, 2)
        seq.append(_counters(compiler.stats))
        assert "non-affine" in compiler.stats.fallback_reasons[0]
        coupled, _ = program_inputs("coupled", np.float32)
        run(coupled, 3)
        seq.append(_counters(compiler.stats))
        seqs[pkg] = seq
    assert seqs["port"] == seqs["ref"]
    assert seqs["port"][-1] == (3, 2, 1, 1)


def test_cuda_launcher_refuses_cpu_tensors():
    """The CUDA path launches or raises: it never computes a CPU tensor."""
    build, _ = program_inputs("heat", np.float32)
    wse, T = build(port_core, 2)
    group = port_compiler.lower_group(wse.program.ops)
    wse.__exit__()
    specs, (nx, ny) = _field_specs(group, {"T_n": T.shape}, {"T_n": T.dtype})
    kernel, _ = build_fused_call(group.updates, specs, group.halo, nx, ny, nx,
                                 ny, wrap=True, device="cpu")
    padded = [_wrap_pad(torch.tensor(T.init_data), 1)]
    before = launch_fused.launches
    with pytest.raises(ValueError, match="not CUDA"):
        launch_fused(kernel, padded)
    assert launch_fused.launches == before


def _outside_kernel_limits(how):
    """A body the reference fuses but the CUDA kernel cannot take."""
    wse = port_core.WSE_Interface()
    try:
        if how == "float16":
            A = port_core.WSE_Array("A", shape=(8, 8, 6), dtype=np.float16)
            srcs = [A]
        elif how == "mixed_f32_f64":
            A = port_core.WSE_Array("A", shape=(8, 8, 6), dtype=np.float32)
            srcs = [A, port_core.WSE_Array("B", shape=(8, 8, 6),
                                           dtype=np.float64)]
        else:   # one field more than the kernel's pointer tables hold
            A = port_core.WSE_Array("A", shape=(8, 8, 6))
            srcs = [A] + [port_core.WSE_Array(f"F{i}", shape=(8, 8, 6))
                          for i in range(MAX_FIELDS)]
        with port_core.WSE_For_Loop("t", 2):
            rhs = 0.5 * A[1:-1, 1, 0]
            for s in srcs[1:]:
                rhs = rhs + 0.1 * s[1:-1, 0, 0]
            A[1:-1, 0, 0] = rhs
        prog = wse.program
        return prog.ops, {n: f.shape for n, f in prog.fields.items()}, \
            {n: f.dtype for n, f in prog.fields.items()}
    finally:
        wse.__exit__()


@pytest.mark.parametrize("how", ["float16", "mixed_f32_f64", "too_many_fields"])
def test_body_outside_kernel_limits_raises_on_cuda(how):
    """A body K1 cannot take raises on the card; it is not a lowering error,
    so ``try_compile`` does not turn it into an interpreter fallback.  The
    limits are checked before any CUDA call, so this runs without a card."""
    ops, shapes, dtypes = _outside_kernel_limits(how)
    port_compiler.reset_stats()
    port_compiler.clear_cache()
    with pytest.raises(ValueError, match="dtype|fields"):
        port_compiler.try_compile(
            lambda: port_compiler.compile_group(ops, shapes, dtypes,
                                                device="cuda"), None)
    assert port_compiler.stats.fallbacks == 0
    assert port_compiler.stats.kernels_built == 0


def test_failed_nvcc_build_raises(tmp_path, monkeypatch):
    """A compiler that refuses the source raises KernelBuildError; nothing
    falls back and no library is left behind."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kbuild, "_LIBS", {})
    with pytest.raises(kbuild.KernelBuildError, match="refused"):
        kbuild.load_library("fused_stencil")
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_bitwise():
    """On a card: K1 equals fused_step_ref bit for bit (chip_smoke.py runs
    the same check at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    for dtype in (np.float32, np.float64):
        A0, C0, B0 = (rng.uniform(0.0, 1.0, (37, 29, 11)).astype(dtype)
                      for _ in range(3))
        wse = _three_update_body(port_core, A0, C0, B0)
        prog = wse.program
        wse.__exit__()
        group = port_compiler.lower_group(prog.ops)
        specs, (nx, ny) = _field_specs(
            group, {n: f.shape for n, f in prog.fields.items()},
            {n: f.dtype for n, f in prog.fields.items()})
        env = {"A": A0, "C": C0, "B": B0}
        for k in (1, 2):
            kernel, _ = build_fused_call(group.updates, specs, group.halo, nx,
                                         ny, nx, ny, time_tile=k, wrap=True,
                                         device="cuda")
            padded = [_wrap_pad(torch.tensor(env[n], device="cuda"), kernel.pad)
                      for n in kernel.in_names]
            for g, w in zip(launch_fused(kernel, padded),
                            fused_step_ref(kernel, padded)):
                assert torch.equal(g, w)
