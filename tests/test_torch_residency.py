"""The PyTorch port's halo-resident layout vs its repacking step and the JAX
reference, on the CPU.

The port's counterpart of ``tests/test_residency.py``:

* the layout's enter/exit round trip and ``wrap_refresh`` are bitwise: the
  refreshed margins equal the port's ``_wrap_pad`` and the reference's
  ``wrap_refresh`` cell for cell;
* K1's plain version in margin mode (resident inputs, ping-pong outputs)
  equals its padded mode bitwise, for every test program;
* ``make(backend="pallas")`` on the resident layout (the default) equals
  ``resident=False`` bitwise, and counts two repacks per run (four around
  an interpreter segment) instead of one per launch;
* a margin below ``k·h`` and an output that shares storage with an input
  raise.
"""
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.engine as ref_engine
import repro_torch.compiler as port_compiler
import repro_torch.core as port_core
import repro_torch.engine as port_engine
from conftest import heat_init
from repro.engine.layout import HaloLayout as RefLayout
from repro.engine.layout import wrap_refresh as ref_wrap_refresh
from repro_torch.compiler import LoweringError
from repro_torch.compiler.codegen import _field_specs, _wrap_pad
from repro_torch.engine import HaloLayout, RunOptions
from repro_torch.engine.layout import slab_rects, wrap_refresh
from repro_torch.kernels import ops
from repro_torch.kernels.fused import build_fused_call
from test_torch_program import build_heat, program_inputs, run_port

PROGRAMS = ["heat", "advdiff", "negz", "coupled", "varcoef", "wide"]


# -- layout primitives --------------------------------------------------------

def test_layout_enter_exit_roundtrip_bitwise(rng):
    env = {"a": torch.tensor(rng.normal(size=(7, 9, 5)).astype(np.float32)),
           "b": torch.tensor(rng.normal(size=(3, 7, 9, 4)))}   # leading axis
    lay = HaloLayout(pad=3, shapes={"a": (7, 9, 5), "b": (7, 9, 4)})
    entered = lay.enter(env)
    assert tuple(entered["a"].shape) == (13, 15, 5)
    assert tuple(entered["b"].shape) == (3, 13, 15, 4)
    assert float(entered["a"][:3].abs().sum()) == 0.0   # margins start zero
    back = lay.exit(entered)
    for n, v in env.items():
        assert back[n].dtype == v.dtype and back[n].is_contiguous()
        assert torch.equal(back[n], v)
        # exit hands out fresh tensors: no resident buffer, no caller tensor
        for t in (*entered.values(), *env.values()):
            assert back[n].untyped_storage().data_ptr() != \
                t.untyped_storage().data_ptr()
    lay0 = HaloLayout(pad=0, shapes={})
    assert lay0.exit(lay0.enter(env))["a"] is env["a"]


def test_slab_rects_cover_the_margin_frame_once():
    bx, by, h = 5, 4, 2
    cover = np.zeros((bx + 2 * h, by + 2 * h), int)
    for ox, oy, sx, sy in slab_rects(bx, by, h).values():
        cover[h + ox:h + ox + sx, h + oy:h + oy + sy] += 1
    frame = np.ones_like(cover)
    frame[h:h + bx, h:h + by] = 0
    np.testing.assert_array_equal(cover, frame)


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("h", [1, 2, 3])
def test_wrap_refresh_matches_wrap_pad_and_reference(rng, h, lead):
    """The refreshed window equals ``_wrap_pad`` bitwise, and the whole
    buffer equals the reference's ``wrap_refresh`` of its own layout, with
    a margin deeper than the refresh and bx != by."""
    M = h + 1
    x = rng.normal(size=(*lead, 8, 6, 4)).astype(np.float32)
    buf = HaloLayout(pad=M, shapes={}).enter({"x": torch.tensor(x)})["x"]
    ptr = buf.data_ptr()
    got = wrap_refresh(buf, M, h)
    assert got is buf and got.data_ptr() == ptr      # in place
    lo = M - h
    window = got[..., lo:lo + 8 + 2 * h, lo:lo + 6 + 2 * h, :]
    flat = torch.tensor(x).reshape(-1, 8, 6, 4)
    want = torch.stack([_wrap_pad(v, h) for v in flat]).reshape(window.shape)
    assert torch.equal(window, want)
    ref = ref_wrap_refresh(RefLayout(pad=M, shapes={}).enter({"x": x})["x"],
                           M, h)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- K1's plain version: margin mode == padded mode ---------------------------

def _kernels(name, k, extra):
    """The program's lowered body as K1 in padded mode and in margin mode,
    and its initial env.  ``M = k·h + extra``; a halo-free body still runs
    the margin mode, with ``M = 1 + extra``."""
    build, _ = program_inputs(name, np.float32)
    wse, _ = build(port_core, 3)
    prog = wse.program
    wse.__exit__()
    group = port_compiler.lower_group(prog.ops)
    specs, (nx, ny) = _field_specs(
        group, {n: f.shape for n, f in prog.fields.items()},
        {n: f.dtype for n, f in prog.fields.items()})
    M = max(k * group.halo, 1) + extra
    kw = dict(time_tile=k, wrap=True, device="cpu")
    padded, _ = build_fused_call(group.updates, specs, group.halo, nx, ny, nx,
                                 ny, **kw)
    margin, _ = build_fused_call(group.updates, specs, group.halo, nx, ny, nx,
                                 ny, margin=M, **kw)
    env = {n: torch.tensor(f.init_data) for n, f in prog.fields.items()}
    return padded, margin, env


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", PROGRAMS)
def test_margin_mode_plain_version_equals_padded_mode_bitwise(name, k, extra):
    padded, margin, env = _kernels(name, k, extra)
    M, ph = margin.margin, margin.pad
    want = ops.fused_step(padded, [_wrap_pad(env[n], ph) if ph else env[n]
                                   for n in padded.in_names])
    lay = HaloLayout(pad=M, shapes={})
    ins = [wrap_refresh(lay.enter({n: env[n]})[n], M, ph)
           for n in margin.in_names]
    before = [t.clone() for t in ins]
    sentinel = -7.0
    out = [torch.full_like(ins[margin.in_names.index(n)], sentinel)
           for n in margin.written]
    got = ops.fused_step(margin, ins, out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(got, want):
        assert torch.equal(g[M:-M, M:-M], w)
        frame = g.clone()
        frame[M:-M, M:-M] = sentinel
        assert bool((frame == sentinel).all())      # margins left alone
    for t, b in zip(ins, before):
        assert torch.equal(t, b)                     # inputs never written


# -- make: resident == repack ---------------------------------------------------

@pytest.mark.parametrize("name,dtype,steps,time_tile", [
    ("heat", np.float32, 6, 1),
    ("advdiff", np.float32, 5, None),
    ("heat", np.float32, 7, 4),      # tiled remainder: 1 tiled + 3 untiled
    ("heat", np.float64, 5, 2),
    ("advdiff", np.float64, 5, 1),
])
def test_make_resident_equals_repack_bitwise(name, dtype, steps, time_tile):
    build, _ = program_inputs(name, dtype)
    port_engine.reset_stats()
    res = run_port(build, steps, backend="pallas", time_tile=time_tile)
    s = port_engine.stats
    assert (s.resident_runs, s.repacks) == (1, 2)   # enter + exit
    launches = s.launches
    assert s.exchanges == launches                   # one refresh per launch
    port_engine.reset_stats()
    leg = run_port(build, steps, backend="pallas", time_tile=time_tile,
                   resident=False)
    assert (s.resident_runs, s.repacks) == (0, launches)
    assert res.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(res, leg)


def _mixed(m, T0):
    """fused loop → non-affine loop (interpreter) → fused loop."""
    wse = m.WSE_Interface()
    T = m.WSE_Array("T_m", init_data=T0)
    with m.WSE_For_Loop("a", 2):
        T[1:-1, 0, 0] = 0.5 * T[1:-1, 0, 0] + 0.1 * T[1:-1, 1, 0]
    with m.WSE_For_Loop("b", 2):
        T[1:-1, 0, 0] = T[1:-1, 0, 0] * T[1:-1, 0, 0] * T[1:-1, 1, 0]
    with m.WSE_For_Loop("c", 2):
        T[1:-1, 0, 0] = 0.5 * T[1:-1, 0, 0] + 0.1 * T[1:-1, -1, 0]
    return wse, T


def test_mixed_plan_counts_conversions_around_interp_segments():
    """The resident run exits and re-enters the layout around the
    interpreter segment: four conversions, as the reference counts them,
    and the same bits as the repacking run."""
    T0 = heat_init((8, 8, 6))
    counts = {}
    for m, eng, opts in ((ref_core, ref_engine, dict(backend="pallas")),
                         (port_core, port_engine,
                          dict(backend="pallas", device="cpu"))):
        eng.reset_stats()
        wse, T = _mixed(m, T0)
        out = wse.make(answer=T, options=eng.RunOptions(**opts))
        counts[m] = (eng.stats.resident_runs, eng.stats.repacks,
                     eng.stats.exchanges, eng.stats.launches)
    # the auto pick fuses each 2-step loop into one k = 2 launch
    assert counts[port_core] == counts[ref_core] == (1, 4, 2, 4)
    wse, T = _mixed(port_core, T0)
    leg = wse.make(answer=T, options=RunOptions(backend="pallas", device="cpu",
                                                resident=False))
    np.testing.assert_array_equal(out, leg)


@pytest.mark.parametrize("backend,time_tile,resident,pad", [
    ("pallas", 4, True, 4),
    ("pallas", 1, True, 1),
    ("pallas", None, True, None),    # the auto pick's k·h
    ("pallas", 4, False, 0),
    ("jit", None, True, 0),
])
def test_plan_layout_margin_is_max_tile_window(backend, time_tile, resident,
                                               pad):
    wse, _ = build_heat(port_core, heat_init((24, 24, 8)), 8)
    try:
        p = port_engine.plan(wse.program, RunOptions(
            backend=backend, time_tile=time_tile, resident=resident,
            device="cpu"))
    finally:
        wse.__exit__()
    fused = [s.time_tile * s.halo for s in p.segments if s.kind == "fused"]
    if pad is None:
        pad = max(fused)
        assert pad > 1
    assert p.layout.pad == pad
    if resident and backend == "pallas":
        assert p.layout.pad == max(fused)


def test_single_runner_leaves_the_callers_tensors_alone():
    """The resident run copies the caller's tensors in and hands back fresh
    ones: nothing the caller holds is written or aliased."""
    build, _ = program_inputs("coupled", np.float32)
    wse, _ = build(port_core, 5)
    try:
        p = port_engine.plan(wse.program, RunOptions(backend="pallas",
                                                     time_tile=2, device="cpu"))
        env = {n: torch.tensor(f.init_data) for n, f in wse.program.fields.items()}
    finally:
        wse.__exit__()
    before = {n: v.clone() for n, v in env.items()}
    out = port_engine.single_runner(p)(env)
    for n, v in env.items():
        assert torch.equal(v, before[n])
        assert out[n].untyped_storage().data_ptr() != v.untyped_storage().data_ptr()
        assert tuple(out[n].shape) == tuple(v.shape) and out[n].is_contiguous()


# -- what raises ----------------------------------------------------------------

def test_margin_below_the_window_raises():
    build, _ = program_inputs("heat", np.float32)
    wse, T = build(port_core, 4)
    prog = wse.program
    wse.__exit__()
    shapes = {"T_n": T.shape}
    dtypes = {"T_n": T.dtype}
    with pytest.raises(LoweringError, match="resident margin 1 < tiled halo 2"):
        port_compiler.compile_group(prog.ops, shapes, dtypes, device="cpu",
                                    time_tile=2, resident=1)
    group = port_compiler.lower_group(prog.ops)
    specs, (nx, ny) = _field_specs(group, shapes, dtypes)
    with pytest.raises(ValueError, match="resident margin 2 < window halo 3"):
        build_fused_call(group.updates, specs, group.halo, nx, ny, nx, ny,
                         time_tile=3, wrap=True, device="cpu", margin=2)


def test_margin_mode_output_aliasing_an_input_raises():
    """The ping-pong guard: margin mode refuses an output that shares
    storage with an input (itself or a view of it) and a missing ``out=``;
    padded mode takes an optional ``out=`` at the brick's extent, refuses
    one at the resident extent, and writes the bits it returns without."""
    padded, margin, env = _kernels("coupled", 1, 0)
    M = margin.margin
    lay = HaloLayout(pad=M, shapes={})
    ins = [wrap_refresh(lay.enter({n: env[n]})[n], M, 1)
           for n in margin.in_names]
    ok = [torch.zeros_like(ins[margin.in_names.index(n)])
          for n in margin.written]
    first = margin.in_names.index(margin.written[0])
    view = ins[first].view(-1).view(ins[first].shape)
    for bad in ([ins[first], ok[1]], [view, ok[1]], [ok[0], ok[0]]):
        with pytest.raises(ValueError, match="shares storage"):
            ops.fused_step(margin, ins, out=bad)
    with pytest.raises(ValueError, match="needs out="):
        ops.fused_step(margin, ins)
    pins = [_wrap_pad(env[n], 1) for n in padded.in_names]
    nx, ny, nz = env[padded.written[0]].shape
    with pytest.raises(ValueError, match=rf"expected \({nx}, {ny}, {nz}\)"):
        ops.fused_step(padded, pins, out=ok)
    held = [torch.full_like(env[n], float("nan")) for n in padded.written]
    got = ops.fused_step(padded, pins, out=held)
    for want, g, h in zip(ops.fused_step(padded, pins), got, held):
        assert g.data_ptr() == h.data_ptr()
        torch.testing.assert_close(g, want, rtol=0, atol=0)
