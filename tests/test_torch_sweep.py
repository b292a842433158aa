"""K1's sweep off the card: its geometry, and its schedule's plain version
against the trapezoid and against the JAX reference.

* :func:`sweep_geoms` — simulated in NumPy over ragged bricks, k ∈ {2, 3,
  8}, h ∈ {1, 2}, the padded mode and margins k·h and k·h + 1 — has
  sub-step ``s`` write exactly the cells the trapezoid computes at ``s``,
  at their global coordinates, and read only inside its buffer and inside
  what sub-step ``s − 1`` wrote;
* :func:`fused_sweep_ref` (one plain sub-step per geometry, through
  NaN-filled full-extent scratch) equals :func:`fused_step_ref` **bitwise**
  at float32 and float64, in both modes, on the bodies of
  ``test_torch_cuda.K1_BODIES`` and ``HAZARD_BODIES`` (halo 2, mixed nz
  and hazard updates among them; the hazard bodies at k = 8 too), for
  bricks at the grid's low and high edges with ``wrap``;
* at k = 2 it equals the reference kernel's arithmetic (``_apply_updates``
  op by op) bitwise, hazard bodies included;
* the grids the launcher holds for the sweep (one per sub-step, from
  :func:`k1_launch_shape`, the only grid the C entry launches) cover each
  sub-step's region exactly once.

``test_torch_cuda.py`` holds the sweep entry itself against
``fused_step_ref`` on a card.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.compiler as ref_compiler
import repro.core as ref_core
from repro_torch.compiler.codegen import _wrap_pad
from repro_torch.kernels.fused import (K1_CELLS, _sweep_held, fused_entry,
                                       fused_step_ref, fused_sweep_ref,
                                       k1_launch_shape, sweep_geoms)
from test_torch_compiler import _ref_kernel_eager
from test_torch_cuda import (HAZARD_BODIES, K1_BODIES, brick_window, k1_body,
                             k1_kernel)
from test_torch_k1 import _heat_kernel


@pytest.mark.parametrize("bx,by", [(5, 3), (7, 12)])
@pytest.mark.parametrize("extra", [None, 0, 1])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_sweep_geoms_write_the_trapezoid_and_read_inside(k, h, extra, bx, by):
    """``extra=None`` is the padded mode; else the margin is k·h + extra."""
    nx, ny = bx + 4, by + 5
    M = 0 if extra is None else k * h + extra
    kern = dataclasses.replace(_heat_kernel(4, 4, 6), k=k, halo=h, bx=bx,
                               by=by, nx=nx, ny=ny, margin=M)
    ex, ey = kern.extent
    base = M - k * h if M else 0          # the window's origin in the inputs
    wx, wy = bx + 2 * k * h, by + 2 * k * h
    for coords in ((0, 0), (nx - bx, ny - by), (2, 1)):
        geoms = sweep_geoms(kern, coords)
        assert len(geoms) == k
        prev = np.ones((ex, ey), bool)    # sub-step 0 reads the input
        for s, g in enumerate(geoms):
            last = s == k - 1
            assert (g.nx, g.ny, g.h, g.wrap, g.in_py) == (nx, ny, h, 1, ey)
            # reads: the region's h-deep window, inside the buffer and
            # inside what the previous sub-step wrote
            lo = g.in_off
            assert lo >= 0 and lo + g.bx + 2 * h <= ex and lo + g.by + 2 * h <= ey
            read = np.zeros((ex, ey), bool)
            read[lo:lo + g.bx + 2 * h, lo:lo + g.by + 2 * h] = True
            assert prev[read].all(), (s, coords)
            # writes: exactly the trapezoid's cells of sub-step s, in the
            # full-extent scratch or (last) at the brick's place in the
            # outputs
            shape = (bx, by) if last and not M else (ex, ey)
            assert g.out_py == shape[1]
            o = g.out_off
            assert o >= 0 and o + g.bx <= shape[0] and o + g.by <= shape[1]
            wrote = np.zeros(shape, bool)
            wrote[o:o + g.bx, o:o + g.by] = True
            want = np.zeros(shape, bool)
            d = (s + 1) * h
            if last and not M:
                want[:] = True
            else:
                want[base + d:base + wx - d, base + d:base + wy - d] = True
            np.testing.assert_array_equal(wrote, want)
            # the region's first cell: window cell (s+1)·h, read around it
            assert lo + h == base + d
            assert (g.cx, g.cy) == (coords[0] - k * h + d, coords[1] - k * h + d)
            prev = wrote


@pytest.mark.parametrize("mode", ["padded", "margin"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", K1_BODIES + HAZARD_BODIES[1:])
def test_sweep_plain_schedule_equals_fused_step_ref_bitwise(name, dtype, mode):
    """Bricks of about half the grid at its low and high corners, k = 2
    and 3 (and 8 for a hazard body), margins k·h and k·h + 1 in margin
    mode: the schedule's result is the trapezoid's, bit for bit (margins of
    the outputs left alone)."""
    whole, env = k1_kernel(name, dtype, "cpu")
    nx, ny, h = whole.nx, whole.ny, whole.halo
    bx, by = nx // 2 + 1, ny // 2 + 1
    for k in (2, 3, 8) if whole.hazard else (2, 3):
        for M in ((k * h, k * h + 1) if mode == "margin" else (0,)):
            kern, _ = k1_kernel(name, dtype, "cpu", margin=M, k=k,
                                brick=(bx, by))
            assert fused_entry(kern) == "sweep"
            for coords in ((0, 0), (nx - bx, ny - by)):
                ins = [torch.tensor(brick_window(env[n], coords, bx, by,
                                                 M or kern.pad))
                       for n in kern.in_names]
                outs = {}
                for fn in (fused_sweep_ref, fused_step_ref):
                    out = ([torch.full_like(ins[kern.in_names.index(n)], -7.0)
                            for n in kern.written] if M else None)
                    outs[fn] = fn(kern, ins, coords, out=out)
                for g, w in zip(outs[fused_sweep_ref], outs[fused_step_ref]):
                    assert torch.equal(g, w), (k, M, coords)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", K1_BODIES + HAZARD_BODIES[1:])
def test_sweep_plain_schedule_matches_reference_kernel_at_k2(name, dtype):
    """The same seeded fields through the reference kernel's two sub-steps
    (``_apply_updates`` op by op) and through ``fused_sweep_ref``."""
    kern, env = k1_kernel(name, dtype, "cpu", k=2)
    assert fused_entry(kern) == "sweep"
    padded = [_wrap_pad(torch.tensor(env[n]), kern.pad) for n in kern.in_names]
    got = fused_sweep_ref(kern, padded)
    wse, _ = k1_body(ref_core, name, dtype)
    group = ref_compiler.lower_group(wse.program.ops)
    wse.__exit__()
    with jax.enable_x64(np.dtype(dtype) == np.float64):
        want = _ref_kernel_eager(group, kern.in_names,
                                 [p.numpy() for p in padded], kern.bx,
                                 kern.by, 2, kern.halo)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("nz", [11, 128, 513])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_sweep_held_grids_cover_each_region_once(k, h, nz):
    """Each sub-step's held grid and block, simulated thread by thread over
    the region (``blockIdx.y`` = x, ``blockIdx.x·BY + threadIdx.y`` = y, a
    ``K1_CELLS``-wide z walk), hit every cell of it once."""
    kern = dataclasses.replace(_heat_kernel(5, 7, nz), k=k, halo=h,
                               nx=9, ny=11, margin=k * h)
    geoms = sweep_geoms(kern, (3, 4))
    (_, grids, (bz, bty), _), _, _ = _sweep_held(kern, (3, 4))
    assert len(grids) == 2 * k
    for s, g in enumerate(geoms):
        gx, gy = grids[2 * s], grids[2 * s + 1]
        assert ((gx, gy), (bz, bty)) == k1_launch_shape(kern, (g.bx, g.by))
        hits = np.zeros((g.bx, g.by, nz), np.int64)
        for x in range(gy):
            for bj in range(gx):
                for ty in range(bty):
                    j = bj * bty + ty
                    if j >= g.by:
                        continue
                    for tz in range(bz):
                        for zc in range(tz, nz, K1_CELLS * bz):
                            for c in range(K1_CELLS):
                                if zc + c * bz < nz:
                                    hits[x, j, zc + c * bz] += 1
        np.testing.assert_array_equal(hits, 1)
