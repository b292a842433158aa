"""K7's launch shape and the port's halo-plane FTCS step against the JAX
reference, on the CPU; and the port's top-level names.

* :func:`k7_launch_shape` tiles every cell of a brick exactly once with no
  empty tile, within CUDA's grid limits — computed from the shape alone,
  nothing allocated at full size — and refuses an empty brick;
* ``ops.stencil7_planes`` on the CPU (the plain version) lies within 2
  float32 ulp of the larger addend of ``c_diag·c + c_off·Σ6`` of the
  reference's ``ops.stencil7_planes`` (Pallas, interpret mode), on ragged
  bricks at coords (1, 1) of a 3×3 mesh, so that all four planes are read
  (compiled XLA contracts a·b + c into an FMA, which skips one product's
  rounding: the bound of ``test_torch_legacy.py``);
* :func:`launch_stencil_planes` hands the C entry the brick's offset and
  :func:`k7_launch_shape`'s grid, block and tile depth (a stand-in library
  records the call);
* every name of ``repro.__all__`` but the later slices' is in
  ``repro_torch.__all__`` and resolves.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro
import repro_torch
from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops
from repro_torch.kernels import stencil7 as port_stencil7
from repro_torch.kernels.stencil7 import (K7_XC, MAX_GRID, TY, ZC,
                                          k7_launch_shape,
                                          launch_stencil_planes)

#: the reference's kernel test shapes, a ragged brick with Z > 128, and
#: the 2×2 and 1×1 meshes' bricks of 512×512×128
SHAPE_BRICKS = [(3, 7, 9), (6, 10, 5), (7, 130, 12), (70, 37, 130),
                (256, 256, 128), (512, 512, 128)]
#: the ragged bricks, small enough for the reference in interpret mode
SMALL_BRICKS = SHAPE_BRICKS[:4]
#: names of ``repro`` that later slices of the port bring (none: the
#: differentiation slice brought ``make_differentiable_solver``)
LATER_SLICES = set()


def _tiles(extent, size, tiles):
    """The half-open ranges of ``tiles`` tiles of ``size`` over an axis."""
    return [(t * size, min((t + 1) * size, extent)) for t in range(tiles)]


@pytest.mark.parametrize("brick", SHAPE_BRICKS)
def test_k7_launch_shape_covers_every_cell_once(brick):
    bx, by, nz = brick
    s = k7_launch_shape(bx, by, nz)
    y_t, x_t, z_t = s.grid
    assert s.block == (32, TY)
    assert 1 <= s.xc <= K7_XC and x_t == -(-bx // K7_XC)
    assert x_t <= MAX_GRID and z_t <= MAX_GRID
    # per axis, the tiles are disjoint, in order, non-empty and cover the
    # extent, so their products cover each cell once
    for extent, size, tiles in ((bx, s.xc, x_t), (by, TY, y_t), (nz, ZC, z_t)):
        ranges = _tiles(extent, size, tiles)
        assert all(lo < hi for lo, hi in ranges)
        assert ranges[0][0] == 0 and ranges[-1][1] == extent
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("brick", [(0, 4, 4), (4, 0, 4), (4, 4, 0)])
def test_k7_launch_shape_refuses_an_empty_brick(brick):
    with pytest.raises(ValueError):
        k7_launch_shape(*brick)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launcher_passes_the_launch_shape(dtype, monkeypatch):
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    lib = SimpleNamespace(stencil_planes_f32=entry, stencil_planes_f64=entry)
    monkeypatch.setattr(port_stencil7, "library", lambda: lib)
    monkeypatch.setattr(port_stencil7, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=7))
    bx, by, nz = 70, 37, 130
    T = torch.zeros((bx, by, nz), dtype=dtype)
    planes = [torch.zeros(s, dtype=dtype)
              for s in ((1, by, nz), (1, by, nz), (bx, 1, nz), (bx, 1, nz))]
    before = launch_stencil_planes.launches
    out = launch_stencil_planes(T, *planes, (2, 1), 0.4, 0.1, 3 * bx, 3 * by)
    assert out.shape == T.shape and launch_stencil_planes.launches == before + 1
    (args,) = calls
    s = k7_launch_shape(bx, by, nz)
    assert args[6:13] == (bx, by, nz, 2 * bx, by, 3 * bx, 3 * by)
    assert args[13:19] == (*s.grid, *s.block, s.xc)
    assert args[19:] == (0.4, 0.1, None, 7)


def _addend_ulp(T, xlo, xhi, ylo, yhi, c_diag, c_off):
    """Per cell of the brick: the float32 ulp of the larger addend of
    ``c_diag·c + c_off·Σ6``, the neighbours taken from the brick and its
    planes (z edge-replicated)."""
    P = np.pad(np.concatenate([xlo, T, xhi]).astype(np.float64),
               ((0, 0), (1, 1), (0, 0)))
    P[1:-1, :1], P[1:-1, -1:] = ylo, yhi
    c = P[1:-1, 1:-1]
    zp = np.concatenate([c[:, :, 1:], c[:, :, -1:]], axis=2)
    zm = np.concatenate([c[:, :, :1], c[:, :, :-1]], axis=2)
    s = sum(np.abs(a) for a in (P[:-2, 1:-1], P[2:, 1:-1], P[1:-1, :-2],
                                P[1:-1, 2:], zp, zm))
    return np.spacing(np.maximum(abs(c_diag) * np.abs(c),
                                 abs(c_off) * s).astype(np.float32))


@pytest.mark.parametrize("brick", SMALL_BRICKS)
def test_stencil7_planes_within_2ulp_of_interpret_pallas(brick):
    bx, by, nz = brick
    rng = np.random.default_rng(17 + sum(brick))
    T = rng.normal(size=brick).astype(np.float32)
    planes = [rng.normal(size=s).astype(np.float32)
              for s in ((1, by, nz), (1, by, nz), (bx, 1, nz), (bx, 1, nz))]
    coords, nx, ny = (1, 1), 3 * bx, 3 * by
    want = np.asarray(ref_ops.stencil7_planes(
        jnp.asarray(T), *map(jnp.asarray, planes),
        jnp.asarray([coords], jnp.int32), 0.4, 0.1, nx, ny))
    before = launch_stencil_planes.launches
    got = ops.stencil7_planes(torch.from_numpy(T), *map(torch.from_numpy, planes),
                              coords, 0.4, 0.1, nx, ny).numpy()
    assert launch_stencil_planes.launches == before  # the CPU: plain version
    assert (np.abs(got - want) <= 2 * _addend_ulp(T, *planes, 0.4, 0.1)).all()
    # the middle brick of a 3×3 mesh keeps only the z faces
    assert np.array_equal(got[:, :, 0], T[:, :, 0])
    assert np.array_equal(got[:, :, -1], T[:, :, -1])
    if nz > 2:
        assert not np.array_equal(got[:, :, 1:-1], T[:, :, 1:-1])


def test_top_level_exports_cover_the_reference():
    names = set(repro.__all__) - LATER_SLICES
    assert names <= set(repro_torch.__all__), names - set(repro_torch.__all__)
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None, name
    from repro_torch import solver
    from repro_torch.core import ensemble

    for name in ("Operator", "Rhs", "SolveInfo", "NumericalFault",
                 "RecoveryPolicy"):
        assert getattr(repro_torch, name) is getattr(solver, name)
    # make and solve dispatch on Ensembles first, as the reference's do
    for name in ("Ensemble", "make", "solve"):
        assert getattr(repro_torch, name) is getattr(ensemble, name)
