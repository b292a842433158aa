"""K5's launch shape and per-tile plain version against the JAX reference,
on the CPU.

* :func:`spmv_launch_shape` tiles every output cell of a brick exactly
  once with no empty tile, within CUDA's grid limits and K5's limits
  (≤ 128 products per thread, ≤ 2048 partials on the 512×512×128 brick,
  ≥ 528 blocks where the brick has that many tiles) — computed from the
  shape alone, nothing allocated at full size;
* :func:`spmv_dot_tiles_ref` sums each tile of that shape, in the kernel's
  partial order, and its partials sum to the JAX reference's
  ``spmv_dot(..., interpret=True)`` partials within ``2·1e-5·Σ|c·Ap|``
  (float32: both sum in float32, in other orders).
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.spmv import spmv_dot as ref_spmv_dot
from repro_torch.kernels.spmv import (TARGET_BLOCKS, XC_MAX, CELLS,
                                      spmv_dot_ref, spmv_dot_tiles_ref,
                                      spmv_launch_shape, tile_sums)
from repro_torch.kernels.stencil7 import MAX_GRID

#: the reference's kernel test shapes, a ragged brick with Z > 128, and
#: the 2×2 and 1×1 meshes' bricks of 512×512×128
SHAPE_BRICKS = [(3, 7, 9), (6, 10, 5), (7, 130, 12), (70, 37, 130),
                (256, 256, 128), (512, 512, 128)]
#: bricks small enough to run the JAX reference in interpret mode
SMALL_BRICKS = [(3, 7, 9), (6, 10, 5), (7, 130, 12), (4, 4, 4)]
DOT_REL = 1e-5


def _tiles(extent, size, tiles):
    """The half-open ranges of ``tiles`` tiles of ``size`` over an axis."""
    return [(t * size, min((t + 1) * size, extent)) for t in range(tiles)]


@pytest.mark.parametrize("brick", SHAPE_BRICKS)
def test_spmv_launch_shape_covers_every_cell_once(brick):
    bx, by, nz = brick
    s = spmv_launch_shape(bx, by, nz)
    y_t, x_t, z_t = s.grid
    assert s.block == (32, s.ty) and 32 * s.ty <= 1024
    assert 1 <= s.xc <= XC_MAX and s.xc * CELLS <= 128
    assert s.partials == x_t * y_t * z_t
    assert x_t <= MAX_GRID and z_t <= MAX_GRID
    # per axis, the tiles are disjoint, in order, non-empty and cover the
    # extent, so their products cover each cell once
    for extent, size, tiles in ((bx, s.xc, x_t), (by, s.ty, y_t), (nz, s.zc, z_t)):
        ranges = _tiles(extent, size, tiles)
        assert all(lo < hi for lo, hi in ranges)
        assert ranges[0][0] == 0 and ranges[-1][1] == extent
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if bx * y_t * z_t >= TARGET_BLOCKS:
        assert s.partials >= TARGET_BLOCKS
    if brick == (512, 512, 128):
        assert s.partials <= 2048


@pytest.mark.parametrize("brick", [(0, 4, 4), (4, 0, 4), (4, 4, 0)])
def test_spmv_launch_shape_refuses_an_empty_brick(brick):
    with pytest.raises(ValueError):
        spmv_launch_shape(*brick)


@pytest.mark.parametrize("brick", SMALL_BRICKS + [(70, 37, 130)])
def test_tile_sums_follow_the_kernel_order(brick):
    """Partial ``(z·x tiles + x)·y tiles + y`` is the sum over tile (x, y,
    z), checked cell range by cell range in float64."""
    bx, by, nz = brick
    s = spmv_launch_shape(bx, by, nz)
    y_t, x_t, z_t = s.grid
    v = np.random.default_rng(sum(brick)).normal(size=brick)
    got = tile_sums(torch.from_numpy(v), s).numpy()
    want = np.empty(s.partials)
    for zt, xt, yt in itertools.product(range(z_t), range(x_t), range(y_t)):
        (x0, x1), (y0, y1), (z0, z1) = (
            _tiles(bx, s.xc, x_t)[xt], _tiles(by, s.ty, y_t)[yt],
            _tiles(nz, s.zc, z_t)[zt])
        want[(zt * x_t + xt) * y_t + yt] = v[x0:x1, y0:y1, z0:z1].sum()
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("brick", SMALL_BRICKS)
def test_spmv_dot_tiles_ref_sums_to_the_dot(brick, dtype):
    """The partials sum to spmv_dot_ref's dot, in the accumulation dtype."""
    bx, by, nz = brick
    P = torch.from_numpy(np.random.default_rng(3 + sum(brick)).normal(
        size=(bx + 2, by + 2, nz)).astype(dtype))
    av, dot = spmv_dot_ref(P, 1.0, -0.0625)
    parts = spmv_dot_tiles_ref(P, 1.0, -0.0625)
    assert parts.dtype == dot.dtype
    assert parts.shape == (spmv_launch_shape(bx, by, nz).partials,)
    scale = float((P[1:-1, 1:-1].double() * av.double()).abs().sum())
    rel = DOT_REL if dtype == np.float32 else 1e-13
    assert abs(float(parts.sum()) - float(dot)) <= rel * scale


@pytest.mark.parametrize("brick", SMALL_BRICKS)
def test_spmv_dot_tiles_ref_matches_reference_partials(brick):
    """Σ of the port's per-tile partials vs Σ of the reference kernel's
    (interpret mode), float32."""
    bx, by, nz = brick
    P = np.random.default_rng(11 + sum(brick)).normal(
        size=(bx + 2, by + 2, nz)).astype(np.float32)
    _, ref_parts = ref_spmv_dot(jnp.asarray(P), 1.0, -0.0625, interpret=True)
    Pt = torch.from_numpy(P)
    parts = spmv_dot_tiles_ref(Pt, 1.0, -0.0625)
    av, _ = spmv_dot_ref(Pt, 1.0, -0.0625)
    scale = float(np.abs(P[1:-1, 1:-1].astype(np.float64) * av.double().numpy()).sum())
    got, want = float(torch.sum(parts)), float(np.asarray(ref_parts).sum())
    assert abs(got - want) <= 2 * DOT_REL * scale
