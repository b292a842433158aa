"""K4's launch shape and tile schedule on the CPU.

* :func:`k4_launch_shape` tiles every fine cell of a level exactly once,
  in order and with no empty tile, within CUDA's grid limits — computed
  from the shape alone, nothing allocated at full size — on every level
  pair of the 512×512×128 hierarchy and on the card tests' ``SHAPES``, and
  refuses an empty level;
* :func:`launch_prolong` hands the C entry the level pair and
  :func:`k4_launch_shape`'s grid, block and tile depth (a stand-in library
  records the call), and counts the launch by level;
* :func:`prolong_tiles_ref` — the kernel's march over coarse planes ``I``,
  emitting fine planes ``2I`` and ``2I + 1`` from staged x-pass tiles — is
  bitwise equal to :func:`prolong_ref` and to the reference's
  ``repro.kernels.transfer.prolong_ref`` on odd, even and ragged shapes at
  float32 and float64, with random coarse Moat values, at the shape's own
  tile depth and at forced ones.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from repro.kernels import transfer as ref_transfer
from repro_torch.kernels import transfer as port_transfer
from repro_torch.kernels.transfer import (K4_TY, K4_XC, K4_ZC, MAX_GRID,
                                          coarsen_shape, k4_launch_shape,
                                          launch_prolong, prolong_ref,
                                          prolong_tiles_ref)
from test_torch_cuda import LEVEL_PAIRS, SHAPES

#: odd, even and ragged levels; the last two span several y tiles, x tiles
#: and z chunks
SCHEDULE_SHAPES = [(9, 9, 9), (16, 12, 10), (8, 7, 6), (17, 17, 5),
                   (33, 35, 130), (40, 18, 260)]


def _tiles(extent, size, tiles):
    """The half-open ranges of ``tiles`` tiles of ``size`` over an axis."""
    return [(t * size, min((t + 1) * size, extent)) for t in range(tiles)]


def _with_xc(shape, xc):
    """``k4_launch_shape(*shape)`` with its tile depth forced to ``xc``."""
    s = k4_launch_shape(*shape)
    return s._replace(grid=(s.grid[0], -(-(-(-shape[0] // 2)) // xc), s.grid[2]),
                      xc=xc)


@pytest.mark.parametrize("level", LEVEL_PAIRS + SHAPES)
def test_k4_launch_shape_covers_every_fine_cell_once(level):
    nx, ny, nz = level
    s = k4_launch_shape(nx, ny, nz)
    y_t, x_t, z_t = s.grid
    assert s.block == (32, K4_TY)
    assert 1 <= s.xc <= K4_XC and x_t == -(-(-(-nx // 2)) // K4_XC)
    assert x_t <= MAX_GRID and z_t <= MAX_GRID
    # per axis, in fine cells, the tiles are disjoint, in order, non-empty
    # and cover the extent, so their products cover each cell once
    for extent, size, tiles in ((nx, 2 * s.xc, x_t), (ny, 2 * K4_TY, y_t),
                                (nz, K4_ZC, z_t)):
        ranges = _tiles(extent, size, tiles)
        assert all(lo < hi for lo, hi in ranges)
        assert ranges[0][0] == 0 and ranges[-1][1] == extent
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("level", [(0, 4, 4), (4, 0, 4), (4, 4, 0)])
def test_k4_launch_shape_refuses_an_empty_level(level):
    with pytest.raises(ValueError):
        k4_launch_shape(*level)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launcher_passes_the_launch_shape(dtype, monkeypatch):
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    lib = SimpleNamespace(prolong_f32=entry, prolong_f64=entry)
    monkeypatch.setattr(port_transfer, "_library", lambda: lib)
    monkeypatch.setattr(port_transfer, "_check", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=7))
    fine = (33, 35, 130)
    coarse = torch.zeros(coarsen_shape(fine), dtype=dtype)
    before = launch_prolong.launches
    at_level = launch_prolong.by_level.get(fine, 0)
    out = launch_prolong(coarse, fine)
    assert out.shape == fine and out.dtype == dtype
    assert launch_prolong.launches == before + 1
    assert launch_prolong.by_level[fine] == at_level + 1
    (args,) = calls
    s = k4_launch_shape(*fine)
    assert list(args[2]) == [*fine, *coarsen_shape(fine)]
    assert args[3:9] == (*s.grid, *s.block, s.xc)
    assert args[9:] == (None, 7)


def _reference_prolong(coarse: np.ndarray, shape) -> np.ndarray:
    """The reference's plain prolongation, eagerly, at the coarse dtype."""
    with jax.enable_x64(coarse.dtype == np.float64), jax.disable_jit():
        return np.asarray(ref_transfer.prolong_ref(coarse, shape))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_tile_schedule_bitwise_vs_plain_and_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    coarse = rng.normal(size=coarsen_shape(shape)).astype(dtype)  # Moat too
    got = prolong_tiles_ref(torch.from_numpy(coarse), shape)
    assert got.dtype == torch.from_numpy(coarse).dtype
    assert torch.equal(got, prolong_ref(torch.from_numpy(coarse), shape))
    np.testing.assert_array_equal(got.numpy(), _reference_prolong(coarse, shape))


@pytest.mark.parametrize("xc", [1, 3, 16])
def test_tile_schedule_any_depth(xc):
    shape = (33, 35, 130)
    rng = np.random.default_rng(xc)
    coarse = torch.from_numpy(rng.normal(size=coarsen_shape(shape)))
    got = prolong_tiles_ref(coarse, shape, _with_xc(shape, xc))
    assert torch.equal(got, prolong_ref(coarse, shape))
