"""K1's k = 1 entry off the card: its launch shape, its routing, and the
plain version of the bodies it serves against the JAX reference.

* :func:`k1_launch_shape` — simulated in NumPy over ragged bricks — covers
  every ``(x, y, z)`` cell exactly once (each ``(x, y)`` column by one
  thread row, each ``z`` of it by one thread's ``z`` walk, ``K1_CELLS``
  cells at a time), and raises
  ``ValueError`` past CUDA's grid limits;
* :func:`fused_entry` routes exactly the ``k == 1``, hazard-free kernels
  to the k = 1 route, the ``k > 1`` hazard-free ones to the sweep, and
  hazard bodies to the generic entry, in both modes;
* ``fused_step_ref`` at k = 1 equals the reference kernel's arithmetic
  **bitwise** at float32 and float64 on the k = 1 bodies of
  ``test_torch_cuda.py`` (which holds the entry itself against
  ``fused_step_ref`` on a card).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.compiler as ref_compiler
import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch.compiler import lower_group
from repro_torch.compiler.codegen import _field_specs, _wrap_pad
from repro_torch.kernels.fused import (K1_CELLS, MAX_GRID_X, MAX_GRID_Y,
                                       THREADS, build_fused_call, fused_entry,
                                       fused_step_ref, k1_launch_shape)
from test_torch_compiler import _ref_kernel_eager
from test_torch_cuda import K1_BODIES, _hazard_body, k1_body, k1_kernel


def _heat_kernel(bx, by, nz, k=1, margin=0):
    """The heat body's kernel for a (bx, by, nz) brick, built for the CPU."""
    wse, _ = k1_body(port_core, "heat", np.float32)
    group = lower_group(wse.program.ops)
    wse.__exit__()
    specs = {"T": (nz, torch.float32)}
    kern, _ = build_fused_call(group.updates, specs, group.halo, bx, by, bx,
                               by, time_tile=k, wrap=True, device="cpu",
                               margin=margin)
    return kern


@pytest.mark.parametrize("nz", [1, 2, 11, 31, 65, 128, 200, 513])
@pytest.mark.parametrize("bx,by", [(1, 1), (1, 9), (5, 3), (7, 130)])
def test_k1_launch_shape_covers_every_cell_once(bx, by, nz):
    (gx, gy), (bz, bty) = k1_launch_shape(_heat_kernel(bx, by, nz))
    assert THREADS - bz < bz * bty <= THREADS and bz % 32 == 0 and bz <= 128
    assert bz * K1_CELLS >= min(nz, 128 * K1_CELLS) and gy == bx
    hits = np.zeros((bx, by, nz), np.int64)
    for x in range(gy):                        # blockIdx.y
        for bj in range(gx):                   # blockIdx.x
            for ty in range(bty):              # threadIdx.y
                j = bj * bty + ty
                if j >= by:                    # ragged y edge: no work
                    continue
                for tz in range(bz):           # threadIdx.x walks z,
                    for zc in range(tz, nz, K1_CELLS * bz):
                        for c in range(K1_CELLS):  # K1_CELLS cells at once
                            if zc + c * bz < nz:
                                hits[x, j, zc + c * bz] += 1
    np.testing.assert_array_equal(hits, 1)


@pytest.mark.parametrize("bx,by,nz", [(MAX_GRID_Y + 1, 4, 8),
                                      (2, 8 * (MAX_GRID_X + 1), 8),
                                      (2, 4 * (MAX_GRID_X + 1), 513)])
def test_k1_launch_shape_raises_past_grid_limits(bx, by, nz):
    kern = dataclasses.replace(_heat_kernel(4, 4, nz), bx=bx, by=by)
    with pytest.raises(ValueError, match="grid limits"):
        k1_launch_shape(kern)


def test_k1_launch_shape_at_the_grid_limits():
    kern = dataclasses.replace(_heat_kernel(4, 4, 8), bx=MAX_GRID_Y,
                               by=8 * MAX_GRID_X)
    assert k1_launch_shape(kern) == ((MAX_GRID_X, MAX_GRID_Y), (32, 8))


def _hazard_kernel(k):
    rng = np.random.default_rng(1)
    A0, C0, B0 = (rng.uniform(0.0, 1.0, (9, 8, 7)).astype(np.float32)
                  for _ in range(3))
    wse, _ = _hazard_body(A0, C0, B0, 2)
    prog = wse.program
    wse.__exit__()
    group = lower_group(prog.ops)
    specs, (nx, ny) = _field_specs(
        group, {n: f.shape for n, f in prog.fields.items()},
        {n: f.dtype for n, f in prog.fields.items()})
    return build_fused_call(group.updates, specs, group.halo, nx, ny, nx, ny,
                            time_tile=k, wrap=True, device="cpu")[0]


@pytest.mark.parametrize("margin", [0, 3])
@pytest.mark.parametrize("body,k,entry", [
    ("heat", 1, "k1"), ("advdiff_dz", 1, "k1"),
    ("wide_halo2_mixed_nz", 1, "k1"), ("hazard", 1, "generic"),
    ("heat", 2, "sweep"), ("advdiff_dz", 2, "sweep"),
    ("hazard", 2, "generic")])
def test_router_picks_the_k1_entry_for_k1_without_hazard(body, k, entry,
                                                          margin):
    if body == "hazard":
        kern = _hazard_kernel(k)
        assert kern.hazard
    else:
        kern, _ = k1_kernel(body, np.float32, "cpu")
        kern = dataclasses.replace(kern, k=k)
    kern = dataclasses.replace(kern, margin=margin)
    assert fused_entry(kern) == entry


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", K1_BODIES)
def test_k1_plain_version_matches_reference_kernel_bitwise(name, dtype):
    """The same seeded fields through the reference kernel's sub-step
    (``_apply_updates`` op by op) and through ``fused_step_ref`` at k = 1."""
    kern, env = k1_kernel(name, dtype, "cpu")
    assert fused_entry(kern) == "k1"
    padded = [_wrap_pad(torch.tensor(env[n]), kern.pad) for n in kern.in_names]
    got = fused_step_ref(kern, padded)
    wse, _ = k1_body(ref_core, name, dtype)
    group = ref_compiler.lower_group(wse.program.ops)
    wse.__exit__()
    with jax.enable_x64(np.dtype(dtype) == np.float64):
        want = _ref_kernel_eager(group, kern.in_names,
                                 [p.numpy() for p in padded], kern.bx,
                                 kern.by, 1, kern.halo)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        np.testing.assert_array_equal(g.numpy(), w)
