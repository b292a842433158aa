"""K1's k = 1 entry off the card: its launch shape, its routing, and the
plain version of the bodies it serves against the JAX reference.

* :func:`k1_launch_shape` — simulated in NumPy over ragged bricks — covers
  every ``(x, y, z)`` cell exactly once (each ``(x, y)`` column by one
  thread row, each ``z`` of it by one thread's ``z`` walk, ``K1_CELLS``
  cells at a time), and raises
  ``ValueError`` past CUDA's grid limits;
* :func:`fused_entry` routes exactly the ``k == 1`` kernels to the k = 1
  route and the ``k > 1`` ones to the sweep, hazard bodies too, in both
  modes;
* :func:`hazard_stage_bytes` is ``BY`` × the largest hazard ``zlen`` in the
  dtype (0 without a hazard), and :func:`build_fused_call` refuses, on the
  CPU, a hazard body whose stage passes ``MAX_SHARED_BYTES``;
* the launcher, through a stand-in library, passes the hazard flag, the
  stage's bytes and the descriptor's host copy to C, counts hazard
  launches, and allocates nothing per launch past the first in margin mode
  (the padded mode's fresh outputs only);
* ``fused_step_ref`` at k = 1 equals the reference kernel's arithmetic
  **bitwise** at float32 and float64 on the k = 1 bodies of
  ``test_torch_cuda.py`` and its hazard bodies (which holds the entry
  itself against ``fused_step_ref`` on a card).
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.compiler as ref_compiler
import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch.compiler import lower_group
from repro_torch.compiler.codegen import _field_specs, _wrap_pad
from repro_torch.kernels import fused
from repro_torch.kernels.fused import (K1_CELLS, MAX_GRID_X, MAX_GRID_Y,
                                       MAX_SHARED_BYTES, THREADS,
                                       build_fused_call, column_shared_bytes,
                                       fused_entry, fused_step_ref,
                                       hazard_stage_bytes, k1_block,
                                       k1_launch_shape, launch_fused)
from test_torch_compiler import _ref_kernel_eager
from test_torch_cuda import (HAZARD_BODIES, K1_BODIES, _hazard_body,
                             brick_window, k1_body, k1_kernel)


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
    ("wide_halo2_mixed_nz", 1, "k1"), ("hazard", 1, "k1"),
    ("heat", 2, "sweep"), ("advdiff_dz", 2, "sweep"),
    ("hazard", 2, "sweep")])
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


#: the largest zlen of each hazard body's hazard updates (nz − 3, and
#: max(nz − 3, nz − 7) for the body with two)
HAZARD_ZLEN = {"heat": 0, "hazard": 6, "hazard_two_updates": 13,
               "hazard_nz200": 197, "hazard_nz600": 597}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ("heat",) + HAZARD_BODIES)
def test_hazard_stage_bytes(name, dtype):
    kern, _ = k1_kernel(name, dtype, "cpu")
    assert kern.hazard == (name != "heat")
    itemsize = np.dtype(dtype).itemsize
    bz, by = k1_block(max(kern.nz))
    assert (bz, by) == k1_launch_shape(kern)[1]
    assert hazard_stage_bytes(kern, by) == by * HAZARD_ZLEN[name] * itemsize
    head = len(kern.coefs) * (8 + itemsize) + 4 * len(kern.ints)
    want = (-(-head // 16) * 16 + by * HAZARD_ZLEN[name] * itemsize
            if kern.hazard else head)
    assert column_shared_bytes(kern, by) == want


def _long_hazard_body(nz, dtype):
    """A heat update, then a hazard update over z [2, nz − 1), on a 4×4×nz
    field: BY = 2 and a stage of 2·(nz − 3) elements."""
    wse = port_core.WSE_Interface()
    T0 = np.ones((4, 4, nz), dtype)
    T = port_core.WSE_Array("T", init_data=T0, dtype=T0.dtype)
    with port_core.WSE_For_Loop("t", 2):
        T[1:-1, 0, 0] = 0.4 * T[1:-1, 0, 0] + 0.1 * (
            T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0] + T[1:-1, -1, 0])
        T[2:-1, 0, 0] = T[2:-1, 0, 0] - 0.01 * T[1:-2, 0, 0]
    prog = wse.program
    wse.__exit__()
    group = lower_group(prog.ops)
    return group, {"T": (nz, torch.from_numpy(T0).dtype)}


@pytest.mark.parametrize("dtype,nz,fits", [
    (np.float32, 28000, True), (np.float32, 29500, False),
    (np.float64, 14000, True), (np.float64, 14800, False)])
def test_build_refuses_a_hazard_stage_over_the_shared_memory_budget(
        dtype, nz, fits):
    """Checked at build, on every device, before touching CUDA: there is
    no other route to fall back to."""
    group, specs = _long_hazard_body(nz, dtype)
    stage = 2 * (nz - 3) * np.dtype(dtype).itemsize
    assert (stage < MAX_SHARED_BYTES - 1024) == fits
    for k in (1, 2):
        if fits:
            kern, _ = build_fused_call(group.updates, specs, group.halo, 4, 4,
                                       4, 4, time_tile=k, wrap=True,
                                       device="cpu")
            assert kern.hazard and hazard_stage_bytes(kern, 2) == stage
            assert column_shared_bytes(kern, 2) <= MAX_SHARED_BYTES
        else:
            with pytest.raises(ValueError, match="shared memory"):
                build_fused_call(group.updates, specs, group.halo, 4, 4, 4, 4,
                                 time_tile=k, wrap=True, device="cpu")


@pytest.mark.parametrize("mode", ["padded", "margin"])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["heat", "hazard"])
def test_launcher_passes_the_hazard_stage_and_holds_its_scratch(
        name, dtype, k, mode, monkeypatch):
    """Through a stand-in library: one C call per launch with the sweep's
    geometry, the block, the descriptor's host copy, the hazard flag, the
    stage's bytes and one member; ``hazard_launches`` counts hazard bodies; the
    scratch is allocated at the first launch only, and a margin-mode
    launch allocates nothing after it (a padded one its fresh outputs)."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    lib = SimpleNamespace(fused_sweep_f32=entry, fused_sweep_f64=entry)
    monkeypatch.setattr(fused, "_library", lambda: lib)
    monkeypatch.setattr(fused, "_check_inputs",
                        lambda kernel, inputs: kernel.device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=7))
    cpu, env = k1_kernel(name, dtype, "cpu", k=k)
    M = k * cpu.halo + 1 if mode == "margin" else 0
    cpu, _ = k1_kernel(name, dtype, "cpu", k=k, margin=M)
    # the kernel as built for a card, its descriptor's copies on the host
    kern = dataclasses.replace(
        cpu, device=torch.device("cuda", 0),
        ints_dev=torch.tensor(cpu.ints, dtype=torch.int32),
        coefs_dev=torch.tensor(cpu.coefs, dtype=torch.float64))
    ins = [torch.tensor(brick_window(env[n], (0, 0), kern.bx, kern.by,
                                     M or kern.pad)) for n in kern.in_names]
    out = ([torch.zeros_like(ins[kern.in_names.index(n)])
            for n in kern.written] if M else None)
    empty, allocated = torch.empty, []

    def counting_empty(*shape, device=None, **kw):
        allocated.append(shape)
        return empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", counting_empty)
    before = (launch_fused.launches, launch_fused.hazard_launches)
    per_launch = []
    for _ in range(2):
        n = len(allocated)
        launch_fused(kern, ins, out=out)
        per_launch.append(len(allocated) - n)
    assert (launch_fused.launches - before[0],
            launch_fused.hazard_launches - before[1]) == (2, 2 * kern.hazard)
    fresh = 0 if M else len(kern.written)
    scratch = len(kern.written) * min(k - 1, 2)
    assert per_launch == [fresh + scratch, fresh]
    assert len(calls) == 2
    bz, by = k1_block(max(kern.nz))
    stage = by * HAZARD_ZLEN[name] * np.dtype(dtype).itemsize
    for args in calls:
        assert args[5] == len(kern.in_names) and args[10:13] == (k, bz, by)
        assert list(args[13]) == list(kern.ints)
        assert args[14:18] == (int(kern.hazard), stage, 1, 0)
        assert args[18] == 7


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", K1_BODIES + HAZARD_BODIES[1:])
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
