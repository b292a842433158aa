"""Card-only tests of the port's kernels K2–K7 and of K1's margin mode.

This file imports neither JAX nor ``repro``, so it runs on a machine that
has a CUDA card and no JAX::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips.  Tolerances:

* K2 against its plain version evaluated in float64: ``|K2 − exact| ≤
  rel·Σ|aᵢbᵢ|`` with rel = 1e-5 (float32) / 1e-13 (float64) — the kernel
  sums in another order than ``torch.sum`` (about 50 roundings deep), and
  is deterministic (no atomics), so two runs give the same bits;
* K3/K4 against ``restrict_ref``/``prolong_ref``: bitwise (both round
  every operation on its own, in the same separable order), on
  :data:`SHAPES` and every level pair of the 512×512×128 hierarchy, K4
  also at forced tile depths, with random coarse Moat values, the same
  bits on two runs;
* a solve on the card against the same solve on the CPU, at ``tol =
  1e-5·‖T0‖``: the same outcome word, iteration counts within ±1 (the dots
  sum in different orders) and solutions within ``3.2·tol`` (each lies
  within ``1.6·tol`` of the exact one: the BTCS operator's smallest
  eigenvalue is ≥ 0.625);
* K6, K7 and K5's ``Ap`` against ``affine_stencil_ref`` /
  ``stencil_planes_ref`` / ``spmv_dot_ref``: bitwise (the same association,
  every operation rounded on its own), K7 on every coords of a 3×3 mesh
  and at forced tile depths too; K5's dot within ``1e-5·Σ|c·Ap|``
  (f32) / ``1e-13·Σ|c·Ap|`` (f64) of the plain version in float64, each
  of its per-tile partials within the same share of its tile's
  ``Σ|c·Ap|`` of ``spmv_dot_tiles_ref`` in float64, as many partials as
  ``spmv_launch_shape`` says, and the same bits on two runs;
* ``make_sharded_iteration`` cg and pipecg with K5 (and K2) on 1×1 and 2×2
  meshes against the plain iteration on the card, 5 iterations: within 4
  float32 ulp of the field per iteration, the recurrence scalars within
  1e-4 relative (``chip_smoke.py``'s bounds; the dots sum in other
  orders);
* every ``make_sharded_ftcs`` variant on the card, on 1×1 and 2×2 meshes:
  bitwise equal to the plain step on the CPU;
* K1's margin mode (resident inputs, ping-pong outputs) against
  ``fused_step_ref`` in margin mode: bitwise, margins of the output left
  alone; ``make`` on the resident layout equal to ``resident=False`` on the
  card, bitwise, for a hazard body;
* K1's k = 1 entry against ``fused_step_ref``, in the padded mode and the
  margin mode (M = h and h + 1), at float32 and float64: bitwise
  (``--fmad=false``), margins of the output left alone, one ``k1_launches``
  per launch, on :data:`K1_BODIES` and :data:`HAZARD_BODIES` (the hazard
  instantiation: two hazard updates, ``z0 > 0``, nz = 200 and 600);
* K1's sweep (the column entry k times) against ``fused_step_ref`` at
  k = 2, 3 and 8, both modes, float32 and float64, ragged bricks at the
  grid's corners, the same bodies: bitwise, one ``sweep_launches`` and k
  ``sweep_substeps`` per launch, one ``hazard_launches`` per launch of a
  hazard body; a second launch allocates nothing, nor does a step of a
  resident hazard ``make`` at the auto tile; ``make`` at the auto tile (all
  sweeps) equals ``time_tile=1``, resident and repacking, bitwise;
* K1 built for B = 1, 3 and 8 members on ``(B, …)`` stacks, k = 1, 2, 3
  and 8, both modes, float32 and float64, on the heat, halo-2 and hazard
  bodies: bitwise against its plain version and against B single
  launches, one ``batch_launches`` per launch; a batched ``make``
  (``RunOptions(batch=B)``, k = 1 and the auto tile, resident and
  repacking) bitwise equal to B single runs, its resident loops making no
  device allocation per step;
* K1 on sharded bricks (``wrap=False``, each brick's global origin as its
  coordinates) on every brick of 2×2 and 3×3 meshes, k = 1 and the sweep
  at k = 2, 3, 8, padded and margin mode, the heat and a hazard body, 1
  and 3 members, float32 and float64: bitwise against its plain version
  on zero-filled windows; ``make`` on a 2×2 mesh of the card bitwise equal
  to the single-device ``make`` (k = 1 and the auto tile, resident and
  repacking), K1 launched once per brick per engine launch through the
  route its tile names; a resident sharded step makes no device
  allocation; sharded solves (cg, pipecg with K2 per brick) within
  ``3.2·tol`` of the single-device solve on the card;
* numerical health and the adjoint: a guarded resident ``make``
  (``check_finite``) bitwise the unguarded one at k = 1 and 8, with the
  same K1 launches and the reference's probe count, and a mid-run overflow
  faulting with ``last_good`` bitwise the unguarded run at the last good
  probe; the differentiable runner's forward on K1 (no fallback), bitwise
  the repacking ``make``, its checkpointed gradient bitwise the
  all-residuals one; the symmetric adjoint (cg, pipecg) building no kernel
  across the backward, its float64 gradient within ``1e-8·max|g|`` of the
  CPU's (both solved to 1e-11: another dot order, the same tolerance);
* the service: four workers return one worker's bits, step results equal
  ``make``'s bitwise, and a served chunk (steps, wait, probe) makes no
  device allocation;
* the cost model: a calibration on the card tags its entry with the card's
  name, the calibrated ``make`` equals the uncalibrated one bitwise, and a
  ``cpu``-tagged entry steers no card plan;
* the LM serving path: every architecture's ``smoke()`` in float32 (TF32
  off) on the card against the CPU with the same weights — the forward's
  logits and a teacher-forced prefill + decode's — within
  ``1e-4·max|logit|`` (float32 products summed in other orders); ``serve``
  on the card returns in-vocabulary tokens on the card.

The bodies of :data:`K1_BODIES` are shared with ``test_torch_k1.py``, which
holds their plain version against the JAX reference on the CPU.
"""
import itertools

import numpy as np
import pytest
import torch

from conftest import heat_init
import repro_torch.core as port_core
from repro_torch.compiler import lower_group
from repro_torch.compiler.codegen import _field_specs, _wrap_pad
from repro_torch.engine import HaloLayout, RunOptions
from repro_torch.engine.layout import wrap_refresh
from repro_torch.kernels.fused import (build_fused_call, fused_entry,
                                       fused_step_ref, launch_fused)
from repro_torch.kernels import ops
from repro_torch.kernels import transfer as port_transfer
from repro_torch.kernels.dotprod import dual_dot_ref, launch_dual_dot
from repro_torch.core.explicit import make_sharded_ftcs
from repro_torch.core.mesh import device_get, make_mesh
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.implicit import make_sharded_iteration
from repro_torch.kernels.spmv import (launch_spmv_dot, spmv_dot_ref,
                                      spmv_dot_tiles_ref, spmv_launch_shape,
                                      tile_sums)
from repro_torch.kernels import stencil7 as port_stencil7
from repro_torch.kernels.stencil7 import (affine_stencil_ref,
                                          launch_stencil7,
                                          launch_stencil_planes,
                                          stencil_planes_ref)
from repro_torch.solver import record_btcs
from repro_torch.configs import ARCHS as LM_ARCHS

SHAPES = [(9, 9, 9), (17, 17, 5), (16, 12, 10), (8, 7, 6), (257, 129, 33)]
#: the fine shapes of the level pairs of the 512×512×128 hierarchy
LEVEL_PAIRS = [(512, 512, 128), (257, 257, 65), (129, 129, 33), (65, 65, 17),
               (33, 33, 9), (17, 17, 5)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_cuda_dual_dot_within_bound():
    """K2 within its bound of the float64 plain version, deterministic,
    aliased operands too (chip_smoke.py runs the same check at the main
    path's size)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        a, b, c = (torch.randn(37, 29, 1001, device="cuda", generator=g,
                               dtype=dtype) for _ in range(3))
        for ops4 in ((a, b, c, a), (a, a, b, a)):
            got = ops.dual_dot(*ops4)
            again = ops.dual_dot(*ops4)
            assert torch.equal(got, again)
            exact = dual_dot_ref(*(t.double() for t in ops4))
            scale = torch.stack([(ops4[0].double() * ops4[1]).abs().sum(),
                                 (ops4[2].double() * ops4[3]).abs().sum()])
            assert ((got.double() - exact).abs() <= rel * scale).all()


@pytest.mark.cuda
def test_cuda_transfers_bitwise_vs_plain():
    """K3 and K4 equal restrict_ref / prolong_ref bit for bit at float32 and
    float64 on odd, even and ragged level pairs (chip_smoke.py runs every
    level pair of the 512×512×128 hierarchy)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(4)
    for dtype in (torch.float32, torch.float64):
        for shape in SHAPES:
            fine = torch.randn(shape, device="cuda", generator=g, dtype=dtype)
            coarse = torch.randn(port_transfer.coarsen_shape(shape),
                                 device="cuda", generator=g, dtype=dtype)
            assert torch.equal(port_transfer.launch_restrict(fine),
                               port_transfer.restrict_ref(fine))
            assert torch.equal(port_transfer.launch_prolong(coarse, shape),
                               port_transfer.prolong_ref(coarse, shape))


@pytest.mark.cuda
def test_cuda_transfers_bitwise_on_every_level_pair():
    """K3 and K4 equal restrict_ref / prolong_ref bit for bit at float32 and
    float64 on every level pair of the 512×512×128 hierarchy, the same bits
    on two runs, one count a launch at the pair's fine shape."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    for dtype in (torch.float32, torch.float64):
        for shape in LEVEL_PAIRS:
            fine = torch.randn(shape, device="cuda", generator=g, dtype=dtype)
            coarse = torch.randn(port_transfer.coarsen_shape(shape),
                                 device="cuda", generator=g, dtype=dtype)
            before = port_transfer.launch_prolong.by_level.get(shape, 0)
            up, again = (port_transfer.launch_prolong(coarse, shape)
                         for _ in range(2))
            assert port_transfer.launch_prolong.by_level[shape] == before + 2
            assert torch.equal(up, port_transfer.prolong_ref(coarse, shape))
            assert torch.equal(up, again)
            down, again = (port_transfer.launch_restrict(fine) for _ in range(2))
            assert torch.equal(down, port_transfer.restrict_ref(fine))
            assert torch.equal(down, again)


@pytest.mark.cuda
@pytest.mark.parametrize("xc", [1, 2, 4, 8, 16])
def test_cuda_prolong_any_tile_depth(xc, monkeypatch):
    """K4 at a forced tile depth (ragged in x against it) equals prolong_ref
    bit for bit at float32 and float64 on every shape of SHAPES and every
    level pair: the march does not depend on k4_launch_shape's pick."""
    _need_card()
    own = port_transfer.k4_launch_shape

    def forced(nx, ny, nz):
        s = own(nx, ny, nz)
        return s._replace(grid=(s.grid[0], -(-(-(-nx // 2)) // xc), s.grid[2]),
                          xc=xc)

    monkeypatch.setattr(port_transfer, "k4_launch_shape", forced)
    g = torch.Generator(device="cuda").manual_seed(40 + xc)
    for dtype in (torch.float32, torch.float64):
        for shape in SHAPES + LEVEL_PAIRS:
            coarse = torch.randn(port_transfer.coarsen_shape(shape),
                                 device="cuda", generator=g, dtype=dtype)
            assert torch.equal(port_transfer.launch_prolong(coarse, shape),
                               port_transfer.prolong_ref(coarse, shape)), (
                                   shape, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("method,precondition", [
    ("cg", None), ("pipecg", None), ("cg", "mg"), ("bicgstab", "mg")])
def test_cuda_solve_matches_the_cpu(method, precondition):
    """solve(backend="pallas") on the card launches K2 (where the method
    has a fused dot pair) and K3/K4 (multigrid), and agrees with the same
    solve on the CPU."""
    _need_card()
    T0 = heat_init((33, 33, 17))
    tol = 1e-5 * float(np.linalg.norm(T0))   # Kelvin scale: f32 floors near 1e-7·‖b‖
    out = {}
    for device in ("cuda", "cpu"):
        before = (launch_dual_dot.launches, port_transfer.launch_restrict.launches)
        wse, T = record_btcs(T0, 0.1)
        out[device] = wse.solve(T, method=method, precondition=precondition,
                                tol=tol, return_info=True,
                                options=RunOptions(backend="pallas",
                                                   device=device))
        launched = (launch_dual_dot.launches - before[0],
                    port_transfer.launch_restrict.launches - before[1])
        fused_dots = method == "pipecg" or (method == "cg" and precondition)
        assert (launched[0] > 0) == (device == "cuda" and bool(fused_dots))
        assert (launched[1] > 0) == (device == "cuda" and bool(precondition))
    (x_card, i_card), (x_cpu, i_cpu) = out["cuda"], out["cpu"]
    assert list(i_card.outcomes) == list(i_cpu.outcomes) == ["CONVERGED"]
    assert abs(int(i_card.iterations[0]) - int(i_cpu.iterations[0])) <= 1
    assert np.abs(x_card.astype(np.float64) - x_cpu).max() <= 3.2 * tol


#: brick extents of the reference's kernel tests, and a ragged wide one
LEGACY_SHAPES = [(3, 7, 9), (6, 10, 5), (7, 130, 12), (33, 17, 129)]


@pytest.mark.cuda
def test_cuda_legacy_stencils_bitwise_vs_plain():
    """K6 and K7 equal their plain versions bit for bit at float32 and
    float64 (chip_smoke.py runs the main path's 512×512×128 bricks)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    for dtype in (torch.float32, torch.float64):
        for bx, by, nz in LEGACY_SHAPES:
            P = torch.randn(bx + 2, by + 2, nz, device="cuda", generator=g,
                            dtype=dtype)
            assert torch.equal(launch_stencil7(P, 0.4, 0.1),
                               affine_stencil_ref(P, 0.4, 0.1))
            T = torch.randn(bx, by, nz, device="cuda", generator=g, dtype=dtype)
            planes = [torch.randn(s, device="cuda", generator=g, dtype=dtype)
                      for s in ((1, by, nz), (1, by, nz), (bx, 1, nz), (bx, 1, nz))]
            for coords in ((0, 0), (0, 1), (1, 0), (1, 1)):
                args = (T, *planes, coords, 0.4, 0.1, 2 * bx, 2 * by)
                assert torch.equal(launch_stencil_planes(*args),
                                   stencil_planes_ref(*args))


#: K7's bricks: the reference's kernel test shapes, a ragged brick with
#: Z > 128, and the 2×2 and 1×1 meshes' bricks of 512×512×128
PLANES_SHAPES = [(3, 7, 9), (6, 10, 5), (7, 130, 12), (70, 37, 130),
                 (256, 256, 128), (512, 512, 128)]


def _planes_args(g, brick, coords, mesh, dtype):
    """A random brick, its four planes, ``coords`` and the global extent of
    a ``mesh`` of such bricks, as ``stencil_planes_ref`` takes them."""
    bx, by, nz = brick
    T = torch.randn(bx, by, nz, device="cuda", generator=g, dtype=dtype)
    planes = [torch.randn(s, device="cuda", generator=g, dtype=dtype)
              for s in ((1, by, nz), (1, by, nz), (bx, 1, nz), (bx, 1, nz))]
    return (T, *planes, coords, 0.4, 0.1, mesh[0] * bx, mesh[1] * by)


@pytest.mark.cuda
@pytest.mark.parametrize("brick", PLANES_SHAPES)
def test_cuda_stencil_planes_bitwise_on_a_3x3_mesh(brick):
    """K7 equals stencil_planes_ref bit for bit at float32 and float64 on
    every coords of a 3×3 mesh (every combination of Moat face and plane),
    the same bits on two runs, one launch each."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(8 + sum(brick))
    for dtype in (torch.float32, torch.float64):
        for coords in itertools.product(range(3), range(3)):
            args = _planes_args(g, brick, coords, (3, 3), dtype)
            before = launch_stencil_planes.launches
            got, again = launch_stencil_planes(*args), launch_stencil_planes(*args)
            assert launch_stencil_planes.launches - before == 2
            assert torch.equal(got, stencil_planes_ref(*args)), (coords, dtype)
            assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("xc", [1, 2, 3, 5, 32])
def test_cuda_stencil_planes_any_tile_depth(xc, monkeypatch):
    """K7 at a forced tile depth (ragged in x against it) equals
    stencil_planes_ref bit for bit: the march's pipeline does not depend
    on k7_launch_shape's pick."""
    _need_card()
    own = port_stencil7.k7_launch_shape

    def forced(bx, by, nz):
        s = own(bx, by, nz)
        return s._replace(grid=(s.grid[0], -(-bx // xc), s.grid[2]), xc=xc)

    monkeypatch.setattr(port_stencil7, "k7_launch_shape", forced)
    g = torch.Generator(device="cuda").manual_seed(xc)
    for brick in ((70, 37, 130), (33, 17, 129), (7, 130, 12)):
        for coords in ((0, 0), (1, 1), (2, 2)):
            args = _planes_args(g, brick, coords, (3, 3), torch.float32)
            assert torch.equal(launch_stencil_planes(*args),
                               stencil_planes_ref(*args)), (brick, coords)


#: K5's bricks: the K6/K7 shapes, a ragged brick with Z > 128, and the
#: 2×2 and 1×1 meshes' bricks of 512×512×128
SPMV_SHAPES = LEGACY_SHAPES + [(70, 37, 130), (256, 256, 128), (512, 512, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("brick", SPMV_SHAPES)
def test_cuda_spmv_dot_vs_plain(brick):
    """K5's Ap bitwise; its dot and each per-tile partial within their
    bounds of the float64 plain version; one partial per tile of
    spmv_launch_shape; the same bits on two runs."""
    _need_card()
    bx, by, nz = brick
    g = torch.Generator(device="cuda").manual_seed(6 + sum(brick))
    for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        P = torch.randn(bx + 2, by + 2, nz, device="cuda", generator=g,
                        dtype=dtype)
        av, dot = ops.spmv_hex_dot(P, 1.0, -0.0625)
        av2, dot2 = ops.spmv_hex_dot(P, 1.0, -0.0625)
        want, _ = spmv_dot_ref(P, 1.0, -0.0625)
        assert torch.equal(av, want) and torch.equal(av2, av)
        assert torch.equal(dot, dot2)
        prod = P[1:-1, 1:-1].double() * av.double()
        assert abs(float(dot) - float(prod.sum())) <= rel * float(prod.abs().sum())
        _, parts = launch_spmv_dot(P, 1.0, -0.0625)
        shape = spmv_launch_shape(bx, by, nz)
        assert parts.dtype == dtype and parts.shape == (shape.partials,)
        exact = spmv_dot_tiles_ref(P, 1.0, -0.0625, dtype=torch.float64)
        scale = tile_sums(prod.abs(), shape)
        assert bool(((parts.double() - exact).abs() <= rel * scale).all())


def _iteration_state(method, x0, w=0.1):
    """A seeded make_sharded_iteration state in float64, rounded to
    float32: the start of the method on ``A x = b``, ``b = rhs(x0)``."""
    wpsi = w / (1.0 + 6.0 * w)

    def A(x):
        Ax = x.copy()
        c = (slice(1, -1),) * 3
        s = 0.0
        for ax in range(3):
            lo, hi = list(c), list(c)
            lo[ax], hi[ax] = slice(0, -2), slice(2, None)
            s = s + x[tuple(lo)] + x[tuple(hi)]
        Ax[c] = x[c] - wpsi * s
        return Ax

    x = x0.astype(np.float64)
    b = x.copy()
    b[1:-1, 1:-1, 1:-1] *= 1.0 / (1.0 + 6.0 * w)
    r = b - A(x)
    f32 = lambda *a: tuple(np.asarray(v, np.float32) for v in a)  # noqa: E731
    if method == "cg":
        return f32(x, r, r, (r * r).sum())
    z = np.zeros_like(x)
    return f32(x, r, A(r), z, z, z, 1e30, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
@pytest.mark.parametrize("method", ["cg", "pipecg"])
def test_cuda_legacy_iteration_kernel_vs_plain(method, mesh_shape):
    """cg and pipecg through K5 (and K2) equal the plain iteration on the
    card within chip_smoke.py's bounds, one K5 per brick per iteration."""
    _need_card()
    n = 5
    x0 = np.random.default_rng(9).uniform(300.0, 500.0, (64, 48, 130))
    state = _iteration_state(method, x0)
    ulp = float(np.spacing(np.float32(np.abs(x0).max())))
    mesh = make_mesh(mesh_shape, ("data", "model"))
    runs = {}
    for use_kernel in (False, True):
        step, specs = make_sharded_iteration(mesh, x0.shape, 0.1, method=method,
                                             use_kernel=use_kernel)
        s = state_from_numpy(state, specs[0].sharding)
        before = launch_spmv_dot.launches
        for _ in range(n):
            s = step(s)
        runs[use_kernel] = state_to_numpy(s)
        assert launch_spmv_dot.launches - before == (n * mesh.size if use_kernel
                                                      else 0)
    for got, want in zip(runs[True], runs[False]):
        if got.ndim:
            assert np.abs(got - want).max() <= 4 * n * ulp
        else:
            assert abs(float(got) / float(want) - 1.0) <= 1e-4


@pytest.mark.cuda
def test_cuda_sharded_ftcs_bitwise_vs_cpu():
    """Every make_sharded_ftcs variant on the card (K6 and K7 on the kernel
    variants), on 1×1 and 2×2 meshes, equals the plain step on the CPU,
    with a launch per brick per step."""
    _need_card()
    rng = np.random.default_rng(7)
    G = rng.uniform(300.0, 500.0, (34, 20, 11)).astype(np.float32)
    variants = [({}, 6), (dict(overlap=True), 6), (dict(halo_depth=3), 2),
                (dict(use_kernel=True), 6), (dict(use_kernel="planes"), 6)]
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    want = device_get(make_sharded_ftcs(mesh, G.shape, 0.1, steps_per_call=6)[0](G))
    for shape in ((1, 1), (2, 2)):
        mesh = make_mesh(shape, ("data", "model"))
        for kw, calls in variants:
            before = (launch_stencil7.launches, launch_stencil_planes.launches)
            step, _ = make_sharded_ftcs(mesh, G.shape, 0.1, steps_per_call=calls,
                                        **kw)
            got = device_get(step(G))
            assert np.array_equal(got, want), (shape, kw)
            launched = (launch_stencil7.launches - before[0],
                        launch_stencil_planes.launches - before[1])
            bricks = shape[0] * shape[1]
            assert launched == ((6 * bricks, 0) if kw.get("use_kernel") is True
                                else (0, 6 * bricks) if kw.get("use_kernel")
                                else (0, 0)), (shape, kw, launched)


def _hazard_body(A0, C0, B0, steps):
    """A multi-field, off-axis, multi-update body: a 2-tap coefficient
    product, B reading A's new value at dz = ±1, and A re-written from its
    own new value at dz = -1 (the kernel's hazard path)."""
    wse = port_core.WSE_Interface()
    A = port_core.WSE_Array("A", init_data=A0, dtype=A0.dtype)
    C = port_core.WSE_Array("C", init_data=C0, dtype=C0.dtype)
    B = port_core.WSE_Array("B", init_data=B0, dtype=B0.dtype)
    with port_core.WSE_For_Loop("t", steps):
        A[1:-1, 0, 0] = A[1:-1, 0, 0] + 0.05 * (
            A[2:, 0, 0] + A[:-2, 0, 0] + A[1:-1, 1, 0] + A[1:-1, -1, 0]
            - 4.0 * A[1:-1, 0, 0]) + C[1:-1, 0, 0] * (
            A[1:-1, 1, 1] + A[1:-1, -1, -1] - 2.0 * A[1:-1, 0, 0])
        B[1:-1, 0, 0] = 0.5 * B[1:-1, 0, 0] + 0.25 * (
            A[2:, 0, 0] + A[:-2, 0, 0]) + 0.125
        A[2:-1, 0, 0] = A[2:-1, 0, 0] - 0.01 * A[1:-2, 0, 0]
    return wse, A


@pytest.mark.cuda
def test_cuda_fused_margin_mode_bitwise_vs_plain():
    """K1 in margin mode equals fused_step_ref in margin mode bit for bit,
    at float32 and float64, k = 1 and 2, M = k·h and k·h + 1, writes only
    the brick interiors of its outputs, and equals the padded mode's
    outputs there, on a hazard body (chip_smoke.py runs the heat body and
    the hazard body at full width)."""
    _need_card()
    rng = np.random.default_rng(8)
    for dtype in (np.float32, np.float64):
        A0, C0, B0 = (rng.uniform(0.0, 1.0, (37, 29, 11)).astype(dtype)
                      for _ in range(3))
        wse, _ = _hazard_body(A0, C0, B0, 4)
        prog = wse.program
        wse.__exit__()
        group = lower_group(prog.ops)
        specs, (nx, ny) = _field_specs(
            group, {n: f.shape for n, f in prog.fields.items()},
            {n: f.dtype for n, f in prog.fields.items()})
        env = {n: torch.tensor(f.init_data, device="cuda")
               for n, f in prog.fields.items()}
        for k in (1, 2):
            padded, _ = build_fused_call(group.updates, specs, group.halo, nx,
                                         ny, nx, ny, time_tile=k, wrap=True,
                                         device="cuda")
            want = launch_fused(padded, [_wrap_pad(env[n], padded.pad)
                                         for n in padded.in_names])
            for M in (k * group.halo, k * group.halo + 1):
                kern, _ = build_fused_call(group.updates, specs, group.halo,
                                           nx, ny, nx, ny, time_tile=k,
                                           wrap=True, device="cuda", margin=M)
                assert kern.hazard
                lay = HaloLayout(pad=M, shapes={})
                ins = [wrap_refresh(lay.enter({n: env[n]})[n], M, kern.pad)
                       for n in kern.in_names]
                outs = {}
                before = launch_fused.hazard_launches
                for how in ("kernel", "plain"):
                    out = [torch.full_like(ins[kern.in_names.index(n)], -7.0)
                           for n in kern.written]
                    call = launch_fused if how == "kernel" else fused_step_ref
                    outs[how] = call(kern, ins, out=out)
                assert launch_fused.hazard_launches == before + 1
                for g, p, w in zip(outs["kernel"], outs["plain"], want):
                    assert torch.equal(g, p), (dtype, k, M)
                    assert torch.equal(g[M:-M, M:-M], w)
                with pytest.raises(ValueError, match="shares storage"):
                    launch_fused(kern, ins, out=[ins[0], outs["plain"][1]])


@pytest.mark.cuda
def test_cuda_resident_make_equals_repack_make():
    """make(backend="pallas") of a hazard body on the card: the resident
    layout (margin-mode launches only) equals the repacking step bitwise,
    with a remainder; every launch a hazard launch."""
    _need_card()
    rng = np.random.default_rng(9)
    A0, C0, B0 = (rng.uniform(0.0, 1.0, (37, 29, 11)).astype(np.float32)
                  for _ in range(3))
    out = {}
    for resident in (True, False):
        before = (launch_fused.launches, launch_fused.margin_launches,
                  launch_fused.hazard_launches)
        wse, A = _hazard_body(A0, C0, B0, 5)
        out[resident] = wse.make(answer=A, options=RunOptions(
            backend="pallas", time_tile=2, resident=resident))
        launched = (launch_fused.launches - before[0],
                    launch_fused.margin_launches - before[1],
                    launch_fused.hazard_launches - before[2])
        assert launched == ((3, 3, 3) if resident else (3, 0, 3))
    np.testing.assert_array_equal(out[True], out[False])


#: bodies the k = 1 entry serves: heat; advection–diffusion with off-axis
#: taps and a second update reading the first's new value at dz = ±1 (not a
#: hazard); halo 2 with fields of different nz; one field with nz = 200 >
#: BZ; a 3×3×2 brick, the shape of a coarse multigrid level; and the
#: coupled body with a hazard (A re-written from its own new value at
#: dz = -1)
K1_BODIES = ("heat", "advdiff_dz", "wide_halo2_mixed_nz", "nz200",
             "coarse_3x3x2", "hazard")
#: more hazard bodies: two hazard updates in one body, the second with
#: z0 = 4 and zlen = nz - 7; and a heat update followed by a hazard one at
#: nz = 200 and 600 (at 600 a column's z walk takes two passes of its
#: 4·BZ = 512 cells, so the stage spans both)
HAZARD_BODIES = ("hazard", "hazard_two_updates", "hazard_nz200",
                 "hazard_nz600")


def k1_body(m, name, dtype, steps=2, seed=0):
    """``(wse, env)``: body ``name`` recorded into ``m`` (``repro.core`` or
    ``repro_torch.core``) over seeded NumPy fields ``env``."""
    rng = np.random.default_rng(seed)
    wse = m.WSE_Interface()
    if name in ("heat", "nz200", "coarse_3x3x2"):
        shape = {"heat": (10, 12, 14), "nz200": (9, 7, 200),
                 "coarse_3x3x2": (3, 3, 2)}[name]
        env = {"T": rng.uniform(300.0, 500.0, shape).astype(dtype)}
        T = m.WSE_Array("T", init_data=env["T"], dtype=env["T"].dtype)
        with m.WSE_For_Loop("t", steps):
            T[1:-1, 0, 0] = 0.4 * T[1:-1, 0, 0] + 0.1 * (
                T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0] + T[1:-1, 0, -1]
                + T[1:-1, -1, 0] + T[1:-1, 0, 1])
    elif name in ("hazard", "hazard_two_updates"):
        nz = 9 if name == "hazard" else 16
        env = {n: rng.uniform(0.0, hi, (13, 11, nz)).astype(dtype)
               for n, hi in (("A", 1.0), ("C", 0.05), ("B", 1.0))}
        A, C, B = (m.WSE_Array(n, init_data=env[n], dtype=env[n].dtype)
                   for n in ("A", "C", "B"))
        with m.WSE_For_Loop("t", steps):
            A[1:-1, 0, 0] = A[1:-1, 0, 0] + 0.05 * (
                A[2:, 0, 0] + A[:-2, 0, 0] + A[1:-1, 1, 0] + A[1:-1, -1, 0]
                - 4.0 * A[1:-1, 0, 0]) + C[1:-1, 0, 0] * (
                A[1:-1, 1, 1] + A[1:-1, -1, -1] - 2.0 * A[1:-1, 0, 0])
            B[1:-1, 0, 0] = 0.5 * B[1:-1, 0, 0] + 0.25 * (
                A[2:, 0, 0] + A[:-2, 0, 0]) + 0.125
            A[2:-1, 0, 0] = A[2:-1, 0, 0] - 0.01 * A[1:-2, 0, 0]
            if name == "hazard_two_updates":
                A[4:-3, 0, 0] = A[4:-3, 0, 0] + 0.02 * A[5:-2, 0, 0]
    elif name in ("hazard_nz200", "hazard_nz600"):
        shape = (9, 7, 200) if name == "hazard_nz200" else (6, 5, 600)
        env = {"T": rng.uniform(300.0, 500.0, shape).astype(dtype)}
        T = m.WSE_Array("T", init_data=env["T"], dtype=env["T"].dtype)
        with m.WSE_For_Loop("t", steps):
            T[1:-1, 0, 0] = 0.4 * T[1:-1, 0, 0] + 0.1 * (
                T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0] + T[1:-1, 0, -1]
                + T[1:-1, -1, 0] + T[1:-1, 0, 1])
            T[2:-1, 0, 0] = T[2:-1, 0, 0] - 0.01 * T[1:-2, 0, 0]
    elif name == "advdiff_dz":
        env = {n: rng.uniform(0.0, hi, (13, 11, 9)).astype(dtype)
               for n, hi in (("A", 1.0), ("C", 0.05), ("B", 1.0))}
        A, C, B = (m.WSE_Array(n, init_data=env[n], dtype=env[n].dtype)
                   for n in ("A", "C", "B"))
        with m.WSE_For_Loop("t", steps):
            A[1:-1, 0, 0] = A[1:-1, 0, 0] + 0.05 * (
                A[2:, 0, 0] + A[:-2, 0, 0] + A[1:-1, 1, 0] + A[1:-1, -1, 0]
                - 4.0 * A[1:-1, 0, 0]) - 0.1 * (
                A[1:-1, 0, 0] - A[1:-1, -1, 0]) + C[1:-1, 0, 0] * (
                A[1:-1, 1, 1] + A[1:-1, -1, -1] - 2.0 * A[1:-1, 0, 0])
            B[1:-1, 0, 0] = 0.5 * B[1:-1, 0, 0] + 0.25 * (
                A[2:, 0, 0] + A[:-2, 0, 0]) + 0.125
    elif name == "wide_halo2_mixed_nz":
        env = {"P": rng.uniform(0.0, 1.0, (20, 23, 9)).astype(dtype),
               "Q": rng.uniform(0.0, 0.1, (20, 23, 7)).astype(dtype),
               "R": rng.uniform(0.0, 1.0, (20, 23, 6)).astype(dtype)}
        P, Q, R = (m.WSE_Array(n, init_data=env[n], dtype=env[n].dtype)
                   for n in ("P", "Q", "R"))
        with m.WSE_For_Loop("t", steps):
            P[1:-1, 0, 0] = 0.3 * P[1:-1, 0, 0] + 0.2 * (
                P[1:-1, 2, 0] + P[1:-1, -2, 1]) + Q[:, 0, 0] * Q[:, 1, -2]
            Q[2:5, 0, 0] = 0.0 * Q[2:5, 0, 0] + 1.5
            R[1:-1, 0, 0] = 0.5 * R[2:, 0, 0] + 0.5 * R[:-2, 0, 0]
    else:
        raise KeyError(name)
    return wse, env


def k1_kernel(name, dtype, device, margin=0, k=1, brick=None, batch=1,
              wrap=True, grid=None, region=None):
    """``(kernel, env)`` of body ``name`` at time tile ``k`` on ``device``,
    for the whole grid or a ``brick=(bx, by)`` of it, built for ``batch``
    members (``wrap=False``: a sharded brick's kernel), windowed to
    ``region``; ``grid=(nx, ny)`` replaces the body's (X, Y) extent (``env``
    keeps the recorded shapes)."""
    wse, env = k1_body(port_core, name, dtype)
    prog = wse.program
    wse.__exit__()
    group = lower_group(prog.ops)
    specs, (nx, ny) = _field_specs(
        group, {n: (*(grid or f.shape[:2]), f.shape[2])
                for n, f in prog.fields.items()},
        {n: f.dtype for n, f in prog.fields.items()})
    bx, by = brick or (nx, ny)
    kern, _ = build_fused_call(group.updates, specs, group.halo, bx, by, nx,
                               ny, time_tile=k, wrap=wrap, device=device,
                               margin=margin, batch=batch, region=region)
    return kern, env


def brick_window(field, coords, bx, by, pad):
    """The ``(bx + 2·pad, by + 2·pad)`` window around the brick at
    ``coords`` of the global ``field``, wrapped periodically to any depth:
    a padded-mode input (``pad = k·h``) or a refreshed resident buffer
    (``pad = M``)."""
    nx, ny = field.shape[:2]
    xs = np.arange(coords[0] - pad, coords[0] + bx + pad) % nx
    ys = np.arange(coords[1] - pad, coords[1] + by + pad) % ny
    return np.ascontiguousarray(field[xs][:, ys])


@pytest.mark.cuda
@pytest.mark.parametrize("name", K1_BODIES + HAZARD_BODIES[1:])
def test_cuda_k1_entry_bitwise_vs_plain(name):
    """K1's k = 1 entry equals fused_step_ref bit for bit in the padded mode
    and in the margin mode (M = h and h + 1, output margins untouched), at
    float32 and float64, and counts one k1 launch per launch (and one
    hazard launch for a hazard body)."""
    _need_card()
    for dtype in (np.float32, np.float64):
        kern, env = k1_kernel(name, dtype, "cuda")
        assert fused_entry(kern) == "k1"
        padded = [_wrap_pad(torch.tensor(env[n], device="cuda"), kern.pad)
                  for n in kern.in_names]
        before = launch_fused.k1_launches
        hazards = launch_fused.hazard_launches
        got = launch_fused(kern, padded)
        assert launch_fused.k1_launches == before + 1
        assert launch_fused.hazard_launches == hazards + kern.hazard
        want = fused_step_ref(kern, padded)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (name, dtype)
        for M in (kern.halo, kern.halo + 1):
            km, _ = k1_kernel(name, dtype, "cuda", margin=M)
            lay = HaloLayout(pad=M, shapes={})
            ins = [wrap_refresh(lay.enter({n: torch.tensor(
                env[n], device="cuda")})[n], M, km.pad) for n in km.in_names]
            outs = {}
            for how in ("kernel", "plain"):
                out = [torch.full_like(ins[km.in_names.index(n)], -7.0)
                       for n in km.written]
                call = launch_fused if how == "kernel" else fused_step_ref
                outs[how] = call(km, ins, out=out)
            assert launch_fused.k1_launches == before + 1 + (M - kern.halo + 1)
            for g, p, w in zip(outs["kernel"], outs["plain"], want):
                assert torch.equal(g, p), (name, dtype, M)
                assert torch.equal(g[M:-M, M:-M], w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", K1_BODIES + HAZARD_BODIES[1:])
def test_cuda_sweep_entry_bitwise_vs_plain(name):
    """K1's sweep equals fused_step_ref bit for bit at k = 2, 3 and 8, in
    the padded mode and the margin mode (M = k·h and k·h + 1, output
    margins untouched), at float32 and float64, for bricks of about half
    the grid at its low and high corners (regions wrap past both edges),
    hazard bodies through the hazard instantiation."""
    _need_card()
    for dtype in (np.float32, np.float64):
        whole, env = k1_kernel(name, dtype, "cpu")
        nx, ny, h = whole.nx, whole.ny, whole.halo
        bx, by = nx // 2 + 1, ny // 2 + 1
        for k in (2, 3, 8):
            for M in (0, k * h, k * h + 1):
                kern, _ = k1_kernel(name, dtype, "cuda", margin=M, k=k,
                                    brick=(bx, by))
                assert fused_entry(kern) == "sweep"
                for coords in ((0, 0), (nx - bx, ny - by)):
                    ins = [torch.tensor(brick_window(env[n], coords, bx, by,
                                                     M or kern.pad),
                                        device="cuda")
                           for n in kern.in_names]
                    outs = {}
                    for how in ("kernel", "plain"):
                        out = ([torch.full_like(ins[kern.in_names.index(n)],
                                                -7.0)
                                for n in kern.written] if M else None)
                        before = (launch_fused.sweep_launches,
                                  launch_fused.sweep_substeps,
                                  launch_fused.hazard_launches)
                        call = launch_fused if how == "kernel" else fused_step_ref
                        outs[how] = call(kern, ins, coords, out=out)
                        assert (launch_fused.sweep_launches - before[0],
                                launch_fused.sweep_substeps - before[1],
                                launch_fused.hazard_launches - before[2]) == (
                                    (1, k, int(kern.hazard)) if how == "kernel"
                                    else (0, 0, 0))
                    for g, w in zip(outs["kernel"], outs["plain"]):
                        assert torch.equal(g, w), (name, dtype, k, M, coords)


@pytest.mark.cuda
def test_cuda_sweep_second_launch_allocates_nothing():
    """The sweep's scratch is allocated at the kernel's first launch and
    held: a second margin-mode launch makes no device allocation."""
    _need_card()
    kern, env = k1_kernel("heat", np.float32, "cuda", margin=8, k=8)
    lay = HaloLayout(pad=8, shapes={})
    ins = [wrap_refresh(lay.enter({"T": torch.tensor(env["T"], device="cuda")}
                                  )["T"], 8, kern.pad)]
    out = [torch.full_like(ins[0], -7.0)]
    first = launch_fused(kern, ins, out=out)[0].clone()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    again = launch_fused(kern, ins, out=out)[0]
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocated
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_cuda_make_auto_tile_equals_k1():
    """make(backend="pallas") with time_tile=None picks k = 8 here and runs
    every launch through the sweep; it equals time_tile=1 bit for bit, on
    the resident layout and repacking."""
    _need_card()
    T0 = np.random.default_rng(10).uniform(300.0, 500.0,
                                           (40, 36, 12)).astype(np.float32)
    out = {}
    for tt in (None, 1):
        for resident in (True, False):
            before = (launch_fused.launches, launch_fused.sweep_launches,
                      launch_fused.sweep_substeps)
            wse = port_core.WSE_Interface()
            T = port_core.WSE_Array("T", init_data=T0, dtype=T0.dtype)
            with port_core.WSE_For_Loop("t", 16):
                T[1:-1, 0, 0] = 0.4 * T[1:-1, 0, 0] + 0.1 * (
                    T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0]
                    + T[1:-1, 0, -1] + T[1:-1, -1, 0] + T[1:-1, 0, 1])
            out[tt, resident] = wse.make(answer=T, options=RunOptions(
                backend="pallas", time_tile=tt, resident=resident))
            launched = (launch_fused.launches - before[0],
                        launch_fused.sweep_launches - before[1],
                        launch_fused.sweep_substeps - before[2])
            assert launched == ((2, 2, 16) if tt is None else (16, 0, 0))
    for key, got in out.items():
        np.testing.assert_array_equal(got, out[1, True], err_msg=str(key))


@pytest.mark.cuda
def test_cuda_resident_hazard_make_allocates_nothing_per_step():
    """A resident make of a hazard body at the auto tile: every launch a
    hazard sweep, and no device allocation per step — a run's growth of
    ``allocation.all.allocated`` (after a warm-up run, which allocates the
    kernel's scratch) is the same over 16 steps as over 8 (what a run
    allocates once, the layout's enter and exit and its spares, cancels)."""
    _need_card()
    from repro_torch.convert import env_from_numpy
    from repro_torch.engine import plan, single_runner

    rng = np.random.default_rng(11)
    A0, C0, B0 = (rng.uniform(0.0, 1.0, (40, 36, 12)).astype(np.float32)
                  for _ in range(3))
    grown = {}
    for steps in (8, 16):
        wse, _ = _hazard_body(A0, C0, B0, steps)
        p = plan(wse.program, RunOptions(backend="pallas", time_tile=None))
        wse.__exit__()
        run = single_runner(p)
        env = env_from_numpy({"A": A0, "C": C0, "B": B0}, "cuda")
        run(env)
        torch.cuda.synchronize()
        before = (torch.cuda.memory_stats()["allocation.all.allocated"],
                  launch_fused.launches, launch_fused.sweep_launches,
                  launch_fused.hazard_launches)
        run(env)
        torch.cuda.synchronize()
        after = (torch.cuda.memory_stats()["allocation.all.allocated"],
                 launch_fused.launches, launch_fused.sweep_launches,
                 launch_fused.hazard_launches)
        launched = after[1] - before[1]
        assert launched > 0
        assert after[2] - before[2] == after[3] - before[3] == launched
        grown[steps] = after[0] - before[0]
    assert grown[16] == grown[8], grown


def _member_inputs(name, dtype, B, kern, coords, pad):
    """Per-member input lists of body ``name`` from seeds 0..B-1: the
    window of ``kern``'s brick at ``coords``, ``pad`` deep, on the card."""
    per = []
    for seed in range(B):
        wse, env = k1_body(port_core, name, dtype, seed=seed)
        wse.__exit__()
        per.append([torch.tensor(brick_window(env[n], coords, kern.bx,
                                              kern.by, pad), device="cuda")
                    for n in kern.in_names])
    return per


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("name", ["heat", "wide_halo2_mixed_nz", "hazard"])
def test_cuda_batched_k1_bitwise_vs_plain_and_singles(name, B):
    """K1 built for B members, on (B, …) stacks (B = 1: the single kernel on
    one member), equals its plain version and B single launches bit for
    bit: k = 1 (the brick at the grid's high corner) and the sweep at k =
    2, 3, 8, padded and margin mode (M = k·h + 1, output margins left as
    they were), float32 and float64; one batch launch per launch."""
    _need_card()
    for dtype in (np.float32, np.float64):
        whole, _ = k1_kernel(name, dtype, "cpu")
        nx, ny, h = whole.nx, whole.ny, whole.halo
        bx, by = nx // 2 + 1, ny // 2 + 1
        coords = (nx - bx, ny - by)
        for k in (1, 2, 3, 8):
            for M in (0, k * h + 1):
                single, _ = k1_kernel(name, dtype, "cuda", margin=M, k=k,
                                      brick=(bx, by))
                kern, _ = k1_kernel(name, dtype, "cuda", margin=M, k=k,
                                    brick=(bx, by), batch=B)
                per = _member_inputs(name, dtype, B, kern, coords,
                                     M or kern.pad)
                ins = ([torch.stack(ts) for ts in zip(*per)] if B > 1
                       else per[0])

                def outs(xs):
                    return ([torch.full_like(xs[kern.in_names.index(n)], -7.0)
                             for n in kern.written] if M else None)

                before = (launch_fused.launches, launch_fused.batch_launches)
                got = launch_fused(kern, ins, coords, out=outs(ins))
                assert (launch_fused.launches - before[0],
                        launch_fused.batch_launches - before[1]) == (1, B > 1)
                plain = fused_step_ref(kern, ins, coords, out=outs(ins))
                for g, p in zip(got, plain):
                    assert torch.equal(g, p), (name, dtype, B, k, M)
                for b, xs in enumerate(per):
                    one = launch_fused(single, xs, coords, out=outs(xs))
                    for g, w in zip(got, one):
                        assert torch.equal(g[b] if B > 1 else g, w), (
                            name, dtype, B, k, M, b)


@pytest.mark.cuda
@pytest.mark.parametrize("time_tile", [1, None])
def test_cuda_batched_make_equals_single_runs(time_tile):
    """make of a 3-member ensemble (RunOptions(batch=3)) on the card, resident
    and repacking: bitwise each member's single run, every K1 launch a
    batch launch; the resident loop allocates nothing per step (a run's
    allocation growth, after a warm-up run, is the same over 16 steps as
    over 8)."""
    _need_card()
    from repro_torch.convert import env_from_numpy
    from repro_torch.core.ensemble import Ensemble
    from repro_torch.engine import plan, single_runner

    rng = np.random.default_rng(12)
    inits = [rng.uniform(300.0, 500.0, (40, 36, 12)).astype(np.float32)
             for _ in range(3)]

    def member(T0, steps):
        with port_core.WSE_Interface() as wse:
            T = port_core.WSE_Array("T", init_data=T0, dtype=T0.dtype)
            with port_core.WSE_For_Loop("t", steps):
                T[1:-1, 0, 0] = 0.4 * T[1:-1, 0, 0] + 0.1 * (
                    T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0]
                    + T[1:-1, 0, -1] + T[1:-1, -1, 0] + T[1:-1, 0, 1])
        return wse, T

    for resident in (True, False):
        opts = RunOptions(backend="pallas", time_tile=time_tile,
                          resident=resident)
        before = (launch_fused.launches, launch_fused.batch_launches)
        out = Ensemble.from_programs([member(T0, 16) for T0 in inits]).make(
            options=opts)
        launched = launch_fused.launches - before[0]
        assert launched == (16 if time_tile == 1 else 2)
        assert launch_fused.batch_launches - before[1] == launched
        for b, T0 in enumerate(inits):
            wse, T = member(T0, 16)
            np.testing.assert_array_equal(out[b], wse.make(answer=T,
                                                           options=opts))
    grown = {}
    for steps in (8, 16):
        wse, _ = member(inits[0], steps)
        p = plan(wse.program, RunOptions(backend="pallas", time_tile=time_tile,
                                         batch=3))
        wse.__exit__()
        run = single_runner(p)
        env = env_from_numpy({"T": np.stack(inits)}, "cuda")
        run(env)
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        run(env)
        torch.cuda.synchronize()
        grown[steps] = torch.cuda.memory_stats()["allocation.all.allocated"] - a0
    assert grown[16] == grown[8], grown


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "pipecg", "bicgstab"])
def test_cuda_batched_solve_matches_single_solves(method):
    """A 3-member masked solve on the card (BTCS with per-member guesses):
    every member CONVERGED, within 10·tol of its own single solve on the
    card, the operator one batch launch per application."""
    _need_card()
    from repro_torch.solver import btcs_program, solve

    shape = (33, 33, 17)
    T0 = heat_init(shape)
    tol = 1e-5 * float(np.linalg.norm(T0))
    rng = np.random.default_rng(13)
    x0s = np.stack([T0 + rng.uniform(-50.0, 50.0, shape).astype(np.float32)
                    for _ in range(3)])
    prog = btcs_program(shape, 0.1, init_data=T0)
    before = launch_fused.batch_launches
    x, info = solve(prog, "T", method=method, tol=tol,
                    options=RunOptions(batch=3), member_env={"T": x0s},
                    return_info=True)
    assert launch_fused.batch_launches > before
    assert list(info.outcomes[0]) == ["CONVERGED"] * 3
    for b in range(3):
        xs = solve(prog, "T", method=method, tol=tol,
                   member_env={"T": x0s[b]})
        assert np.abs(x[b].astype(np.float64) - xs).max() <= 10 * tol


# -- sharded bricks (slice 12) -------------------------------------------------

def zero_window(field, coords, bx, by, pad):
    """The ``(…, bx + 2·pad, by + 2·pad)`` window around the brick at
    ``coords`` of the global ``field`` (leading member axes whole), zero
    outside the domain: what a sharded brick's halo exchange gives it."""
    lead = field.shape[:-3]
    z = np.zeros((*lead, field.shape[-3] + 2 * pad,
                  field.shape[-2] + 2 * pad, field.shape[-1]), field.dtype)
    z[..., pad:pad + field.shape[-3], pad:pad + field.shape[-2], :] = field
    return np.ascontiguousarray(z[..., coords[0]:coords[0] + bx + 2 * pad,
                                  coords[1]:coords[1] + by + 2 * pad, :])


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(2, 2), (3, 3)])
@pytest.mark.parametrize("name", ["heat", "hazard"])
def test_cuda_sharded_k1_bitwise_vs_plain(name, mesh_shape):
    """K1 built without wrap for the bricks of a mesh equals its plain
    version bit for bit on every brick (coords = the brick's global
    origin; the sweep's regions reach below 0 and past the grid on edge
    bricks, where both must mask rather than wrap): k = 1 and the sweep at
    k = 2, 3, 8, padded and margin mode (M = k·h + 1, output margins left
    alone), 1 and 3 members, float32 and float64."""
    _need_card()
    mx, my = mesh_shape
    for dtype in (np.float32, np.float64):
        whole, _ = k1_kernel(name, dtype, "cpu")
        bx, by = whole.nx // mx, whole.ny // my
        for k, M, B in itertools.product((1, 2, 3, 8), (0, None), (1, 3)):
            M = 0 if M == 0 else k * whole.halo + 1
            kern, _ = k1_kernel(name, dtype, "cuda", margin=M, k=k,
                                brick=(bx, by), batch=B, wrap=False)
            assert fused_entry(kern) == ("k1" if k == 1 else "sweep")
            envs = []
            for seed in range(B):
                wse, env = k1_body(port_core, name, dtype, seed=seed)
                wse.__exit__()
                envs.append(env)
            for cx, cy in itertools.product(range(mx), range(my)):
                coords = (cx * bx, cy * by)
                ins = []
                for n in kern.in_names:
                    f = np.stack([e[n] for e in envs]) if B > 1 else envs[0][n]
                    ins.append(torch.tensor(zero_window(
                        f, coords, bx, by, M or kern.pad), device="cuda"))
                outs = {}
                for how in ("kernel", "plain"):
                    out = ([torch.full_like(ins[kern.in_names.index(n)], -7.0)
                            for n in kern.written] if M else None)
                    call = launch_fused if how == "kernel" else fused_step_ref
                    outs[how] = call(kern, ins, coords, out=out)
                for g, w in zip(outs["kernel"], outs["plain"]):
                    assert torch.equal(g, w), (name, dtype, k, M, B, coords)


def _heat_member(T0, steps):
    with port_core.WSE_Interface() as wse:
        T = port_core.WSE_Array("T", init_data=T0, dtype=T0.dtype)
        with port_core.WSE_For_Loop("t", steps):
            T[1:-1, 0, 0] = 0.4 * T[1:-1, 0, 0] + 0.1 * (
                T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0]
                + T[1:-1, 0, -1] + T[1:-1, -1, 0] + T[1:-1, 0, 1])
    return wse, T


@pytest.mark.cuda
def test_cuda_sharded_make_equals_single_device():
    """make on a 2×2 mesh of the card equals the single-device make bit for
    bit, at k = 1 and the auto tile, resident and repacking; K1 is launched
    once per brick per engine launch, through the route its tile names."""
    _need_card()
    from repro_torch.engine import reset_stats, stats

    T0 = np.random.default_rng(14).uniform(300.0, 500.0,
                                           (64, 48, 12)).astype(np.float32)
    mesh = make_mesh((2, 2), ("data", "model"))
    for tt, resident in itertools.product((1, None), (True, False)):
        opts = dict(backend="pallas", time_tile=tt, resident=resident)
        wse, T = _heat_member(T0, 16)
        single = wse.make(answer=T, options=RunOptions(**opts))
        reset_stats()
        before = (launch_fused.launches, launch_fused.k1_launches,
                  launch_fused.sweep_launches, launch_fused.brick_launches)
        wse, T = _heat_member(T0, 16)
        sharded = wse.make(answer=T, options=RunOptions(mesh=mesh, **opts))
        launched = tuple(a - b for a, b in zip(
            (launch_fused.launches, launch_fused.k1_launches,
             launch_fused.sweep_launches, launch_fused.brick_launches),
            before))
        assert launched[0] == 4 * stats.launches > 0
        assert launched[1 if tt == 1 else 2] == launched[3] == launched[0], (
            launched)
        np.testing.assert_array_equal(sharded, single, err_msg=str(opts))


@pytest.mark.cuda
@pytest.mark.parametrize("time_tile", [1, None])
def test_cuda_resident_sharded_make_allocates_nothing_per_step(time_tile):
    """A resident sharded step makes no device allocation: a run's growth
    of ``allocation.all.allocated`` (after a warm-up run) is the same over
    16 steps as over 8."""
    _need_card()
    from repro_torch.core.mesh import NamedSharding
    from repro_torch.engine import plan, sharded_runner

    T0 = np.random.default_rng(15).uniform(300.0, 500.0,
                                           (64, 48, 12)).astype(np.float32)
    mesh = make_mesh((2, 2), ("data", "model"))
    grown = {}
    for steps in (8, 16):
        wse, _ = _heat_member(T0, steps)
        p = plan(wse.program, RunOptions(backend="pallas", time_tile=time_tile,
                                         mesh=mesh))
        run = sharded_runner(p)
        env = {"T": list(NamedSharding(mesh).shard(T0).bricks)}
        run(env)
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        run(env)
        torch.cuda.synchronize()
        grown[steps] = torch.cuda.memory_stats()["allocation.all.allocated"] - a0
    assert grown[16] == grown[8], grown


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "pipecg"])
def test_cuda_sharded_solve_matches_single_device(method):
    """A BTCS solve on a 2×2 mesh of the card: CONVERGED, within 3.2·tol of
    the single-device solve; pipecg's dot pairs go through K2 per brick."""
    _need_card()
    from repro_torch.solver import btcs_program, solve

    shape = (32, 32, 17)
    T0 = heat_init(shape)
    tol = 1e-5 * float(np.linalg.norm(T0))
    prog = btcs_program(shape, 0.1, init_data=T0)
    single = solve(prog, "T", method=method, tol=tol)
    before = launch_dual_dot.launches
    x, info = solve(prog, "T", method=method, tol=tol, return_info=True,
                    options=RunOptions(mesh=make_mesh((2, 2))))
    assert list(info.outcomes) == ["CONVERGED"]
    if method == "pipecg":
        assert launch_dual_dot.launches - before >= 4 * int(info.iterations[0])
    assert np.abs(x.astype(np.float64) - single).max() <= 3.2 * tol


# -- the exchange/compute overlap (K1's region mode) -----------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heat", "hazard"])
def test_cuda_k1_region_mode_bitwise_vs_plain(name):
    """K1's region mode over the interior of ``split_regions`` equals its
    plain version bit for bit on the card (k = 1, 2, 3, 8; 1 and 3
    members; float32 and float64), writes nothing outside the region, goes
    through the column entry's route for its tile and counts one
    ``region_launches``; each shell's padded launch into held ``out=``
    buffers equals its plain version too.  On one device (``wrap=True``,
    the brick at the origin) and on the bricks of a 2×2 mesh
    (``wrap=False``, the brick's global origin plus the region's, so the
    Moat comes from global coordinates)."""
    _need_card()
    from repro_torch.compiler import LoweredGroup
    from repro_torch.compiler.ir import split_regions

    for dtype, k, B in itertools.product((np.float32, np.float64),
                                         (1, 2, 3, 8), (1, 3)):
        brick = (2 * k + 9, 2 * k + 6)
        mesh = (2 * brick[0], 2 * brick[1])
        probe, _ = k1_kernel(name, dtype, "cpu", grid=brick)
        split = split_regions(LoweredGroup(probe.updates, probe.halo), k,
                              brick)
        M = k * probe.halo + 1
        for wrap, grid, (cx, cy) in ((True, brick, (0, 0)),
                                     (False, mesh, (0, brick[1])),
                                     (False, mesh, brick)):
            case = (name, dtype, k, B, wrap, (cx, cy))
            kern, _ = k1_kernel(name, dtype, "cuda", margin=M, k=k, batch=B,
                                grid=grid, brick=brick, wrap=wrap,
                                region=split.interior)
            lead = (B,) if B > 1 else ()
            gen = torch.Generator(device="cuda").manual_seed(k)
            ins = [torch.rand((*lead, *kern.extent, nz), generator=gen,
                              device="cuda", dtype=kern.dtype) + 0.5
                   for nz in kern.nz]
            r = split.interior
            outs = []
            before = (launch_fused.region_launches, launch_fused.k1_launches,
                      launch_fused.sweep_launches)
            for call in (launch_fused, fused_step_ref):
                out = [torch.full_like(ins[kern.in_names.index(n)], -7.0)
                       for n in kern.written]
                outs.append(call(kern, ins, (cx + r.x0, cy + r.y0), out=out))
            torch.cuda.synchronize()
            moved = tuple(a - b for a, b in zip(
                (launch_fused.region_launches, launch_fused.k1_launches,
                 launch_fused.sweep_launches), before))
            assert moved == (1, int(k == 1), int(k > 1)), moved
            for g, w in zip(*outs):
                assert torch.equal(g, w), case
            ph = kern.pad
            for s in split.shells:
                shell, _ = k1_kernel(name, dtype, "cuda", k=k, batch=B,
                                     grid=grid, brick=(s.rx, s.ry), wrap=wrap)
                wins = [t[..., M + s.x0 - ph:M + s.x0 + s.rx + ph,
                          M + s.y0 - ph:M + s.y0 + s.ry + ph, :].contiguous()
                        for t in ins]
                held = [torch.empty(shell.stacked((s.rx, s.ry, nz)),
                                    dtype=shell.dtype, device="cuda")
                        for n, nz in zip(shell.in_names, shell.nz)
                        if n in shell.written]
                at = (cx + s.x0, cy + s.y0)
                got = launch_fused(shell, wins, at, out=held)
                assert all(g is h for g, h in zip(got, held))
                want = fused_step_ref(shell, wins, at)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), case + (s,)


@pytest.mark.cuda
def test_cuda_overlap_make_equals_monolithic():
    """``make(overlap=True)`` on the card equals the monolithic make bit
    for bit at k = 1 and the auto tile, on one device and on a 2×2 mesh, 1
    and 3 members; every engine launch is one region launch per brick; a
    resident split step makes no device allocation."""
    _need_card()
    from repro_torch.core.mesh import NamedSharding
    from repro_torch.engine import plan, reset_stats, sharded_runner, \
        single_runner, stats

    T0 = np.random.default_rng(16).uniform(300.0, 500.0,
                                           (64, 48, 12)).astype(np.float32)
    stack = np.stack([T0, T0 + 1.0, T0 - 2.0])
    for tt, mesh, B in itertools.product((1, None), (None, (2, 2)), (1, 3)):
        m = mesh and make_mesh(mesh, ("data", "model"))
        out = {}
        for ov in (False, True):
            wse, T = _heat_member(T0, 16)
            opts = RunOptions(backend="pallas", time_tile=tt, mesh=m,
                              overlap=ov)
            reset_stats()
            before = launch_fused.region_launches
            if B > 1:
                import repro_torch as wfa
                out[ov] = wfa.make(wfa.Ensemble(wse.program, T,
                                                overrides={"T": stack}),
                                   options=opts)
            else:
                out[ov] = wse.make(answer=T, options=opts)
            bricks = m.size if m else 1
            assert launch_fused.region_launches - before == (
                bricks * stats.launches if ov else 0)
            assert stats.boundary_launches == (4 * stats.launches if ov else 0)
        np.testing.assert_array_equal(out[True], out[False],
                                      err_msg=str((tt, mesh, B)))
    for tt, mesh in itertools.product((1, None), (None, (2, 2))):
        m = mesh and make_mesh(mesh, ("data", "model"))
        grown = {}
        for steps in (8, 16):
            wse, _ = _heat_member(T0, steps)
            p = plan(wse.program, RunOptions(backend="pallas", time_tile=tt,
                                             mesh=m, overlap=True))
            assert p.segments[0].split == 4
            if m:
                run = sharded_runner(p)
                env = {"T": list(NamedSharding(m).shard(T0).bricks)}
            else:
                run = single_runner(p)
                env = {"T": torch.tensor(T0, device="cuda")}
            run(env)
            torch.cuda.synchronize()
            a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
            run(env)
            torch.cuda.synchronize()
            grown[steps] = (torch.cuda.memory_stats()["allocation.all.allocated"]
                            - a0)
        assert grown[16] == grown[8], (tt, mesh, grown)


@pytest.mark.cuda
@pytest.mark.parametrize("time_tile", [1, 8])
def test_cuda_guarded_resident_make_equals_unguarded(time_tile):
    """A guarded resident ``make`` (``check_finite=16``) on the card equals
    the unguarded one bit for bit, with the same K1 launches and the
    reference's probes (entry, one per full chunk, one for the tail); a
    cell overflowing mid-run faults with ``last_good`` equal to the
    unguarded run at the last probed step."""
    _need_card()
    import warnings

    from repro_torch.engine import reset_stats, stats
    from repro_torch.solver import NumericalFault

    T0 = np.random.default_rng(27).uniform(300.0, 500.0,
                                           (64, 48, 12)).astype(np.float32)
    out, launches = {}, {}
    for check in (0, 16):
        wse, T = _heat_member(T0, 40)
        reset_stats()
        before = launch_fused.launches
        out[check] = wse.make(answer=T, options=RunOptions(
            backend="pallas", time_tile=time_tile, check_finite=check))
        launches[check] = launch_fused.launches - before
        if check:
            assert stats.health_probes == 1 + 3  # 16 + 16 + 8 steps
    np.testing.assert_array_equal(out[16], out[0])
    assert launches[16] == launches[0] > 0

    def grow(steps):
        wse = port_core.WSE_Interface()
        A = port_core.WSE_Array("A", init_data=init)
        with port_core.WSE_For_Loop("t", steps):
            A[1:-1, 0, 0] = 2.0 * A[1:-1, 0, 0] + 0.125 * (
                A[2:, 0, 0] + A[:-2, 0, 0] + A[1:-1, 1, 0] + A[1:-1, -1, 0])
        return wse, A

    init = np.ones((64, 48, 12), np.float32)
    init[30, 20, 6] = 3.0e38 / 2.5 ** 20
    opts = RunOptions(backend="pallas", time_tile=time_tile, check_finite=8)
    wse, A = grow(40)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(NumericalFault) as exc:
            wse.make(answer=A, options=opts)
        wse.__exit__()
    good = int(str(exc.value).split("last finite probe at step ")[1]
               .rstrip(")"))
    assert 0 < good < exc.value.step
    wse, A = grow(good)
    want = wse.make(answer=A, options=opts.replace(check_finite=0))
    np.testing.assert_array_equal(exc.value.last_good["A"], want)


@pytest.mark.cuda
def test_cuda_differentiable_make_forward_on_k1():
    """The differentiable runner's forward runs K1 (no interpreter
    fallback), gives the repacking ``make``'s bits, and its checkpointed
    gradient equals the all-residuals one."""
    _need_card()
    from repro_torch import compiler
    from repro_torch.engine import differentiable_runner, plan

    T0 = np.random.default_rng(28).uniform(300.0, 500.0,
                                           (64, 48, 12)).astype(np.float32)
    w = torch.randn(64, 48, 12, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5))
    wse, T = _heat_member(T0, 13)
    prog = wse.program
    want = wse.make(answer=T, options=RunOptions(
        backend="pallas", time_tile=4, resident=False))
    grads = {}
    for ck in (True, False):
        compiler.reset_stats()
        p = plan(prog, RunOptions(backend="pallas", time_tile=4,
                                  differentiable=True))
        run = differentiable_runner(p, checkpoint=ck)
        x = torch.tensor(T0, device="cuda", requires_grad=True)
        before = launch_fused.launches
        out = run({"T": x})["T"]
        assert launch_fused.launches - before == 3 + 1  # 3 tiles + 1 step
        assert compiler.stats.fallbacks == 0
        np.testing.assert_array_equal(out.detach().cpu().numpy(), want)
        (grads[ck],) = torch.autograd.grad(torch.sum(w * out), x)
    assert torch.equal(grads[True], grads[False])


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cg", "pipecg"])
def test_cuda_symmetric_adjoint_builds_no_kernel(method):
    """The symmetric adjoint's backward solve runs K1 (and K2 for pipecg)
    from the forward's cache entry: no kernel is built across the
    backward, and the gradient matches the one on the CPU."""
    _need_card()
    from repro_torch import compiler
    from repro_torch.core.field import Field
    from repro_torch.core.program import scoped_program
    from repro_torch.solver import make_differentiable_solver
    from repro_torch.solver.presets import _record_btcs_body

    T0 = heat_init((33, 29, 10)).astype(np.float64)
    with scoped_program() as prog:
        _record_btcs_body(Field("T", init_data=T0, dtype=np.float64), 0.2)
    w = np.random.default_rng(29).normal(size=T0.shape)
    grads = {}
    for dev in ("cpu", "cuda"):
        s = make_differentiable_solver(prog, "T", method=method, tol=1e-11,
                                       maxiter=400, device=dev)
        assert s.symmetric_adjoint
        built = compiler.stats.kernels_built
        x = torch.tensor(T0, device=dev, requires_grad=True)
        before = launch_fused.launches
        loss = torch.sum(torch.tensor(w, device=dev) * s(x))
        fwd = launch_fused.launches
        (g,) = torch.autograd.grad(loss, x)
        assert compiler.stats.kernels_built == built
        if dev == "cuda":
            assert fwd > before and launch_fused.launches > fwd
        grads[dev] = g.cpu().numpy()
    scale = np.abs(grads["cpu"]).max()
    assert np.abs(grads["cuda"] - grads["cpu"]).max() <= 1e-8 * scale


@pytest.mark.cuda
def test_cuda_service_four_workers_equal_one():
    """The service on the card: four workers serving a mixed stream (heat3d
    and advdiff at k = 1, jacobi3d's k = 2 sweep, pipecg solves) return
    each request's bits as one worker does — the kernel cache, the library
    build and K1's held sweep scratch are shared across worker threads —
    and step results equal the engine's ``make`` on the card bitwise."""
    _need_card()
    from repro_torch.engine.executor import run_program
    from repro_torch.service import (PlanSignature, SimulationService,
                                     SolveRequest, StepRequest, get_workload)

    sigs = [PlanSignature("heat3d", (48, 40, 12)),
            PlanSignature("advdiff", (40, 40, 12)),
            PlanSignature("jacobi3d", (32, 32, 12), time_tile=2)]
    solve_sig = PlanSignature("btcs_heat", (24, 24, 8))
    rng = np.random.default_rng(31)
    stream = []
    for i in range(24):
        if i % 6 == 5:
            stream.append(("solve", None))
        else:
            sig = sigs[i % 3]
            lo, hi = (300.0, 500.0) if sig.workload == "heat3d" else (0.0, 1.0)
            stream.append((sig, rng.uniform(lo, hi, sig.shape)
                           .astype(np.float32)))
    results = {}
    for workers in (1, 4):
        with SimulationService(workers=workers, manifest=sigs + [solve_sig],
                               default_chunk=5) as svc:
            tickets = [svc.submit(
                SolveRequest(solve_sig, method="pipecg", tol=1.0,
                             maxiter=100) if sig == "solve" else
                StepRequest(sig, steps=13, init=T0)) for sig, T0 in stream]
            results[workers] = [t.result(timeout=300) for t in tickets]
    for one, four in zip(results[1], results[4]):
        np.testing.assert_array_equal(four, one)
    for (sig, T0), out in zip(stream, results[1]):
        if sig == "solve":
            continue
        program, answer = get_workload(sig.workload).record(
            sig.shape, np.float32, 13)
        env = {n: f.init_data for n, f in program.fields.items()}
        env[answer] = T0
        want = run_program(program, env, RunOptions(
            backend="pallas", time_tile=sig.time_tile))[answer]
        np.testing.assert_array_equal(out, want)


@pytest.mark.cuda
def test_cuda_service_chunk_allocates_nothing():
    """A chunk the service serves — its steps, the wait and the held probe
    — makes no device allocation: through a warm one-worker service, a
    request of 2n steps grows ``allocation.all.allocated`` exactly as one
    of n steps does (the request's env, spares, probe buffers and result
    are allocated once each and cancel), at k = 1 and at jacobi3d's k = 2
    sweep, after a warm-up request of each length."""
    _need_card()
    from repro_torch.service import (PlanSignature, SimulationService,
                                     StepRequest)

    sigs = [PlanSignature("heat3d", (96, 80, 40)),
            PlanSignature("jacobi3d", (64, 64, 40), time_tile=2)]
    with SimulationService(workers=1, manifest=sigs, default_chunk=8) as svc:
        for sig in sigs:
            grown = {}
            for steps in (48, 96, 48, 96):
                torch.cuda.synchronize()
                a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
                t = svc.submit(StepRequest(sig, steps=steps))
                t.result(timeout=300)
                torch.cuda.synchronize()
                grown[steps] = (torch.cuda.memory_stats()
                                ["allocation.all.allocated"] - a0)
                assert t.stats.chunks == steps // 8
            assert grown[96] == grown[48], (sig.workload, grown)


@pytest.mark.cuda
def test_cuda_calibration_tags_the_card_and_keeps_the_bits():
    """``calibrate_program`` on the card (a 64×48×12 heat body at k = 1, 2,
    4) tags its entry ``"cuda:"`` and the card's name; ``make`` with
    ``time_tile=None`` and ``overlap="auto"`` then counts one hit and
    equals the uncalibrated ``make`` bit for bit; an entry for the same
    body under the ``cpu`` tag gives the card plan no hit."""
    _need_card()
    import dataclasses

    from repro_torch.core import perfmodel
    from repro_torch.engine import plan, reset_stats, stats

    T0 = np.random.default_rng(29).uniform(300.0, 500.0,
                                           (64, 48, 12)).astype(np.float32)
    opts = RunOptions(backend="pallas", time_tile=None, overlap="auto")

    def make():
        wse, T = _heat_member(T0, 16)
        return wse.make(answer=T, options=opts)

    try:
        perfmodel.cost_model.clear()
        want = make()
        wse, _ = _heat_member(T0, 16)
        entry = perfmodel.calibrate_program(wse.program, ks=(1, 2, 4),
                                            reps=1, inner=2)["T"]
        assert entry.device == "cuda:" + torch.cuda.get_device_name(
            torch.cuda.current_device())
        reset_stats()
        got = make()
        assert stats.cost_model_hits == 1
        np.testing.assert_array_equal(got, want)
        group = lower_group(list(wse.program.ops))
        perfmodel.cost_model.clear()
        perfmodel.cost_model.put(dataclasses.replace(
            entry, device="cpu",
            signature=perfmodel.body_signature(group, 12, np.float32, "cpu")))
        reset_stats()
        plan(wse.program, opts)
        assert stats.cost_model_hits == 0
    finally:
        perfmodel.cost_model.clear()


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _lm_logits(params, tokens, cfg, s0):
    """The forward's logits, and the prefill's + each teacher-forced
    decode step's along the sequence axis."""
    from repro_torch.models import model as M

    full, _ = M.forward(params, tokens, cfg)
    got, cache = M.prefill(params, tokens[:, :s0], cfg, tokens.shape[1])
    rows = [got]
    for t in range(s0, tokens.shape[1]):
        got, cache = M.decode_step(params, cache, tokens[:, t:t + 1], t, cfg)
        rows.append(got)
    return full, torch.cat(rows, dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_matches_the_cpu(arch, no_tf32):
    """Each architecture's ``smoke()`` on the card against the CPU, the
    same weights: forward and teacher-forced decode logits within
    ``1e-4·max|logit|``."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.models import model as M

    cfg = get_config(arch).smoke()
    p_cpu = M.init_params(cfg, seed=30, device="cpu")
    p_gpu = lm_params_from_numpy(lm_params_to_numpy(p_cpu), cfg, "cuda")
    shape = (2, 16) if cfg.n_codebooks == 1 else (2, 16, cfg.n_codebooks)
    tokens = torch.from_numpy(np.random.default_rng(30).integers(
        1, cfg.vocab_size, shape))
    want = _lm_logits(p_cpu, tokens, cfg, 12)
    got = _lm_logits(p_gpu, tokens.cuda(), cfg, 12)
    for g, w in zip(got, want):
        assert g.is_cuda
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (arch, err)


@pytest.mark.cuda
def test_cuda_serve_on_the_card():
    """``serve`` on the card: in-vocabulary tokens of the asked shape on
    the card, the same on a second run."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    cfg = get_config("qwen3-0.6b").smoke()
    toks, rate = serve(cfg, batch=2, prompt_len=8, gen=5, seed=3)
    assert toks.is_cuda and tuple(toks.shape) == (2, 5) and rate > 0
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size
    again, _ = serve(cfg, batch=2, prompt_len=8, gen=5, seed=3)
    assert torch.equal(toks, again)
