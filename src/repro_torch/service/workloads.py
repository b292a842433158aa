"""Workload registry + compiled plans for the simulation service.

The port of ``repro/service/workloads.py``.  A *workload* is a named recipe
for recording a WFA program at a requested ``(shape, dtype)`` — the
service's analogue of a model architecture in an inference server.  A
:class:`PlanSignature` names one workload at one specialization, and
:func:`build_workload` turns it into a :class:`CompiledWorkload`: the
recorded program, its :func:`repro_torch.engine.plan` schedule and the
halo-resident layout, stepped ``m`` logical steps at a time by
:meth:`CompiledWorkload.advance`.

Chunked stepping is what makes serving checkpointable: the service holds
one request's standing buffers between chunks — on one device the
resident padded env *and its ping-pong spares*, allocated once by
:meth:`CompiledWorkload.initial_env`, so a chunk in the steady state
allocates nothing — and snapshots the env at chunk boundaries, so a fault
between chunks resumes from the last snapshot instead of step 0.  A chunk
is a host loop of the segment's steps (``seg.step(env, spare)`` swaps each
written field with its spare), so chunking launches exactly what an
uninterrupted run launches and is bitwise-invariant at every precision —
with one caveat for temporal blocking: a ``k``-step fused launch is a
different schedule from ``k`` untiled launches, so on tiled plans the
invariance holds when every chunk boundary lands on a multiple of the tile
factor (the service snaps its chunk granule accordingly).

Registered workloads (three distinct stencil families, so a mixed request
stream exercises distinct plan signatures), the reference's bodies:

* ``heat3d``   — the paper's explicit FTCS heat body (7-point, affine);
* ``advdiff``  — advection–diffusion with off-axis diagonal taps;
* ``jacobi3d`` — weighted-Jacobi Poisson sweeps against a fixed RHS field
  (two fields: only the sweep field is written);
* ``btcs_heat`` — the implicit BTCS system (``Operator``/``Rhs``), served
  through :func:`repro_torch.solver.api.make_solver` (``SolveRequest``
  only).

The one difference from the reference is ``device``: :func:`build_workload`
passes it to ``RunOptions(device=)`` and ``make_solver(device=)``; the
default, ``"cuda"``, raises without a card.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.field import Field
from repro_torch.core.mesh import BrickArray, NamedSharding, device_get, device_put
from repro_torch.core.program import ForLoop, scoped_program
from repro_torch.engine.executor import fresh_buffer
from repro_torch.engine.plan import plan as build_plan
from repro_torch.service.requests import PlanSignature

Shape = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One registered workload: how to record it and how to initialize it."""

    name: str
    kind: str  # "step" | "solve"
    record: Callable  # (shape, dtype, n_steps) -> (program, answer_name)
    default_init: Callable[[Shape, object], np.ndarray]
    description: str = ""


WORKLOADS: Dict[str, WorkloadSpec] = {}


def register_workload(spec: WorkloadSpec) -> WorkloadSpec:
    WORKLOADS[spec.name] = spec
    return spec


def get_workload(name: str) -> WorkloadSpec:
    if name not in WORKLOADS:
        raise KeyError(
            f"unknown workload {name!r}; registered: {sorted(WORKLOADS)}"
        )
    return WORKLOADS[name]


# ---------------------------------------------------------------------------
# registered workloads
# ---------------------------------------------------------------------------


def _hot_plate(shape: Shape, dtype) -> np.ndarray:
    T = np.full(shape, 500.0, dtype)
    T[1:-1, 1:-1, 0] = 300.0
    T[1:-1, 1:-1, -1] = 400.0
    return T


def _smooth_noise(shape: Shape, dtype) -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.uniform(0.0, 1.0, size=shape).astype(dtype)


def _record_heat3d(shape: Shape, dtype, n_steps: int):
    c = 0.1
    center = 1.0 - 6.0 * c
    with scoped_program() as program:
        T = Field("T", init_data=_hot_plate(shape, dtype), dtype=dtype)
        with ForLoop("service_heat", n_steps):
            T[1:-1, 0, 0] = center * T[1:-1, 0, 0] + c * (
                T[2:, 0, 0]
                + T[:-2, 0, 0]
                + T[1:-1, 1, 0]
                + T[1:-1, -1, 0]
                + T[1:-1, 0, 1]
                + T[1:-1, 0, -1]
            )
    return program, "T"


def _record_advdiff(shape: Shape, dtype, n_steps: int):
    with scoped_program() as program:
        T = Field("T", init_data=_smooth_noise(shape, dtype), dtype=dtype)
        with ForLoop("service_advdiff", n_steps):
            T[1:-1, 0, 0] = (
                T[1:-1, 0, 0]
                + 0.05
                * (
                    T[2:, 0, 0]
                    + T[:-2, 0, 0]
                    + T[1:-1, 1, 0]
                    + T[1:-1, -1, 0]
                    + T[1:-1, 0, 1]
                    + T[1:-1, 0, -1]
                    - 6.0 * T[1:-1, 0, 0]
                )
                - 0.1 * (T[1:-1, 0, 0] - T[1:-1, -1, 0])
                - 0.07 * (T[1:-1, 0, 0] - T[1:-1, 0, -1])
                + 0.02 * (T[1:-1, 1, 1] + T[1:-1, -1, -1] - 2.0 * T[1:-1, 0, 0])
            )
    return program, "T"


def _record_jacobi3d(shape: Shape, dtype, n_steps: int):
    w = 6.0 / 7.0  # weighted-Jacobi damping (the multigrid smoother's omega)
    with scoped_program() as program:
        U = Field("U", init_data=np.zeros(shape, dtype), dtype=dtype)
        F = Field("F", init_data=_smooth_noise(shape, dtype), dtype=dtype)
        with ForLoop("service_jacobi", n_steps):
            U[1:-1, 0, 0] = (1.0 - w) * U[1:-1, 0, 0] + (w / 6.0) * (
                U[2:, 0, 0]
                + U[:-2, 0, 0]
                + U[1:-1, 1, 0]
                + U[1:-1, -1, 0]
                + U[1:-1, 0, 1]
                + U[1:-1, 0, -1]
                - F[1:-1, 0, 0]
            )
    return program, "U"


def _record_btcs_heat(shape: Shape, dtype, n_steps: int):
    from repro_torch.solver import Operator, Rhs

    wpsi, psi = 0.05, 0.625
    with scoped_program() as program:
        T = Field("T", init_data=_hot_plate(shape, dtype), dtype=dtype)
        with Operator():
            T[1:-1, 0, 0] = T[1:-1, 0, 0] - wpsi * (
                T[2:, 0, 0]
                + T[:-2, 0, 0]
                + T[1:-1, 1, 0]
                + T[1:-1, -1, 0]
                + T[1:-1, 0, 1]
                + T[1:-1, 0, -1]
            )
        with Rhs():
            T[1:-1, 0, 0] = psi * T[1:-1, 0, 0]
    return program, "T"


register_workload(
    WorkloadSpec(
        "heat3d", "step", _record_heat3d, _hot_plate,
        "explicit FTCS heat (paper Fig. 3 body)",
    )
)
register_workload(
    WorkloadSpec(
        "advdiff", "step", _record_advdiff, _smooth_noise,
        "advection-diffusion with off-axis taps",
    )
)
register_workload(
    WorkloadSpec(
        "jacobi3d", "step", _record_jacobi3d,
        lambda shape, dtype: np.zeros(shape, dtype),
        "weighted-Jacobi Poisson sweeps against a fixed RHS field",
    )
)
register_workload(
    WorkloadSpec(
        "btcs_heat", "solve", _record_btcs_heat, _hot_plate,
        "implicit BTCS heat system (Operator/Rhs, Krylov solve)",
    )
)


# ---------------------------------------------------------------------------
# compiled workloads
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledWorkload:
    """One signature's compiled execution state, shared by every request.

    ``plan``/``layout`` come straight from the engine planner; the state a
    request steps (its env and its spares) is its own.  ``degraded`` is
    set when the pallas backend fell back to the interpreter (forced
    compile failure, non-lowerable body) — requests served through it are
    counted and flagged, never silent; such a segment steps plain tensors
    (no resident layout, no spares).
    """

    signature: PlanSignature
    spec: WorkloadSpec
    program: object
    answer: str
    device: torch.device
    plan: Optional[object] = None  # ExecutionPlan (step workloads)
    mesh: Optional[object] = None
    build_s: float = 0.0
    degraded: bool = False
    degraded_reason: str = ""
    _solvers: Dict[tuple, Callable] = dataclasses.field(default_factory=dict)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    # -- step workloads ------------------------------------------------------
    @property
    def layout(self):
        return self.plan.layout

    @property
    def segment(self):
        return self.plan.segments[0]

    @property
    def resident(self) -> bool:
        """Whether chunks step the halo-resident layout (a fused segment
        with a margin): K1's margin mode into ping-pong spares."""
        return self.segment.kind == "fused" and self.layout.pad > 0

    def field_names(self):
        return list(self.program.fields)

    def initial_env(self, init: Optional[np.ndarray]) -> Tuple[dict, dict]:
        """A request's fresh device state: ``(env, spare)``.

        ``env`` is in resident form on one device (every field entered to
        the layout's padded extent) and name → x-major list of bricks on a
        mesh; ``spare`` holds one zeroed resident buffer per written field
        (per brick on a mesh) — the ping-pong partner each chunk's steps
        swap with, allocated here once for the request's life ({} when the
        segment is not resident).  Batched signatures stack every field to
        ``(B, X, Y, Z)``; ``init`` may then be one state shared by all
        members or a per-member stack.
        """
        B = self.signature.batch
        env = {
            n: np.asarray(f.init_data) for n, f in self.program.fields.items()
        }
        if init is not None:
            init = np.asarray(init, dtype=self.signature.dtype)
            if init.ndim == 4 and init.shape[0] != B:
                raise ValueError(
                    f"init stacks {init.shape[0]} members; signature "
                    f"batch is {B}"
                )
            env[self.answer] = init
        if B > 1:
            env = {
                n: (
                    v
                    if v.ndim == 4
                    else np.broadcast_to(v, (B,) + v.shape).copy()
                )
                for n, v in env.items()
            }
        if self.mesh is None:
            env = {n: fresh_buffer(v, self.device) for n, v in env.items()}
            if self.resident:
                env = self.layout.enter(env)
        else:
            sharding = NamedSharding(self.mesh)
            env = {n: list(device_put(v, sharding).bricks)
                   for n, v in env.items()}
        return env, self.new_spares(env)

    def new_spares(self, env: dict) -> dict:
        """Zeroed ping-pong spares for ``env``'s written fields: at the
        resident extent of ``env``'s buffers (one device) or of its bricks
        (mesh).  Zeroed, not empty: a spare's margins are swapped into the
        env, whose whole buffers the per-chunk probe reads."""
        if not self.resident:
            return {}
        if self.mesh is None:
            return {n: torch.zeros_like(env[n]) for n in self.segment.written}
        K = self.layout.pad
        return {n: [b.new_zeros((*b.shape[:-3], b.shape[-3] + 2 * K,
                                 b.shape[-2] + 2 * K, b.shape[-1]))
                    for b in env[n]]
                for n in self.segment.written}

    def finalize(self, env: dict) -> np.ndarray:
        """Answer field back on the host (interior slice on one device)."""
        v = env[self.answer]
        if self.mesh is not None:
            return device_get(BrickArray(v, NamedSharding(self.mesh)))
        if self.resident:
            v = self.layout.exit({self.answer: v})[self.answer]
        return v.cpu().numpy()

    def _steps(self, env: dict, spare: dict, m: int) -> dict:
        seg = self.segment
        args = (spare,) if self.resident else ()
        k = seg.time_tile if seg.kind == "fused" else 1
        for _ in range(m // k):
            env = seg.step(env, *args)
        # the planner compiled step_rem because the workload's nominal
        # trip count is k+1 (see build_workload)
        for _ in range(m % k):
            env = seg.step_rem(env, *args)
        return env

    def advance(self, env: dict, spare: dict, m: int) -> dict:
        """Step ``env`` ``m`` logical steps; returns the new env.

        One device: the resident env and ``spare`` are stepped in place,
        each step swapping a written field's buffer with its spare, so the
        returned env's buffers are ``env``'s and ``spare``'s (no
        allocation).  Mesh: every brick is entered, stepped against its
        spare and exited, as the reference's ``shard_map`` body does per
        chunk.  Enqueues only; the caller waits.
        """
        if self.mesh is None or not self.resident:
            return self._steps(env, spare, m)
        from repro_torch.engine.executor import _per_brick

        env = _per_brick(self.layout.enter, env)
        return _per_brick(self.layout.exit, self._steps(env, spare, m))

    def chunk_accounting(self, m: int) -> Tuple[int, int]:
        """Static (launches, exchanges) one ``m``-step chunk pays."""
        seg = self.segment
        if seg.kind != "fused":
            launches = m
            exchanges = m * len(seg.ops) if self.mesh is not None else 0
            return launches, exchanges
        k = seg.time_tile
        launches = (m // k) + (m % k) if k > 1 else m
        return launches, launches if seg.halo > 0 else 0

    # -- solve workloads -----------------------------------------------------
    def solver(self, method: str, tol: float, maxiter: int) -> Callable:
        """Memoized solver ``x0 -> (x, (iters, res, outcomes))`` per request
        parameters (the operator kernel itself is shared via the global
        kernel cache, so new parameter combinations reuse it)."""
        key = (method, float(tol), int(maxiter))
        with self._lock:
            hit = self._solvers.get(key)
            if hit is not None:
                return hit
            from repro_torch.solver.api import make_solver

            fn = make_solver(
                self.program,
                self.answer,
                method=method,
                backend=self.signature.backend,
                tol=tol,
                maxiter=maxiter,
                batch=self.signature.batch,
                device=self.device,
            )
            self._solvers[key] = fn
            return fn


def build_workload(
    signature: PlanSignature, mesh=None, device="cuda"
) -> CompiledWorkload:
    """Record + plan one signature (the service's plan-cache miss path).

    Step workloads are recorded with a nominal trip count of
    ``time_tile + 1`` so the planner compiles both the tiled step and the
    untiled remainder step — a chunk can then advance *any* step count,
    not just multiples of the tile factor.  Raises ``ValueError`` for
    solve workloads on a mesh (served single-device for now) and for
    multi-loop programs (chunked checkpointing needs one loop body).
    ``device`` is the run's torch device (``RunOptions.device``; a mesh's
    bricks must be of its type); the default, the card, raises without
    one.
    """
    from repro_torch.compiler import stats as kstats
    from repro_torch.engine.options import RunOptions
    from repro_torch.engine.plan import resolve_device
    from repro_torch.engine.stats import stats as estats

    spec = get_workload(signature.workload)
    if signature.batch > 1 and mesh is not None:
        raise ValueError(
            "batched signatures are served single-device; submit "
            f"{signature.key()!r} without a mesh"
        )
    if spec.kind == "solve" and mesh is not None:
        raise ValueError(
            f"solve workload {spec.name!r} is served single-device; "
            "submit without a mesh"
        )
    t0 = time.perf_counter()
    nominal = signature.time_tile + 1 if signature.time_tile > 1 else 2
    program, answer = spec.record(
        signature.shape, np.dtype(signature.dtype), nominal
    )
    cw = CompiledWorkload(
        signature=signature, spec=spec, program=program, answer=answer,
        device=resolve_device(device) if mesh is None else mesh.home,
        mesh=mesh,
    )
    fallbacks_before = kstats.fallbacks
    if spec.kind == "step":
        cw.plan = build_plan(
            program,
            options=RunOptions(
                backend=signature.backend,
                mesh=mesh,
                time_tile=signature.time_tile,
                batch=signature.batch,
                device=device,
            ),
        )
        if len(cw.plan.segments) != 1:
            raise ValueError(
                f"workload {spec.name!r} records {len(cw.plan.segments)} "
                "loop bodies; the service's chunked stepping needs exactly 1"
            )
        seg = cw.plan.segments[0]
        if signature.backend == "pallas" and seg.kind != "fused":
            cw.degraded = True
            cw.degraded_reason = (
                kstats.fallback_reasons[-1]
                if kstats.fallbacks > fallbacks_before
                else "body not fused"
            )
    else:
        # build the default solver now so warm-up pays the operator compile
        cw.solver("cg", 1e-6, 200)
        if kstats.fallbacks > fallbacks_before:
            cw.degraded = True
            cw.degraded_reason = kstats.fallback_reasons[-1]
    cw.build_s = time.perf_counter() - t0
    estats.plan_builds += 1
    return cw
