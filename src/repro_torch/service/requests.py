"""Request model for the simulation service.

The port's own copy of ``repro/service/requests.py`` (it imports nothing
of ``repro``): :meth:`PlanSignature.key` and its JSON form are spelled
exactly as the reference spells them, so a manifest saved by either
package warms the other.

A request names *what* to run through a :class:`PlanSignature` — the
service's unit of cacheability.  Two requests with equal signatures share
one compiled :class:`~repro_torch.service.workloads.CompiledWorkload` (and
therefore one kernel-cache lineage), which is what makes warm-pool serving
work: the scheduler groups queued requests by signature and a worker that
has the plan hot serves the whole group without a single compile.

``StepRequest`` runs an explicit time-stepping workload for ``steps``
logical steps (optionally checkpointing resident state every
``ckpt_every`` steps so a killed worker resumes mid-flight);
``SolveRequest`` runs a recorded implicit system to convergence.  Both
carry ``priority`` (higher dispatches first) and ``deadline_s`` (seconds
from submit; requests still queued past it are expired, not run).

Results travel through a :class:`Ticket` — a thread-safe future the
submitting thread blocks on — carrying the per-request
:class:`RequestStats` record either way (observability survives failure).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Optional, Tuple

import numpy as np


class ServiceOverloaded(RuntimeError):
    """Admission control rejected the request: the bounded queue is full."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed while it was still queued."""


class RequestFailed(RuntimeError):
    """The request exhausted its retry budget without completing."""


_ids = itertools.count()


def _next_id(prefix: str) -> str:
    return f"{prefix}-{next(_ids):06d}"


@dataclasses.dataclass(frozen=True)
class PlanSignature:
    """The cache key of one compiled workload.

    ``workload`` names a registered program recorder (see
    :mod:`repro_torch.service.workloads`); ``shape``/``dtype`` fix the field
    extents the kernels are specialized to; ``time_tile`` and ``backend``
    select the execution strategy; ``batch`` is the ensemble width the plan
    steps per launch (1 = classic single-scenario serving — its ``key()``
    spelling is unchanged, so pre-batch warm manifests stay valid).
    Everything the compiled plan depends on is in here — equal signatures
    are interchangeable at serve time.
    """

    workload: str
    shape: Tuple[int, int, int]
    dtype: str = "float32"
    time_tile: int = 1
    backend: str = "pallas"
    batch: int = 1

    def __post_init__(self):
        if len(self.shape) != 3:
            raise ValueError(f"shape must be (X, Y, Z); got {self.shape!r}")
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        np.dtype(self.dtype)  # validates early, at request-build time
        if self.time_tile < 1:
            raise ValueError(f"time_tile must be >= 1; got {self.time_tile}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1; got {self.batch}")

    def key(self) -> str:
        nx, ny, nz = self.shape
        base = (
            f"{self.workload}:{nx}x{ny}x{nz}:{self.dtype}"
            f":k{self.time_tile}:{self.backend}"
        )
        # batch=1 keeps the historical spelling so schema-1 manifests and
        # old dashboards keep matching
        return base if self.batch == 1 else f"{base}:b{self.batch}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "PlanSignature":
        return cls(
            workload=d["workload"],
            shape=tuple(d["shape"]),
            dtype=d.get("dtype", "float32"),
            time_tile=int(d.get("time_tile", 1)),
            backend=d.get("backend", "pallas"),
            batch=int(d.get("batch", 1)),  # absent in schema-1 manifests
        )


@dataclasses.dataclass
class RequestStats:
    """Per-request observability record (attached to the ticket either way).

    ``queue_wait_s`` is submit → dispatch; ``plan_cache_hit`` says whether
    the worker found the signature's plan warm (after warm-up it always
    should); ``launches``/``exchanges`` are the kernel-level counts this
    request's chunks actually paid; ``retries``/``restores`` count the
    restore-and-continue path; ``degraded`` marks the interpreter fallback;
    ``batch`` > 1 marks a request served as one member of a coalesced
    ensemble launch (micro-batching).

    ``outcome`` is the numerical-health taxonomy word of the request's
    solve (``CONVERGED``/``NAN_RESIDUAL``/…, see :mod:`repro_torch.solver.health`;
    empty for step requests that tripped no sentinel) and ``recovery`` the
    per-attempt summary of any escalation the worker ran — both populated
    whether the request completed or failed with a ``NumericalFault``
    (which the service never retries).
    """

    request_id: str = ""
    signature: str = ""
    batch: int = 1
    worker: Optional[int] = None
    submitted_s: float = 0.0
    started_s: float = 0.0
    finished_s: float = 0.0
    queue_wait_s: float = 0.0
    exec_s: float = 0.0
    plan_cache_hit: bool = False
    compile_s: float = 0.0  # plan build time when this request paid it
    steps: int = 0
    chunks: int = 0
    launches: int = 0
    exchanges: int = 0
    repacks: int = 0
    iterations: int = 0  # solve requests: inner Krylov iterations
    retries: int = 0
    checkpoints: int = 0
    restores: int = 0
    degraded: bool = False
    degraded_reason: str = ""
    outcome: str = ""  # health taxonomy word of the solve ("" = n/a)
    recovery: Tuple[str, ...] = ()  # per-attempt escalation summary

    @property
    def latency_s(self) -> float:
        return max(0.0, self.finished_s - self.submitted_s)


def _check_init(init, signature: PlanSignature) -> None:
    """``init`` may be one state at ``signature.shape``, or — for batched
    signatures — a per-member ``(batch,) + shape`` stack."""
    if init is None:
        return
    got = tuple(init.shape)
    ok = [signature.shape]
    if signature.batch > 1:
        ok.append((signature.batch,) + signature.shape)
    if got not in ok:
        raise ValueError(
            f"init shape {got} != signature shape "
            f"{' or '.join(str(s) for s in ok)}"
        )


@dataclasses.dataclass
class StepRequest:
    """Run a registered explicit workload for ``steps`` logical steps.

    ``init`` overrides the workload's default initial condition (must match
    ``signature.shape``/``dtype``).  ``ckpt_every > 0`` snapshots resident
    state every that many steps under ``ckpt_key`` (defaults to the request
    id) — and ``resume=True`` starts from the newest such snapshot instead
    of step 0, which is how a killed worker's solve is carried forward by a
    fresh service instance.
    """

    signature: PlanSignature
    steps: int
    init: Optional[np.ndarray] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    ckpt_every: int = 0
    ckpt_key: Optional[str] = None
    resume: bool = False
    request_id: str = dataclasses.field(default_factory=lambda: _next_id("step"))

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError(f"steps must be >= 1; got {self.steps}")
        if self.ckpt_every < 0:
            raise ValueError(f"ckpt_every must be >= 0; got {self.ckpt_every}")
        if self.resume and not self.ckpt_key:
            raise ValueError("resume=True requires an explicit ckpt_key")
        if self.ckpt_every > 0 and self.signature.batch > 1:
            raise ValueError(
                "checkpointing batched signatures is not supported; "
                "submit members individually to checkpoint them"
            )
        _check_init(self.init, self.signature)


@dataclasses.dataclass
class SolveRequest:
    """Solve a registered implicit workload to convergence."""

    signature: PlanSignature
    method: str = "cg"
    tol: float = 1e-6
    maxiter: int = 200
    init: Optional[np.ndarray] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    request_id: str = dataclasses.field(default_factory=lambda: _next_id("solve"))

    def __post_init__(self):
        if self.maxiter < 1:
            raise ValueError(f"maxiter must be >= 1; got {self.maxiter}")
        _check_init(self.init, self.signature)


class Ticket:
    """A thread-safe future for one submitted request.

    ``result(timeout)`` blocks for the final field data (re-raising the
    request's failure); ``stats`` is the :class:`RequestStats` record and
    is populated whether the request completed, failed or expired.
    """

    def __init__(self, request):
        self.request = request
        self.stats = RequestStats(
            request_id=request.request_id, signature=request.signature.key()
        )
        self._done = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    # -- producer side (service worker) -------------------------------------
    def _resolve(self, value) -> None:
        self._value = value
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._done.set()

    # -- consumer side -------------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.request_id} still pending "
                f"after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._value

    def error(self) -> Optional[BaseException]:
        return self._error if self._done.is_set() else None
