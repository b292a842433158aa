"""``RunOptions`` — one frozen bundle for every execution-policy knob.

The port keeps the reference's field names and spellings, so one options
value reads the same in both packages, and adds ``device``: the torch device
the run uses (``"cuda"`` by default; the caller asks for ``"cpu"``
explicitly).

The legacy keywords of ``make`` / ``plan`` still work as thin deprecation
shims: they warn **once per entry point per keyword** and forward into the
options bundle (an explicit legacy keyword overrides the same field of a
passed ``options=``).

>>> opts = RunOptions(backend="pallas", time_tile=4, device="cpu")
>>> opts.time_tile, opts.resident
(4, True)
>>> opts.replace(time_tile=1).time_tile
1
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Set, Tuple


class _Unset:
    """Sentinel distinguishing "not passed" from an explicit ``None``."""

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<unset>"


UNSET = _Unset()

#: (entry point, keyword) pairs that already warned this process
_WARNED: Set[Tuple[str, str]] = set()


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """Execution policy for one plan/run.

    ``backend=None`` means "the entry point's default" (``make`` defaults to
    ``jit``).  ``resident=True`` steps ``backend="pallas"`` plans on the
    halo-resident layout (:mod:`repro_torch.engine.layout`): fields entered
    once per run, margin slabs refreshed in place per launch, K1's outputs
    ping-ponged between two resident buffers per written field.
    ``resident=False`` keeps the repacking step (a wrap pad per launch,
    fresh kernel outputs); both give the same bits.
    ``overlap=True`` splits each fused resident launch into an interior
    launch and four boundary shells, the margin exchange running on a
    second stream meanwhile (bodies without a halo, or bricks without an
    interior at depth ``k·h``, keep the monolithic launch);
    ``overlap="auto"`` splits only where the measured cost model
    (:mod:`repro_torch.core.perfmodel`) holds a calibrated entry for the
    body on the plan's device predicting the split faster, so uncalibrated
    runs keep the monolithic launch; ``overlap=False`` always does.
    ``batch=B`` steps a B-member ensemble: every field buffer carries a
    leading member axis and each K1 launch advances all members
    (:mod:`repro_torch.core.ensemble`).  ``mesh`` (a
    :class:`repro_torch.core.mesh.Mesh`) runs the plan on its bricks, one
    process driving every brick; its bricks' device type must be
    ``device``'s.  ``device`` names the torch device; ``"cuda"`` raises
    when no card is present instead of running elsewhere.
    """

    backend: Optional[str] = None
    mesh: Optional[object] = None
    time_tile: Optional[int] = None
    resident: bool = True
    batch: int = 1
    overlap: object = "auto"
    differentiable: bool = False
    recovery: Optional[object] = None
    check_finite: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if int(self.batch) < 1:
            raise ValueError(f"batch must be >= 1; got {self.batch}")
        object.__setattr__(self, "batch", int(self.batch))
        if self.overlap not in (True, False, "auto"):
            raise ValueError(
                f"overlap must be True, False or 'auto'; got {self.overlap!r}"
            )
        if self.differentiable not in (True, False):
            raise ValueError(
                f"differentiable must be a bool; got {self.differentiable!r}"
            )
        if int(self.check_finite) < 0:
            raise ValueError(
                f"check_finite must be >= 0 (0 disables); got {self.check_finite}"
            )
        object.__setattr__(self, "check_finite", int(self.check_finite))
        if self.mesh is not None:
            from repro_torch.core.mesh import Mesh

            if not isinstance(self.mesh, Mesh):
                raise TypeError(
                    "mesh must be a repro_torch.core.mesh.Mesh (make_mesh); "
                    f"got {type(self.mesh).__name__}")
        if self.recovery is not None:
            from repro_torch.solver.health import RecoveryPolicy

            if not isinstance(self.recovery, RecoveryPolicy):
                raise TypeError(
                    "recovery must be a repro_torch.solver.health."
                    f"RecoveryPolicy; got {type(self.recovery).__name__}")

    def replace(self, **changes) -> "RunOptions":
        """A copy with ``changes`` applied (``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)

    def resolved_backend(self, default: str) -> str:
        return default if self.backend is None else self.backend


def _warn_once(entry: str, kwarg: str, hint: str) -> None:
    key = (entry, kwarg)
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(
        f"{entry}({kwarg}=...) is deprecated; pass "
        f"options=RunOptions({hint}) instead",
        DeprecationWarning,
        stacklevel=4,
    )


def resolve_options(options, entry: str, **legacy) -> RunOptions:
    """Fold an ``options=`` value and legacy keywords into one RunOptions.

    ``legacy`` maps RunOptions field names to the entry point's keyword
    values, with :data:`UNSET` marking "not passed".  Every explicitly
    passed legacy keyword emits one :class:`DeprecationWarning` per entry
    point and overrides the corresponding field of ``options``.  A bare
    string ``options`` is accepted as the backend.
    """
    if options is None:
        options = RunOptions()
    elif isinstance(options, str):
        options = RunOptions(backend=options)
    elif not isinstance(options, RunOptions):
        raise TypeError(
            f"options must be a RunOptions (or backend string); "
            f"got {type(options).__name__}"
        )
    given = {k: v for k, v in legacy.items() if not isinstance(v, _Unset)}
    for k, v in given.items():
        _warn_once(entry, k, f"{k}={v!r}")
    if given:
        options = dataclasses.replace(options, **given)
    return options
