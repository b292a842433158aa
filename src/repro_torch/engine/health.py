"""Engine-level numerical health: explicit-path ``isfinite`` sentinels.

The port of ``repro/engine/health.py``.  The implicit path classifies
failures *inside* its guarded Krylov loops (:mod:`repro_torch.solver.health`);
an explicit time loop has no residual to watch, so the executor instead
probes field-state finiteness at the chunk granule when
``RunOptions(check_finite=N)`` arms it.  A probe is one ``isfinite``/``all``
reduction per field (per brick on a mesh) and one host read of the verdict,
amortized over N steps (the executor reads it a chunk late, so the card
does not wait for the host); a trip aborts the run with :class:`NumericalFault`
carrying the offending step index plus the last state that passed a probe
(``last_good``).  The reference's probe is an XLA reduction, not a kernel of
its own, so a plain torch reduction is its counterpart.

An env here is name → tensor, name → NumPy array (the ``numpy`` backend),
or name → list of brick tensors (a plan on a mesh).

The failure taxonomy, recovery policy and fault type are shared with the
solver layer; this module re-exports them so engine code has one import
surface.
"""

from __future__ import annotations

import torch

from repro_torch.engine.stats import stats
from repro_torch.solver.health import (  # noqa: F401  (re-exports)
    NumericalFault,
    RecoveryPolicy,
    RecoveryTrace,
)


def _parts(v):
    """The tensors holding one field: its bricks, or the field itself."""
    if isinstance(v, (list, tuple)):
        return [torch.as_tensor(b) for b in v]
    return [torch.as_tensor(v)]


def _finite(v) -> torch.Tensor:
    """0-d bool: every cell of one field (every brick) is finite, on the
    device of its first part.  ``aminmax`` propagates NaN, so both
    extremes are finite exactly when every cell is (the reference's
    ``isfinite``/``all``): one pass over a contiguous part; a strided part
    is reduced along z first, in place (a whole-tensor ``aminmax`` would
    copy it)."""
    parts = _parts(v)
    dev = parts[0].device
    oks = []
    for p in parts:
        if p.ndim and not p.is_contiguous():
            lo, hi = torch.aminmax(p, dim=-1)
            lo, hi = torch.aminmax(lo)[0], torch.aminmax(hi)[1]
        else:
            lo, hi = torch.aminmax(p)
        oks.append((torch.isfinite(lo) & torch.isfinite(hi)).to(dev))
    return oks[0] if len(oks) == 1 else torch.stack(oks).all()


def field_verdicts(env) -> torch.Tensor:
    """1-D bool tensor, one entry per field of ``env`` in its order: the
    field (every brick of it) is all-finite.  On the device of the first
    field; no host read."""
    oks = [_finite(v) for v in env.values()]
    dev = oks[0].device
    return torch.stack([ok.to(dev) for ok in oks])


def probe_ok(env) -> torch.Tensor:
    """0-d bool tensor on the env's device: every buffer in ``env`` is
    all-finite (on a mesh, the AND over every brick — the reference's
    ``pmin``).  No host read."""
    return field_verdicts(env).all()


def probe(env) -> bool:
    """Host-side sentinel: True when every field buffer is finite.

    One host read; counts itself in ``stats.health_probes``.
    """
    stats.health_probes += 1
    return bool(probe_ok(env).item())


def poisoned_fields(env) -> list:
    """Names of the env fields holding non-finite values (one host read)."""
    return [k for k, ok in zip(env, field_verdicts(env).tolist()) if not ok]
