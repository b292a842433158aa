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


class HeldProbe:
    """:func:`probe_ok` with every buffer held: built once for the shapes
    of ``env`` (the fields of a run that steps its buffers in place, as a
    service request's chunks do), it probes any env of those shapes with no
    device allocation — a chunk of the service stays at zero.

    Each part (field or brick) is reduced one trailing axis at a time,
    ``aminmax`` into held extremes: a few hundred inputs per output never
    take PyTorch's cross-block reduction, which allocates its scratch per
    call.  The last stage writes into one held vector of every part's two
    extremes, read to the host in one copy (pinned on the card); the
    verdict is the same as :func:`probe_ok`'s, since ``amin``/``amax``
    propagate NaN like ``aminmax``.
    """

    def __init__(self, env):
        parts = [p for v in env.values() for p in _parts(v)]
        dev = parts[0].device
        dtypes = {p.dtype for p in parts}
        dtype = dtypes.pop() if len(dtypes) == 1 else torch.float64
        self._ends = torch.empty(2 * len(parts), dtype=dtype, device=dev)
        self._host = torch.empty(2 * len(parts), dtype=dtype,
                                 pin_memory=dev.type == "cuda")
        # per part: the held extremes after each trailing axis is reduced;
        # the last stage is two slots of the ends vector (or, for a part of
        # another dtype, two held scalars copied into them)
        self._stages = []
        for i, p in enumerate(parts):
            stages = [(torch.empty(p.shape[:j], dtype=p.dtype, device=p.device),
                       torch.empty(p.shape[:j], dtype=p.dtype, device=p.device))
                      for j in range(p.ndim - 1, -1, -1)]
            if p.dtype == dtype and p.device == dev:
                stages[-1] = (self._ends[2 * i], self._ends[2 * i + 1])
            self._stages.append(stages)

    def __call__(self, env) -> bool:
        """True when every buffer in ``env`` is all-finite; one host read."""
        parts = [p for v in env.values() for p in _parts(v)]
        for i, (p, stages) in enumerate(zip(parts, self._stages)):
            (lo, hi), rest = stages[0], stages[1:]
            torch.aminmax(p, dim=-1, out=(lo, hi))
            for nlo, nhi in rest:
                torch.amin(lo, dim=-1, out=nlo)
                torch.amax(hi, dim=-1, out=nhi)
                lo, hi = nlo, nhi
            if lo.data_ptr() != self._ends[2 * i].data_ptr():
                self._ends[2 * i].copy_(lo)
                self._ends[2 * i + 1].copy_(hi)
        self._host.copy_(self._ends)
        return bool(torch.isfinite(self._host).all())


def probe(env) -> bool:
    """Host-side sentinel: True when every field buffer is finite.

    One host read; counts itself in ``stats.health_probes``.
    """
    stats.health_probes += 1
    return bool(probe_ok(env).item())


def poisoned_fields(env) -> list:
    """Names of the env fields holding non-finite values (one host read)."""
    return [k for k, ok in zip(env, field_verdicts(env).tolist()) if not ok]
