"""``Ensemble`` — B scenarios of one program behind one kernel launch.

The port of ``repro/core/ensemble.py``.  An ensemble is one recorded
:class:`Program` plus per-member ``(B, X, Y, Z)`` *overrides* for the fields
that differ between members (initial states, coefficient sets).  ``make``
and ``solve`` accept an ``Ensemble`` transparently: the engine plans the
program once with ``RunOptions(batch=B)``, every field tensor carries the
leading member axis, and each K1 launch (or masked Krylov iteration)
advances all B members (see :mod:`repro_torch.engine.plan` and
:mod:`repro_torch.solver.krylov`).

Two ways to build one:

* **parameter sweep** — record once, override the varying fields::

      wse, T, C = record_varcoef_btcs(T0, C0, w)
      ens = Ensemble(wse.program, T, overrides={C.name: stacked_coeffs})

* **stacked programs** — record each member separately and stack them;
  :meth:`Ensemble.from_programs` checks that the recordings are
  structurally identical (same ops, loops, shapes: they share one kernel)
  and turns whichever init data differs into overrides:

>>> import numpy as np
>>> from repro_torch.core import Field, ForLoop, WFAInterface
>>> from repro_torch.engine import RunOptions
>>> def member(v):  # the `with` exit releases the recording, so members
...     with WFAInterface() as wse:  # can be recorded back to back
...         T = Field("T", init_data=np.full((6, 6, 4), v, np.float32))
...         with ForLoop("t", 2):
...             T[1:-1, 0, 0] = 0.5 * T[1:-1, 0, 0]
...     return wse, T
>>> ens = Ensemble.from_programs([member(1.0), member(2.0), member(4.0)])
>>> ens.batch
3
>>> out = ens.make(options=RunOptions(backend="pallas", device="cpu"))
>>> out.shape
(3, 6, 6, 4)
>>> [float(out[b, 2, 2, 1]) for b in range(3)]
[0.25, 0.5, 1.0]
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.program import Program, WFAInterface, release_program


def _loop_sig(loop) -> Optional[Tuple]:
    if loop is None:
        return None
    return (loop.name, loop.n, getattr(loop, "role", None))


def _canonical(program: Program) -> Tuple:
    """Structure of a recording with every per-member *value* stripped out.

    Two programs with equal canonical forms lower to the same IR and so
    share one kernel (only init data may differ): the precondition for
    stacking them into one batched plan.
    """
    fields = tuple(
        (n, tuple(f.shape), np.dtype(f.dtype).name)
        for n, f in sorted(program.fields.items())
    )
    ops = tuple(
        (
            op.field_name,
            _loop_sig(op.loop),
            (op.target_z.start, op.target_z.stop, op.target_z.step),
            op.expr,  # frozen-dataclass tree: structural equality
        )
        for op in program.ops
    )
    return fields, ops


@dataclasses.dataclass(frozen=True)
class Ensemble:
    """One program, B members: per-member field stacks over one recording.

    ``overrides`` maps field names to ``(B, X, Y, Z)`` stacks; every field
    *not* overridden broadcasts its init data to all members.  ``answer``
    may be a Field or its name.  The ensemble is inert data: it runs
    through :meth:`make` / :meth:`solve` (or the module-level ``make`` /
    ``solve``, which dispatch here).
    """

    program: Program
    answer: object
    overrides: Dict[str, np.ndarray]
    batch: int = 0  # 0 = infer from the overrides' leading axis

    def __post_init__(self):
        release_program(self.program)  # recording is over; members are data
        name = getattr(self.answer, "name", self.answer)
        if name not in self.program.fields:
            raise ValueError(f"answer field {name!r} is not in this program")
        object.__setattr__(self, "answer", name)
        if not self.overrides and not self.batch:
            raise ValueError(
                "pass batch= explicitly when no field is overridden "
                "(an all-identical ensemble has no leading axis to infer B from)"
            )
        b = self.batch
        for n, v in self.overrides.items():
            if n not in self.program.fields:
                raise ValueError(f"override {n!r} is not a field of this program")
            v = np.asarray(v)
            want = self.program.fields[n].shape
            if v.ndim != 4 or v.shape[1:] != tuple(want):
                raise ValueError(
                    f"override {n!r} must be a (B, {want[0]}, {want[1]}, "
                    f"{want[2]}) stack; got {v.shape}"
                )
            if b and v.shape[0] != b:
                raise ValueError(
                    f"override {n!r} has {v.shape[0]} members; expected {b}"
                )
            b = b or v.shape[0]
        object.__setattr__(self, "batch", int(b))
        object.__setattr__(self, "overrides", dict(self.overrides))

    @classmethod
    def from_programs(cls, members, answer=None) -> "Ensemble":
        """Stack separately recorded members into one batched ensemble.

        ``members`` is a sequence of ``(wse, answer_field)`` pairs (what the
        recorder presets return; a bare ``WFAInterface``/``Program`` works
        when ``answer=`` names the unknown).  All recordings must be
        structurally identical (same fields, loops and update expressions),
        since one kernel serves every member; only init data may differ,
        and each differing field becomes a stacked override.
        """
        progs, names = [], []
        for m in members:
            if isinstance(m, tuple):
                obj, ans = m
                names.append(getattr(ans, "name", ans))
            else:
                obj = m
                names.append(getattr(answer, "name", answer))
            progs.append(obj if isinstance(obj, Program) else obj.program)
        if not progs:
            raise ValueError("from_programs needs at least one member")
        if len(set(names)) != 1 or names[0] is None:
            raise ValueError(
                f"members disagree on the answer field: {sorted(set(map(str, names)))}"
            )
        ref = _canonical(progs[0])
        for i, p in enumerate(progs[1:], start=1):
            if _canonical(p) != ref:
                raise ValueError(
                    f"member {i} records a structurally different program "
                    "(ops/loops/field shapes must match to share one "
                    "batched kernel); only init data may vary"
                )
        overrides = {}
        for n in progs[0].fields:
            datas = [np.asarray(p.fields[n].init_data) for p in progs]
            if any(not np.array_equal(d, datas[0]) for d in datas[1:]):
                overrides[n] = np.stack(datas)
        return cls(program=progs[0], answer=names[0], overrides=overrides,
                   batch=len(progs))

    def stacked_env(self) -> Dict[str, np.ndarray]:
        """Every field as a ``(B, X, Y, Z)`` stack (overrides verbatim, the
        rest broadcast from init data)."""
        env = {}
        for n, f in self.program.fields.items():
            if n in self.overrides:
                env[n] = np.asarray(self.overrides[n])
            else:
                d = np.asarray(f.init_data)
                env[n] = np.broadcast_to(d, (self.batch,) + d.shape).copy()
        return env

    def _options(self, options):
        from repro_torch.engine.options import resolve_options

        options = resolve_options(options, "Ensemble")
        if options.batch not in (1, self.batch):
            raise ValueError(
                f"options.batch={options.batch} conflicts with this "
                f"ensemble's {self.batch} members"
            )
        return options.replace(batch=self.batch)

    def make(self, options=None) -> np.ndarray:
        """Run the explicit program for all members in one batched plan;
        returns the answer as a ``(B, X, Y, Z)`` stack.  A one-member
        ensemble runs the single plan and keeps the member axis."""
        from repro_torch.engine import run_program

        env = self.stacked_env()
        options = self._options(options)
        if self.batch == 1:
            out = run_program(self.program, env={n: v[0] for n, v in env.items()},
                              options=options)
            return np.asarray(out[self.answer])[None]
        out = run_program(self.program, env=env, options=options)
        return np.asarray(out[self.answer])

    def solve(self, options=None, member_env=None, **kwargs):
        """Solve the recorded implicit system for all members in one masked
        Krylov loop (see :func:`repro_torch.solver.solve`); per-member
        stacks for the guess and coefficients come from the overrides
        (``member_env=`` entries take precedence)."""
        from repro_torch.solver.api import solve as _solve

        env = dict(self.overrides)
        env.update(member_env or {})
        options = self._options(options)
        if self.batch > 1:
            return _solve(self.program, self.answer, options=options,
                          member_env=env, **kwargs)
        res = _solve(self.program, self.answer, options=options,
                     member_env={n: np.asarray(v)[0] for n, v in env.items()},
                     **kwargs)
        if not kwargs.get("return_info"):
            return res[None]
        x, info = res
        for key in ("iterations", "residual", "outcomes"):
            setattr(info, key, np.asarray(getattr(info, key))[:, None])
        return x[None], info


def _maybe_program(target) -> Optional[Program]:
    if isinstance(target, Program):
        return target
    prog = getattr(target, "program", None)
    return prog if isinstance(prog, Program) else None


def make(target, answer=None, options=None) -> np.ndarray:
    """Module-level ``make``: Ensemble-aware explicit execution.

    ``make(ensemble)`` runs every member in one batched plan and returns the
    ``(B, X, Y, Z)`` stack; ``make(wse_or_program, answer)`` is the
    single-scenario entry (``wse.make(answer, ...)``), returning ``answer``'s
    final value as a host NumPy array.
    """
    if isinstance(target, Ensemble):
        if answer is not None:
            raise ValueError("an Ensemble already carries its answer field")
        return target.make(options=options)
    prog = _maybe_program(target)
    if prog is None:
        raise TypeError(
            f"make() expects an Ensemble, WFAInterface or Program; "
            f"got {type(target).__name__}"
        )
    name = getattr(answer, "name", answer)
    if name is None:
        release_program(prog)
        raise ValueError("make(program, answer) needs the answer field")
    if isinstance(target, WFAInterface):
        return target.make(answer=prog.fields[name], options=options)
    from repro_torch.engine import run_program

    try:
        out = run_program(prog, options=options)
    finally:
        release_program(prog)
    return np.asarray(out[name])


def solve(target, answer=None, **kwargs):
    """Module-level ``solve``: Ensemble-aware implicit solves.

    ``solve(ensemble, ...)`` runs one masked batched Krylov loop over all
    members; ``solve(wse_or_program, answer, ...)`` is the single-scenario
    entry of :func:`repro_torch.solver.solve`.
    """
    if isinstance(target, Ensemble):
        if answer is not None:
            raise ValueError("an Ensemble already carries its answer field")
        return target.solve(**kwargs)
    prog = _maybe_program(target)
    if prog is None:
        raise TypeError(
            f"solve() expects an Ensemble, WFAInterface or Program; "
            f"got {type(target).__name__}"
        )
    from repro_torch.solver.api import solve as _solve

    try:
        return _solve(prog, answer, **kwargs)
    finally:
        release_program(prog)
