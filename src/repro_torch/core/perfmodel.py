"""Analytic performance models — the paper's equations and the H100 roofline.

Paper equations implemented verbatim (units: iterations/s unless noted):

* Eq. 4/5:   OpenFOAM explicit weak scaling on Joule 2.0
* Eq. 6:     WSE explicit roofline    R_i = F_c / (6.5 W + 78)
* Eq. 11/12: GPU bound  t_min = 8W / w_m ;  R_max = w_m / (8W)
* Eq. 13-15: OpenFOAM implicit weak scaling
* Eq. 16:    WSE CG roofline          R_i = F_c / (10.5 W + 2(X+Y) + 337)
* Eq. 17:    WSE dot product          t = (W + X + Y + 66) / F_c

Card adaptation: the WSE counts cycles because compute, memory and fabric
all run at one cycle per element; an NVIDIA H100 does not, so the analogue
is the three-term roofline  t = max(t_compute, t_memory) + t_collective
(collective unoverlapped, matching Eq. 7's max(comp, comm) + t_b structure),
evaluated from per-step FLOPs / bytes / collective-bytes.  Constants are the
H100 SXM data sheet's: 67 TFLOP/s float32 and 34 TFLOP/s float64 outside
the tensor cores, 3.35 TB/s of HBM3, NVLink at 450 GB/s per direction.

Measured cost model
-------------------

The analytic equations predict *hardware* rates; the planner's tiling and
overlap decisions need the cost of *this* body on *this* device, so the
second half of the module is a measured model: :func:`calibrate` times one
lowered loop body at a few tile factors, fits the two-parameter launch+
throughput line, measures the halo-exchange and boundary-launch overheads,
and stores the result as a :class:`MeasuredCost` in the process-wide
:data:`cost_model` (persistable to a JSON manifest; point
``REPRO_COST_MANIFEST`` at one to pre-load it).  :func:`predict_step_us`
then scores any (brick, k, fused-vs-split) schedule with the Eq. 7
``max(comp, comm) + t_b`` structure, and ``auto_tile`` /
``RunOptions(overlap="auto")`` consume those scores.

Entries are keyed by device tag (:func:`current_device`): ``"cpu"``, where
the kernels run as their plain PyTorch versions, or ``"cuda:"`` and the
card's name.  A CPU calibration therefore never steers a plan on a card,
nor one taken on another card model.  The manifest's layout is the JAX
reference's (schema 1), so either package loads what the other wrote.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.convert import dtype_name

# -- hardware constants ------------------------------------------------------

WSE_CLOCK_HZ = 850e6          # CS-2 nominal fabric clock (used for Eq. 6/16)

H100_SXM_FP32_FLOPS = 67e12   # float32 FLOP/s outside the tensor cores
H100_SXM_FP64_FLOPS = 34e12   # float64 FLOP/s outside the tensor cores
H100_SXM_HBM_BW = 3.35e12     # B/s of HBM3 per card
H100_NVLINK_BW = 450e9        # B/s per direction (900 GB/s both ways)
H100_NVLINK_LAT = 1e-6        # s per transfer (order of magnitude)

#: the device-memory rate and the per-dtype peaks every bound of the port
#: is computed against (``chip_smoke.py``, ``tools/k5_time.py``)
HBM_BYTES_PER_S = H100_SXM_HBM_BW
PEAK_FLOPS = {"float32": H100_SXM_FP32_FLOPS, "float64": H100_SXM_FP64_FLOPS}


# -- paper equations ---------------------------------------------------------

def wse_explicit_rate(W: float, fc: float = WSE_CLOCK_HZ) -> float:
    """Eq. 6 — perfect weak scaling: no dependence on processor count."""
    return fc / (6.5 * W + 78.0)


def wse_implicit_rate(W: float, X: int, Y: int,
                      fc: float = WSE_CLOCK_HZ) -> float:
    """Eq. 16 — CG iteration rate; 2(X+Y) is the dual-reduction latency."""
    return fc / (10.5 * W + 2.0 * (X + Y) + 337.0)


def wse_dot_time(W: float, X: int, Y: int, fc: float = WSE_CLOCK_HZ) -> float:
    """Eq. 17 — one dot product (reduce-to-center + broadcast), seconds."""
    return (W + X + Y + 66.0) / fc


def openfoam_explicit_rate(W: int, n_cells: float) -> float:
    """Eqs. 4–5 — measured Joule 2.0 fits at the two benchmarked workloads."""
    if W == 4096:
        return 1.36e4 - 2.55e-4 * n_cells
    if W == 15625:
        return 4.20e3 - 1.37e-5 * n_cells
    raise ValueError(f"no fit for W={W}")


def openfoam_implicit_rate(W: int, n_cells: float) -> float:
    """Eqs. 13–15."""
    fits = {13824: (3.98e3, 2.75e-5), 21952: (2.45e3, 8.63e-6),
            27000: (2.05e3, 5.66e-6)}
    if W not in fits:
        raise ValueError(f"no fit for W={W}")
    a, b = fits[W]
    return a - b * n_cells


def gpu_max_rate(W: float, mem_bw: float) -> float:
    """Eq. 12 — optimistic single-field bound: R = w_m / (8W) (fp32, D_k=0)."""
    return mem_bw / (8.0 * W)


# -- three-term roofline for the field solver --------------------------------

@dataclasses.dataclass
class StepCost:
    flops: float              # per card per iteration
    hbm_bytes: float          # per card per iteration
    collective_bytes: float   # per card per iteration (over the links)
    hops: int = 1             # link transfers on the critical path


def ftcs_brick_cost(bx: int, by: int, nz: int, dtype_bytes: int = 4,
                    halo_depth: int = 1) -> StepCost:
    """Per-card cost of one FTCS step on a (bx, by, nz) brick.

    8 flops/cell (5 adds for the 6-neighbour sum + fmac + fmul, matching the
    paper's 8-flop count), 2 reads + 1 write per cell through HBM (the
    stencil kernel re-uses neighbours on chip), 4 halo planes of
    ``halo_depth``.
    """
    w = bx * by * nz
    halo = 2 * (bx + by) * nz * halo_depth * dtype_bytes
    return StepCost(flops=8.0 * w,
                    hbm_bytes=2.0 * w * dtype_bytes,
                    collective_bytes=halo,
                    hops=1)


def cg_brick_cost(bx: int, by: int, nz: int, mesh_x: int, mesh_y: int,
                  dtype_bytes: int = 4, fused_reductions: bool = False
                  ) -> StepCost:
    """Per-card cost of one classic-CG iteration (SpMV + 2 axpy + 2 dots)."""
    w = bx * by * nz
    halo = 2 * (bx + by) * nz * dtype_bytes
    n_red = 1 if fused_reductions else 2
    # all-reduce of a scalar: latency-dominated; charge diameter hops
    hops = n_red * 2 * (mesh_x + mesh_y)
    return StepCost(flops=15.0 * w,                    # paper: 15 vs 8 flops
                    hbm_bytes=10.0 * w * dtype_bytes,  # 5 vectors r/p/x/Ap/b
                    collective_bytes=halo + n_red * 8,
                    hops=hops)


def roofline_time(c: StepCost, *, flops_peak: float = H100_SXM_FP32_FLOPS,
                  hbm_bw: float = H100_SXM_HBM_BW,
                  ici_bw: float = H100_NVLINK_BW,
                  hop_lat: float = H100_NVLINK_LAT,
                  overlap_collective: bool = False) -> dict:
    """max(compute, memory) + collective  (Eq. 7 structure on H100 terms).

    ``ici_bw`` / ``hop_lat`` keep the reference's keyword names; their
    defaults are one NVLink direction's rate and latency."""
    t_comp = c.flops / flops_peak
    t_mem = c.hbm_bytes / hbm_bw
    t_coll = c.collective_bytes / ici_bw + c.hops * hop_lat
    if overlap_collective:
        total = max(t_comp, t_mem, t_coll)
    else:
        total = max(t_comp, t_mem) + t_coll
    return {"t_compute": t_comp, "t_memory": t_mem, "t_collective": t_coll,
            "t_total": total, "rate": 1.0 / total,
            "bound": max(("compute", t_comp), ("memory", t_mem),
                         ("collective", t_coll), key=lambda kv: kv[1])[0]}


# -- measured cost model -----------------------------------------------------

#: env var naming a JSON manifest the process-wide model lazily pre-loads
MANIFEST_ENV = "REPRO_COST_MANIFEST"

#: manifest schema version (bump on incompatible entry-field changes)
MANIFEST_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class MeasuredCost:
    """Calibrated cost of one lowered loop body on one device.

    The fitted model is per *tile* (one fused launch advancing ``k`` steps):

        t_tile(k) = launch_us + exchange_us + cell_ns·cells(k) / 1000

    where ``cells(k)`` counts every sub-step output cell of the trapezoid
    (:func:`tile_cells` — the redundant halo recompute is what the model
    trades against the amortized exchange).  ``boundary_us`` is the extra
    fixed overhead of one boundary-shell launch in the overlap split.
    """

    signature: str     # body_signature() this entry was measured for
    device: str        # current_device() tag: "cpu" or "cuda:<card name>"
    cell_ns: float     # fitted per-sub-step-output-cell time
    launch_us: float   # fixed per-tile overhead net of the exchange
    exchange_us: float  # margin refresh / halo exchange per tile
    boundary_us: float  # extra fixed overhead per boundary shell launch

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def current_device(device) -> str:
    """Device tag calibration entries are keyed under, for a torch device.

    ``"cpu"`` on the host, where every kernel runs as its plain PyTorch
    version, so a CPU entry can never steer a plan on a card; ``"cuda:"``
    and the card's name on a card, so an entry measured on another card
    model does not steer this one either.
    """
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return "cuda:" + torch.cuda.get_device_name(index)


def body_signature(group, nz: int, dtype, device) -> str:
    """Stable identity of (lowered body, z extent, dtype, device).

    Hashes the canonical tap form — not the source spelling — so any program
    that lowers to the same :class:`~repro_torch.compiler.ir.LoweredGroup`
    shares one calibration entry.  Brick extent is deliberately *not* part
    of the key: the fitted model is evaluated per brick at plan time, which
    is what lets one calibration serve every decomposition of the same body.
    ``dtype`` may be a torch or a NumPy dtype (both give one key);
    ``device`` is a :func:`current_device` tag (a ``str``) or a torch
    device, whose tag is taken.
    """
    tag = device if isinstance(device, str) else current_device(device)
    key = repr((tuple(group.updates), group.halo, int(nz), dtype_name(dtype),
                tag))
    return hashlib.sha1(key.encode()).hexdigest()[:16]


def tile_cells(brick_xy: Tuple[int, int], nz: int, h: int, k: int) -> int:
    """Sub-step output cells of one monolithic k-tile on a brick.

    Trapezoid blocking: sub-step ``s`` writes the window that still has
    ``(k-1-s)·h`` of shrink left, so the first sub-step is the widest.

    >>> tile_cells((8, 8), 4, 1, 1)   # untiled: just the brick
    256
    >>> tile_cells((8, 8), 4, 1, 2)   # + one 10x10 first sub-step
    656
    """
    return sum((brick_xy[0] + 2 * (k - 1 - s) * h)
               * (brick_xy[1] + 2 * (k - 1 - s) * h)
               for s in range(k)) * nz


def _split_cells(brick_xy, nz: int, h: int, k: int):
    """(interior_cells, shell_cells, n_shells) of the overlap split, or
    ``None`` where the interior would be empty — the same geometry as
    :func:`repro_torch.compiler.ir.split_regions` (depth ``m = k·h``: two
    full-height X slabs plus two X-interior Y strips)."""
    m = k * h
    bx, by = brick_xy
    if m == 0 or bx <= 2 * m or by <= 2 * m:
        return None
    interior = tile_cells((bx - 2 * m, by - 2 * m), nz, h, k)
    shells = (2 * tile_cells((m, by), nz, h, k)
              + 2 * tile_cells((bx - 2 * m, m), nz, h, k))
    return interior, shells, 4


def predict_step_us(cost: MeasuredCost, brick_xy: Tuple[int, int], nz: int,
                    h: int, k: int, split: bool = False) -> float:
    """Model time per *logical step* of one schedule, in microseconds.

    Fused: ``(L + E + c·cells(k)) / k`` — the whole exchange serializes with
    the launch.  Split (Eq. 7's ``max(comp, comm) + t_b``): the exchange
    travels while the interior computes, then the boundary shells pay their
    per-launch overhead::

        (L + max(c·cells_int, E) + n_shells·B + c·cells_shells) / k

    An illegal split (empty interior at depth ``k·h``) scores ``inf`` so it
    can never be selected.
    """
    cells = tile_cells(brick_xy, nz, h, k)
    if not split:
        t = cost.launch_us + cost.exchange_us + cost.cell_ns * cells * 1e-3
        return t / k
    sp = _split_cells(brick_xy, nz, h, k)
    if sp is None:
        return float("inf")
    int_cells, sh_cells, n_sh = sp
    t = (cost.launch_us
         + max(cost.cell_ns * int_cells * 1e-3, cost.exchange_us)
         + n_sh * cost.boundary_us
         + cost.cell_ns * sh_cells * 1e-3)
    return t / k


class CostModel:
    """In-process store of :class:`MeasuredCost` entries, keyed by signature.

    The module-level :data:`cost_model` instance is what the planner
    consults; it lazily merges the manifest named by ``REPRO_COST_MANIFEST``
    on first lookup, so calibration can happen in a separate process and
    steer later runs.
    """

    def __init__(self):
        self.entries: Dict[str, MeasuredCost] = {}
        self._env_loaded = False

    def _maybe_load_env(self) -> None:
        if self._env_loaded:
            return
        self._env_loaded = True
        path = os.environ.get(MANIFEST_ENV)
        if path and os.path.exists(path):
            self.load_manifest(path)

    def put(self, entry: MeasuredCost) -> None:
        self.entries[entry.signature] = entry

    def get(self, signature: str) -> Optional[MeasuredCost]:
        self._maybe_load_env()
        return self.entries.get(signature)

    def lookup(self, group, nz: int, dtype, device) -> Optional[MeasuredCost]:
        """The planner's query: this body's entry for ``device`` (the
        plan's torch device; a mesh's home device)."""
        return self.get(body_signature(group, nz, dtype, device))

    def clear(self) -> None:
        self.entries.clear()
        self._env_loaded = False

    def save_manifest(self, path: str) -> None:
        data = {"schema": MANIFEST_SCHEMA,
                "entries": {s: e.to_json() for s, e in self.entries.items()}}
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)

    def load_manifest(self, path: str) -> int:
        """Merge entries from ``path``; returns how many were loaded."""
        with open(path) as f:
            data = json.load(f)
        if data.get("schema") != MANIFEST_SCHEMA:
            raise ValueError(
                f"cost manifest {path}: schema {data.get('schema')!r} != "
                f"{MANIFEST_SCHEMA}")
        n = 0
        for sig, e in data.get("entries", {}).items():
            self.entries[sig] = MeasuredCost(
                signature=sig, device=e["device"],
                cell_ns=float(e["cell_ns"]),
                launch_us=float(e["launch_us"]),
                exchange_us=float(e["exchange_us"]),
                boundary_us=float(e["boundary_us"]))
            n += 1
        return n


#: process-wide model the planner consults (see :class:`CostModel`)
cost_model = CostModel()


def _fit_line(xs, ys) -> Tuple[float, float]:
    """Least-squares ``y = a·x + b`` with slope clamped non-negative."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx == 0.0:
        return 0.0, my
    a = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    a = max(a, 0.0)
    return a, my - a * mx


def _time_step_us(step, env, device: torch.device, reps: int,
                  inner: int) -> float:
    """Best-of-``reps`` steady-state time of ``env -> env`` in microseconds.

    Chains the env through every call, so what is timed is the executor's
    resident stepping, not a repack.  The clock is the host's, read after
    the device has finished (``torch.cuda.synchronize``, which also waits
    for a split step's side stream): the split step is paced by the host,
    and the model must see that."""
    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    env = step(env)  # build + warm
    wait()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            env = step(env)
        wait()
        best = min(best, (time.perf_counter() - t0) / inner)
    return best * 1e6


def calibrate(ops, shapes: Dict[str, tuple], dtypes: Dict[str, object], *,
              device="cuda", ks: Tuple[int, ...] = (1, 2, 4), reps: int = 3,
              inner: int = 8, model: Optional[CostModel] = None,
              manifest: Optional[str] = None) -> MeasuredCost:
    """Measure one loop body's :class:`MeasuredCost` on ``device`` and store it.

    Times the resident fused step ``step(env, spare)`` at each legal ``k``
    in ``ks`` (steady state, the spares allocated once — the schedule the
    executor actually runs), fits ``t_tile = intercept + slope·cells(k)``,
    measures the margin refresh alone for ``exchange_us``, and one
    overlap-split step to expose the per-shell ``boundary_us``.  The entry
    lands in ``model`` (default: the process-wide :data:`cost_model`) under
    ``device``'s tag and, when ``manifest`` names a path, in that JSON
    manifest too.  ``device`` defaults to the card, which must exist.

    Raises :class:`~repro_torch.compiler.ir.LoweringError` for bodies that
    do not fuse — there is nothing to calibrate for the interpreter path —
    and ``ValueError`` for one outside the fused kernel's limits; neither is
    caught, so a calibration never times the roll interpreter.
    """
    from repro_torch.compiler import lower_group, split_regions
    from repro_torch.compiler.codegen import compile_group
    from repro_torch.convert import torch_dtype
    from repro_torch.engine.layout import HaloLayout, wrap_refresh
    from repro_torch.engine.plan import resolve_device
    from repro_torch.engine.stats import stats

    device = resolve_device(device)
    group = lower_group(ops)
    written = group.fields_written()
    name0 = written[0]
    nx, ny, nz = shapes[name0]
    dtype = dtypes[name0]
    h = group.halo

    legal = [k for k in ks
             if h == 0 or k * h <= min(nx, ny)]
    if not legal:
        legal = [1]

    def timed(step, K: int) -> float:
        """``step``'s time on a zeroed resident env of margin ``K``, with
        one spare per written field held across the calls."""
        env = HaloLayout(pad=K, shapes=shapes).enter(
            {n: torch.zeros(shapes[n], dtype=torch_dtype(dtypes[n]),
                            device=device) for n in shapes})
        if not K:
            return _time_step_us(step, env, device, reps, inner)
        spare = {n: torch.empty_like(env[n]) for n in written}
        return _time_step_us(lambda e: step(e, spare), env, device, reps,
                             inner)

    points = []  # (cells per tile, measured us per tile)
    for k in sorted(set(legal)):
        K = max(k * h, 0)
        step = compile_group(ops, shapes, dtypes, device=device, time_tile=k,
                             group=group, resident=K)
        points.append((tile_cells((nx, ny), nz, h, k), timed(step, K)))

    slope_us, intercept_us = _fit_line([p[0] for p in points],
                                       [p[1] for p in points])
    cell_ns = slope_us * 1e3
    intercept_us = max(intercept_us, 0.0)

    # the exchange alone: the k=1-depth margin refresh on resident buffers
    exchange_us = 0.0
    if h > 0:
        def refresh(env, spare):
            return {n: wrap_refresh(v, h, h) for n, v in env.items()}

        exchange_us = min(timed(refresh, h), intercept_us)
    launch_us = max(intercept_us - exchange_us, 0.0)

    # one split step exposes the per-shell overhead
    boundary_us = launch_us
    k_b = next((k for k in sorted(set(legal), reverse=True)
                if split_regions(group, k, (nx, ny)) is not None), None)
    if k_b is not None:
        int_cells, sh_cells, n_sh = _split_cells((nx, ny), nz, h, k_b)
        K = k_b * h
        step = compile_group(ops, shapes, dtypes, device=device,
                             time_tile=k_b, group=group, resident=K,
                             split=split_regions(group, k_b, (nx, ny)))
        t_split = timed(step, K)
        spent = (launch_us + max(cell_ns * int_cells * 1e-3, exchange_us)
                 + cell_ns * sh_cells * 1e-3)
        boundary_us = max((t_split - spent) / n_sh, 0.0)

    entry = MeasuredCost(
        signature=body_signature(group, nz, dtype, device),
        device=current_device(device),
        cell_ns=cell_ns,
        launch_us=launch_us,
        exchange_us=exchange_us,
        boundary_us=boundary_us,
    )
    if model is None:
        model = cost_model
    model.put(entry)
    stats.calibrations += 1
    if manifest:
        model.save_manifest(manifest)
    return entry


def calibrate_program(program, *, device="cuda",
                      ks: Tuple[int, ...] = (1, 2, 4), reps: int = 3,
                      inner: int = 8, model: Optional[CostModel] = None,
                      manifest: Optional[str] = None
                      ) -> Dict[str, MeasuredCost]:
    """Calibrate every fusible loop body of a recorded program on ``device``.

    Returns ``{first written field: entry}`` per calibrated body; bodies
    that do not lower are skipped (they run on the interpreter, where the
    tiling decision the model steers does not exist).
    """
    from repro_torch.compiler import LoweringError, lower_group
    from repro_torch.core.program import _group_ops

    shapes = {n: f.shape for n, f in program.fields.items()}
    dtypes = {n: f.dtype for n, f in program.fields.items()}
    out: Dict[str, MeasuredCost] = {}
    for loop, ops in _group_ops(program):
        if loop is None:
            continue
        try:
            group = lower_group(ops)
        except LoweringError:
            continue
        entry = calibrate(ops, shapes, dtypes, device=device, ks=ks,
                          reps=reps, inner=inner, model=model,
                          manifest=manifest)
        out[group.fields_written()[0]] = entry
    return out
