"""K1 — the fused stencil of one loop body, on Hopper.

The port of ``repro/kernels/fused.py::build_fused_call``.  The Pallas body
there is unrolled in Python for each tap set; here one CUDA kernel
(``csrc/fused_stencil.cu``, built for ``sm_90a`` at first use) reads the
same structure from a descriptor that :func:`build_fused_call` flattens
from the lowered updates:

* per update: the written field, ``z0``, ``zlen``, ``const``, and its
  coefficient groups — taps sharing a coefficient, in first-appearance
  order, each a list of products of 1–2 taps ``(field, dz, dx, dy)``;
* per tap, whether it reads a field an earlier update of the body already
  wrote (the block-local centre value, ``dx == dy == 0`` by lowering).

The descriptor is uploaded once per kernel-cache entry (the ``_get_kernel``
signature of :mod:`repro_torch.compiler.codegen`) and copied into shared
memory by every block.  Two modes are ported:

* padded (``margin=0``): inputs are the ``(bx + 2kh, by + 2kh, nz)``
  wrap-padded window, outputs fresh ``(bx, by, nz)`` tensors;
* margin (``margin=M ≥ k·h``, the halo-resident layout of
  :mod:`repro_torch.engine.layout`): inputs are resident buffers of extent
  ``(bx + 2M, by + 2M, nz)`` whose depth-``k·h`` window starts at
  ``M − k·h``, and the written fields land at offset ``M`` of
  caller-supplied output buffers of the same extent.  An output buffer is
  never an input: the reference's in-place ``input_output_aliases`` is
  valid only while blocks run one at a time, and on the card they do not,
  so the engine ping-pongs two resident buffers per written field.

Both modes launch the column entry (``fused_column_kernel``), one sub-step
over a region per launch, through one of two routes that
:func:`fused_entry` names:

* ``"k1"`` — once over the brick, for ``k == 1``: every ``make`` step at
  ``time_tile=1`` and every solver operator application.  Each block owns
  whole z columns of a ``(BZ, BY)`` thread block, laid out by
  :func:`k1_launch_shape`, with no division per cell and no scratch;
* ``"sweep"`` — k times, for ``k > 1`` (``make``'s auto pick): sub-step
  ``s`` over region ``s`` of the trapezoid, as :func:`sweep_geoms` lays
  out, from and into two full-extent scratch buffers per written field
  that the kernel holds from its first launch on; one C call enqueues the
  k launches.

A body with a hazard — an update that re-writes a field already written in
the sub-step while reading that field's new value at ``dz ≠ 0`` — takes the
same routes through the kernel's hazard instantiation, which computes such
an update's new z window into a shared-memory stage of
:func:`hazard_stage_bytes` before storing any of it.  A body whose stage
and descriptor pass :data:`MAX_SHARED_BYTES` is refused at build.

Members: a kernel built with ``batch=B > 1`` takes every input and output
as a ``(B, …)`` stack of the shapes above (an ensemble, one member per
leading index) and one launch advances all B members: the column entry's
member instantiation runs grid z = B, one member per block, each block's
field pointers moved by whole members (a kernel for one member keeps the
code without the offset).  Each member's cells are computed as a single
launch computes them, so a batched launch equals B single launches bit for
bit.

Region mode (the exchange/compute overlap's interior launch): a margin-mode
kernel built with ``region=RegionSpec(x0, y0, rx, ry)`` evaluates only that
rectangle of the brick.  Its buffers keep the brick's resident extent; the
launch's regions (every sub-step of the sweep's trapezoid) take the
region's extent, their read windows and destinations move by the region's
origin, and the caller adds the origin to ``coords`` so the Moat stays
global.  The CUDA ``Geom`` has one window and one destination offset for x
and y, so the origin must be diagonal (``x0 == y0``, as the interior's
``(k·h, k·h)`` is); the kernel's device code is the same.  The overlap's
four shells are padded-mode launches at their own extents, into fresh
outputs or caller-held ``out=`` buffers of the shell's extent.

Entry points:

* :func:`launch_fused` launches the column entry on CUDA tensors and
  counts its launches in ``launch_fused.launches`` (both modes, every
  route), ``launch_fused.margin_launches`` (the margin mode's share),
  ``launch_fused.k1_launches`` (the k = 1 route's share),
  ``launch_fused.sweep_launches`` (the sweep's share, one per k-step
  launch), ``launch_fused.sweep_substeps`` (the sweep's column-entry
  launches, k per sweep), ``launch_fused.hazard_launches`` (the share of
  hazard bodies, either route), ``launch_fused.batch_launches`` (the
  share of kernels built for ``batch > 1``, either route),
  ``launch_fused.brick_launches`` (the share of kernels built for a
  mesh's bricks, ``wrap=False``, either route) and
  ``launch_fused.region_launches`` (the share of region kernels, the
  overlap's interior launches);
* :func:`fused_step_ref` is the plain PyTorch version: the same trapezoid,
  the same Moat mask and the same association, over the whole window at
  once.  The CPU path and the tests use it;
* :func:`fused_sweep_ref` is the plain version of the sweep's schedule
  (one sub-step per :func:`sweep_geoms` entry, through full-extent
  scratch), which the tests hold against :func:`fused_step_ref`;
* :func:`repro_torch.kernels.ops.fused_step` picks between the launcher and
  :func:`fused_step_ref` by the tensors' device.

Bound on the card: bytes (each input's window read once, each output
written once per launch); see the note in the CUDA source.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import itertools
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

#: fields one fused body may touch (the kernel's pointer tables)
MAX_FIELDS = 16
#: shared-memory budget for the descriptor (ints + doubles), bytes
MAX_DESC_BYTES = 40 * 1024
#: the column entry's dynamic shared memory (coefficients, descriptor and
#: hazard stage): an H100 block's 227 KB less 1 KB for its static arrays
MAX_SHARED_BYTES = 227 * 1024 - 1024
#: threads per block
THREADS = 256
#: the dtypes the kernel is built for
DTYPES = (torch.float32, torch.float64)
#: z cells one thread of the column entry evaluates at once (``kK1Cells`` in
#: the CUDA source)
K1_CELLS = 4
#: CUDA's limits on gridDim.x and on gridDim.y (the column entry's x extent)
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535

#: CUDA's limit on gridDim.z, the members of one launch
MAX_BATCH = 65535

#: one launch's geometry, the CUDA source's ``Geom`` field for field:
#: ``bx, by`` and ``cx, cy`` are the region's extent and global origin,
#: ``in_off`` the origin of its ``h``-deep read window in the inputs,
#: ``out_off, out_py`` where it lands in its destination, ``in_px`` and
#: ``out_px`` the x extents of the input and destination buffers (one
#: member's extent, with the row strides ``in_py``, ``out_py``).  ``k``,
#: ``max_nz`` and the two tile fields are unused; they keep their places
#: in the kernel's parameters
Geom = collections.namedtuple(
    "Geom", "bx by nx ny cx cy k h wrap in_px out_px tiles_x tiles_y n_ints "
            "n_coefs max_nz in_off in_py out_off out_py")


@dataclasses.dataclass(eq=False)
class FusedKernel:
    """One built fused kernel: its descriptor and launch geometry."""

    updates: Tuple
    in_names: Tuple[str, ...]
    written: Tuple[str, ...]
    nz: Tuple[int, ...]              # per input field, in_names order
    dtype: torch.dtype
    halo: int
    k: int
    bx: int
    by: int
    nx: int
    ny: int
    wrap: bool
    ints: Tuple[int, ...]
    coefs: Tuple[float, ...]
    hazard: bool
    device: torch.device
    margin: int = 0                  # resident margin M; 0: padded mode
    batch: int = 1                   # members per launch (leading axis if > 1)
    #: the brick rectangle a margin-mode launch covers (``x0, y0, rx, ry``,
    #: a :class:`repro_torch.compiler.ir.RegionSpec`); None: the brick
    region: Optional[object] = None
    ints_dev: Optional[torch.Tensor] = None
    coefs_dev: Optional[torch.Tensor] = None
    #: what the launcher keeps between launches: the sweep's geometry by
    #: brick coords, and its scratch buffers (not copied by
    #: ``dataclasses.replace``)
    held: dict = dataclasses.field(default_factory=dict, init=False,
                                   repr=False)

    @property
    def pad(self) -> int:
        """Depth ``k·h`` of the window every launch reads around the brick."""
        return self.k * self.halo

    @property
    def extent(self) -> Tuple[int, int]:
        """(X, Y) extent of the inputs: the padded window, or the resident
        buffer in margin mode (which the outputs share)."""
        d = 2 * (self.margin or self.pad)
        return self.bx + d, self.by + d

    @property
    def span(self) -> Tuple[int, int]:
        """(X, Y) extent of the cells a launch writes: the region's, or the
        brick's."""
        r = self.region
        return (self.bx, self.by) if r is None else (r.rx, r.ry)

    @property
    def origin(self) -> int:
        """The region's origin in the brick, x and y alike (0 without a
        region)."""
        return 0 if self.region is None else self.region.x0

    def stacked(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """``shape`` with the member axis in front when ``batch > 1``."""
        return (self.batch,) + tuple(shape) if self.batch > 1 else tuple(shape)


def _encode(updates, in_names, nz_of):
    """Flatten the updates into the kernel's int / double descriptor.

    ints: ``[n_updates]`` then per update ``[field, z0, zlen, nz,
    first_write, hazard, n_groups, coef_base, next_update]`` followed by,
    per group, ``[n_products]`` and per product ``[n_taps]`` + ``n_taps``
    taps of ``[field, dz, dx, dy, from_center]``.  coefs: per update its
    ``const`` then one coefficient per group.
    """
    idx = {n: i for i, n in enumerate(in_names)}
    ints = [len(updates)]
    coefs = []
    center = set()
    any_hazard = False
    for u in updates:
        groups: Dict[float, list] = {}
        for coeff, taps in u.terms:
            groups.setdefault(coeff, []).append(taps)
        first = u.field not in center
        hazard = (not first) and any(
            t.field == u.field and t.dz != 0 for t in u.taps())
        any_hazard = any_hazard or hazard
        head = len(ints)
        ints += [idx[u.field], u.z0, u.zlen, nz_of[u.field], int(first),
                 int(hazard), len(groups), len(coefs), 0]
        coefs.append(float(u.const))
        for coeff, prods in groups.items():
            coefs.append(float(coeff))
            ints.append(len(prods))
            for taps in prods:
                ints.append(len(taps))
                for t in taps:
                    ints += [idx[t.field], t.dz, t.dx, t.dy,
                             int(t.field in center)]
        ints[head + 8] = len(ints)
        center.add(u.field)
    return tuple(ints), tuple(coefs), any_hazard


def fused_entry(kernel: FusedKernel) -> str:
    """The route that serves ``kernel``'s launches, with or without a
    hazard: ``"k1"`` (the column entry once) for ``k == 1``, ``"sweep"``
    (the column entry k times) for ``k > 1``."""
    return "k1" if kernel.k == 1 else "sweep"


def k1_block(max_nz: int) -> Tuple[int, int]:
    """``(BZ, BY)``, the column entry's block for fields of at most
    ``max_nz`` z cells: ``BZ = min(128, ⌈max_nz / K1_CELLS⌉ rounded up to
    32)`` threads along z, ``BY = THREADS // BZ`` columns."""
    per_thread = -(-max_nz // K1_CELLS)
    bz = min(128, -(-per_thread // 32) * 32)
    return bz, THREADS // bz


def hazard_stage_bytes(kernel: FusedKernel, block_y: int) -> int:
    """Bytes of the hazard instantiation's shared-memory stage for blocks
    of ``block_y`` columns: ``block_y`` × the largest ``zlen`` of the body's
    hazard updates, in the kernel's dtype; 0 for a body without a hazard.
    Read from the descriptor, as the CUDA side checks it."""
    ints, zmax, pos = kernel.ints, 0, 1
    for _ in range(ints[0]):
        if ints[pos + 5]:
            zmax = max(zmax, ints[pos + 2])
        pos = ints[pos + 8]
    itemsize = torch.finfo(kernel.dtype).bits // 8
    return block_y * zmax * itemsize


def column_shared_bytes(kernel: FusedKernel, block_y: int) -> int:
    """Dynamic shared memory of one column-entry block: the coefficients as
    double and as the dtype and the descriptor, then (hazard bodies) the
    stage at the next 16 bytes (``stage_offset`` in the CUDA source)."""
    itemsize = torch.finfo(kernel.dtype).bits // 8
    head = len(kernel.coefs) * (8 + itemsize) + 4 * len(kernel.ints)
    if not kernel.hazard:
        return head
    return -(-head // 16) * 16 + hazard_stage_bytes(kernel, block_y)


def k1_launch_shape(kernel: FusedKernel,
                    extent: Optional[Tuple[int, int]] = None
                    ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``((grid_x, grid_y), (BZ, BY))`` of one column-entry launch over a
    region of ``extent`` (default: the brick, the k = 1 launch).

    A block is ``BZ × BY ≤ THREADS`` threads, ``BZ = min(128, ⌈max nz /
    K1_CELLS⌉ rounded up to 32)`` and ``BY = THREADS // BZ``; ``grid_y = rx``
    blocks give x, ``grid_x = ceil(ry / BY)`` give y (``blockIdx.x·BY +
    threadIdx.y``), and each thread walks ``z = threadIdx.x, +BZ, …``,
    ``K1_CELLS`` of them at once — K6's ``shape_for`` with the z blocks
    folded into that walk.  Default extent: the cells a launch writes
    (:attr:`FusedKernel.span`; a 1-wide region is a grid of one x).
    Raises ``ValueError`` for an empty region or a grid over CUDA's limits.
    """
    rx, ry = extent or kernel.span
    bz, by_threads = k1_block(max(kernel.nz))
    grid = (-(-ry // by_threads), rx)
    if (rx < 1 or ry < 1 or min(kernel.nz) < 1
            or grid[0] > MAX_GRID_X or grid[1] > MAX_GRID_Y):
        raise ValueError(
            f"region {rx}×{ry}×{max(kernel.nz)} is empty or over the column "
            f"entry's grid limits ({MAX_GRID_X}, {MAX_GRID_Y})")
    return grid, (bz, by_threads)


def _origins(kernel: FusedKernel) -> Tuple[int, int, int, int]:
    """``(in_off, out_off, out_px, out_py)``: the window's origin in the
    inputs, and the brick's origin and x extent and row stride in the
    outputs."""
    M = kernel.margin
    if M:
        return (M - kernel.pad, M) + kernel.extent
    return 0, 0, kernel.bx, kernel.by


def sweep_geoms(kernel: FusedKernel, coords: Tuple[int, int] = (0, 0)
                ) -> Tuple[Geom, ...]:
    """One :data:`Geom` per sub-step of the column entry's sweep (one at
    k = 1: the brick).

    Sub-step ``s`` evaluates region ``s`` of the trapezoid: extent ``(bx +
    2r, by + 2r)`` with ``r = (k − s − 1)·h``, global origin ``coords −
    r``, read window at ``in_off + s·h`` of the inputs (both modes).  It
    writes the scratch buffers, which share the inputs' extent and row
    stride, at the region's own place in the window (``in_off + (s+1)·h``),
    and at ``s = k − 1`` the outputs at the brick's origin.  The geometry is
    one member's: a batched launch runs it on every member.  A region
    kernel runs the same trapezoid over its region: extents from the
    region's, read windows and destinations moved by its origin (in the
    inputs, the scratch and the outputs alike); ``coords`` is then the
    region's global origin.
    """
    k, h = kernel.k, kernel.halo
    in_off, out_off, out_px, out_py = _origins(kernel)
    o = kernel.origin
    in_off, out_off = in_off + o, out_off + o
    rx, ry = kernel.span
    ex, ey = kernel.extent
    cx, cy = int(coords[0]), int(coords[1])
    geoms = []
    for s in range(k):
        r = (k - s - 1) * h
        last = s == k - 1
        geoms.append(Geom(
            bx=rx + 2 * r, by=ry + 2 * r, nx=kernel.nx,
            ny=kernel.ny, cx=cx - r, cy=cy - r, k=1, h=h,
            wrap=int(kernel.wrap), in_px=ex, out_px=out_px if last else ex,
            tiles_x=0, tiles_y=0,
            n_ints=len(kernel.ints), n_coefs=len(kernel.coefs),
            max_nz=max(kernel.nz), in_off=in_off + s * h, in_py=ey,
            out_off=out_off if last else in_off + (s + 1) * h,
            out_py=out_py if last else ey))
    return tuple(geoms)


def build_fused_call(updates: Sequence, field_specs: Dict[str, Tuple[int, object]],
                     halo: int, bx: int, by: int, nx: int, ny: int,
                     time_tile: int = 1, wrap: bool = False, *, device,
                     margin: int = 0, batch: int = 1, region=None):
    """Build the fused kernel for one loop body.

    ``updates``     — :class:`repro_torch.compiler.ir.AffineUpdate`s, in
                      program order.
    ``field_specs`` — ordered ``name -> (nz, torch dtype)`` for every field
                      the body reads or writes; all share the brick extent
                      (bx, by) and one dtype (float32 or float64).
    ``bx, by``      — brick extent; ``nx, ny`` — global extent for the Moat.
    ``time_tile``   — sub-steps fused per launch (k); inputs carry ``k·halo``
                      margins.  ``wrap`` marks wrap-pad margins so the
                      per-sub-step Moat mask wraps coordinates.
    ``device``      — where the kernel runs (required: no default, so a
                      caller cannot build for the host by leaving it out);
                      on a CUDA device the descriptor is uploaded now.
    ``margin``      — the halo-resident mode: inputs and outputs at the
                      resident extent ``(bx + 2M, by + 2M, nz)`` with
                      ``M >= k·halo`` (see the module docstring); 0 keeps
                      the padded → fresh-output mode.
    ``batch``       — members per launch: ``B > 1`` takes every input and
                      output as a ``(B, …)`` stack (one grid z per member).
    ``region``      — a :class:`repro_torch.compiler.ir.RegionSpec` windowing
                      a margin-mode launch to that rectangle of the brick
                      (see the module docstring); the caller adds its
                      origin to ``coords``.

    Returns ``(kernel, written)``: the :class:`FusedKernel` to pass to
    :func:`repro_torch.kernels.ops.fused_step` and the written fields in
    first-written order.  Raises ``ValueError``, on every device and before
    touching CUDA, for a body outside the kernel's limits: another dtype
    than float32/float64, more than one dtype, more than ``MAX_FIELDS``
    fields, a descriptor over ``MAX_DESC_BYTES``, or a hazard body whose
    stage and descriptor pass ``MAX_SHARED_BYTES``
    (:func:`column_shared_bytes`); for a margin below ``k·halo`` or a
    ``batch`` outside ``[1, MAX_BATCH]``; and for a ``region`` without a
    margin, outside the brick, or with ``x0 != y0`` (a gap of the port:
    split x/y offsets wait for a caller that needs them).
    """
    if margin and margin < time_tile * halo:
        raise ValueError(
            f"resident margin {margin} < window halo {time_tile * halo}")
    if region is not None:
        if not margin:
            raise ValueError("region windowing requires resident margin mode")
        if region.x0 != region.y0:
            raise ValueError(f"region origin ({region.x0}, {region.y0}) is not "
                             "diagonal; the port's K1 takes x0 == y0 only")
        if not (0 <= region.x0 and region.rx >= 1 and region.ry >= 1
                and region.x0 + region.rx <= bx
                and region.y0 + region.ry <= by):
            raise ValueError(f"region {region} leaves the ({bx}, {by}) brick")
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"batch {batch} outside [1, {MAX_BATCH}]")
    in_names = tuple(field_specs)
    written = []
    for u in updates:
        if u.field not in written:
            written.append(u.field)
    nz_of = {n: int(s[0]) for n, s in field_specs.items()}
    dtypes = {s[1] for s in field_specs.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPES:
        raise ValueError(
            f"the fused kernel takes one dtype of {DTYPES} per body; got "
            f"{sorted(str(d) for d in dtypes)}")
    if len(in_names) > MAX_FIELDS:
        raise ValueError(f"{len(in_names)} fields > {MAX_FIELDS} per body")
    ints, coefs, hazard = _encode(tuple(updates), in_names, nz_of)
    desc_bytes = 4 * len(ints) + 8 * len(coefs)
    if desc_bytes > MAX_DESC_BYTES:
        raise ValueError(
            f"loop body descriptor is {desc_bytes} bytes > {MAX_DESC_BYTES} "
            f"(shared-memory budget)")
    device = torch.device(device)
    kern = FusedKernel(
        updates=tuple(updates), in_names=in_names, written=tuple(written),
        nz=tuple(nz_of[n] for n in in_names), dtype=next(iter(dtypes)),
        halo=int(halo), k=int(time_tile), bx=bx, by=by, nx=nx, ny=ny,
        wrap=bool(wrap), ints=ints, coefs=coefs, hazard=hazard,
        device=device, margin=int(margin), batch=int(batch), region=region)
    if hazard:
        smem = column_shared_bytes(kern, k1_block(max(kern.nz))[1])
        if smem > MAX_SHARED_BYTES:
            raise ValueError(
                f"the hazard stage and descriptor take {smem} bytes of shared "
                f"memory > {MAX_SHARED_BYTES} (a hazard update's z window is "
                "too long)")
    if device.type == "cuda" and device.index is None:
        kern.device = device = torch.device("cuda",
                                            torch.cuda.current_device())
    if device.type == "cuda":
        kern.ints_dev = torch.tensor(ints, dtype=torch.int32, device=device)
        kern.coefs_dev = torch.tensor(coefs, dtype=torch.float64, device=device)
    return kern, tuple(written)


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def _scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (the kernel's ``static_cast<T>``), as a
    Python float, so torch's scalar arithmetic sees the same operand."""
    return float(np.float32(v)) if dtype == torch.float32 else float(v)


def _apply_updates(updates, cur, nz_of, h, out_x, out_y, gx0, gy0, nx, ny,
                   wrap):
    """One sub-step over the (out_x, out_y) region (``_apply_updates`` of
    the reference, in torch).

    ``cur`` holds full-Z tensors of extent (out_x + 2h, out_y + 2h); returns
    the post-step dict shrunk to (out_x, out_y).  ``gx0, gy0`` are the global
    coordinates of the output region's origin.
    """
    dev = next(iter(cur.values())).device
    gx = gx0 + torch.arange(out_x, device=dev).view(out_x, 1, 1)
    gy = gy0 + torch.arange(out_y, device=dev).view(1, out_y, 1)
    if wrap:
        gx = torch.remainder(gx, nx)
        gy = torch.remainder(gy, ny)
    interior = (gx > 0) & (gx < nx - 1) & (gy > 0) & (gy < ny - 1)

    def read(tap, u):
        zlo = u.z0 + tap.dz
        if tap.field in center:
            return center[tap.field][:, :, zlo:zlo + u.zlen]
        a = cur[tap.field]
        x0, y0 = h + tap.dx, h + tap.dy
        return a[x0:x0 + out_x, y0:y0 + out_y, zlo:zlo + u.zlen]

    center: Dict[str, torch.Tensor] = {}
    for u in updates:
        nz = nz_of[u.field]
        if u.field in center:
            old = center[u.field]
        else:
            old = cur[u.field][h:h + out_x, h:h + out_y, :]
        dtype = old.dtype
        # taps sharing a coefficient: summed first, multiplied once
        groups: Dict[float, torch.Tensor] = {}
        for coeff, taps in u.terms:
            t = read(taps[0], u)
            for tap in taps[1:]:
                t = t * read(tap, u)
            groups[coeff] = t if coeff not in groups else groups[coeff] + t
        acc = None
        for coeff, t in groups.items():
            if coeff != 1.0:
                t = t * _scalar(coeff, dtype)
            acc = t if acc is None else acc + t
        if acc is None:
            acc = torch.full((out_x, out_y, u.zlen), _scalar(u.const, dtype),
                             dtype=dtype, device=dev)
        elif u.const != 0.0:
            acc = acc + _scalar(u.const, dtype)
        new_z = torch.where(interior, acc, old[:, :, u.z0:u.z0 + u.zlen])
        if u.z0 == 0 and u.zlen == nz:
            center[u.field] = new_z
        else:
            new = old.clone()
            new[:, :, u.z0:u.z0 + u.zlen] = new_z
            center[u.field] = new
    return {name: (center[name] if name in center
                   else a[h:h + out_x, h:h + out_y, :])
            for name, a in cur.items()}


def _check_outputs(kernel: FusedKernel, inputs, out) -> None:
    """The caller's output buffers: one per written field, at the resident
    extent (margin mode, where they are required) or the brick's (padded
    mode, where they are optional), and none sharing storage with an input
    or with another output (the ping-pong guard: the kernel's blocks would
    read cells a neighbouring block already wrote)."""
    if out is None and not kernel.margin:
        return
    if out is None or len(out) != len(kernel.written):
        raise ValueError(f"{'margin mode needs out=' if kernel.margin else 'out='}"
                         f" with one buffer per written field {kernel.written}")
    ex, ey = kernel.extent if kernel.margin else (kernel.bx, kernel.by)
    nz_of = dict(zip(kernel.in_names, kernel.nz))
    for name, o in zip(kernel.written, out):
        want = kernel.stacked((ex, ey, nz_of[name]))
        if tuple(o.shape) != want or o.dtype != kernel.dtype:
            raise ValueError(
                f"output {name!r} is {tuple(o.shape)} {o.dtype}, expected "
                f"{want} {kernel.dtype}")
        if o.device != inputs[0].device or not o.is_contiguous():
            raise ValueError(f"output {name!r} must be contiguous on "
                             f"{inputs[0].device}")
    storages = [t.untyped_storage().data_ptr() for t in inputs]
    seen = set()
    for name, o in zip(kernel.written, out):
        ptr = o.untyped_storage().data_ptr()
        if ptr in storages or ptr in seen:
            raise ValueError(f"output {name!r} shares storage with an input or "
                             "another output; margin mode needs a separate "
                             "(ping-pong) buffer")
        seen.add(ptr)


def _per_member(one, kernel: FusedKernel, inputs, coords, out):
    """``one(kernel, inputs, coords, out)`` for each member of a batched
    kernel's ``(B, …)`` stacks, in turn: margin mode writes each member's
    slice of ``out`` and returns ``out``; padded mode stacks the members'
    fresh outputs."""
    _check_outputs(kernel, inputs, out)
    if kernel.batch == 1:
        return one(kernel, inputs, coords, out)
    for name, t in zip(kernel.in_names, inputs):
        if t.ndim != 4 or t.shape[0] != kernel.batch:
            raise ValueError(f"input {name!r} is {tuple(t.shape)}, not a stack "
                             f"of {kernel.batch} members")
    res = [one(kernel, [t[b] for t in inputs], coords,
               None if out is None else [o[b] for o in out])
           for b in range(kernel.batch)]
    if out is not None:
        return tuple(out)
    return tuple(torch.stack(ts) for ts in zip(*res))


def fused_step_ref(kernel: FusedKernel, inputs: Sequence[torch.Tensor],
                   coords: Tuple[int, int] = (0, 0),
                   out: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of one launch of ``kernel``.

    Padded mode: ``inputs`` are the ``(bx + 2·k·h, by + 2·k·h, nz)`` windows
    in ``kernel.in_names`` order; returns the ``(bx, by, nz)`` written
    fields, fresh or in the ``out`` buffers.  Margin mode: ``inputs`` are
    resident buffers; the window is sliced from offset ``M − k·h``, and the
    written fields land in the interior ``[M:M+bx, M:M+by]`` of the ``out``
    buffers, which are returned (their margins are left as they were); a
    region kernel reads and writes its region's part only.  ``coords`` is
    the global cell origin of the brick (of the region).  The whole window is one block: each output
    cell's arithmetic is the same whichever block computes it, so this
    matches the tiled kernel bit for bit.  A batched kernel's stacks run one
    member at a time.
    """
    return _per_member(_step_member, kernel, inputs, coords, out)


def _step_member(kernel, inputs, coords, out):
    """:func:`fused_step_ref` of one member."""
    k, h = kernel.k, kernel.halo
    rx, ry = kernel.span
    if kernel.margin:
        lo = kernel.margin - kernel.pad + kernel.origin
        wx, wy = rx + 2 * kernel.pad, ry + 2 * kernel.pad
        inputs = [t[lo:lo + wx, lo:lo + wy] for t in inputs]
    cur = dict(zip(kernel.in_names, inputs))
    nz_of = dict(zip(kernel.in_names, kernel.nz))
    gx0 = coords[0] - k * h
    gy0 = coords[1] - k * h
    for s in range(k):
        out_x = rx + 2 * (k - s - 1) * h
        out_y = ry + 2 * (k - s - 1) * h
        gx0 += h
        gy0 += h
        cur = _apply_updates(kernel.updates, cur, nz_of, h, out_x, out_y,
                             gx0, gy0, kernel.nx, kernel.ny, kernel.wrap)
    if out is None:
        return tuple(cur[n].contiguous() for n in kernel.written)
    lo = kernel.margin + kernel.origin if kernel.margin else 0
    for name, o in zip(kernel.written, out):
        o[lo:lo + rx, lo:lo + ry].copy_(cur[name])
    return tuple(out)


def fused_sweep_ref(kernel: FusedKernel, inputs: Sequence[torch.Tensor],
                    coords: Tuple[int, int] = (0, 0),
                    out: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the column entry's sweep schedule: the same
    inputs, outputs and result as :func:`fused_step_ref`, reached the way
    the card reaches it — one sub-step per :func:`sweep_geoms` entry, each
    reading its window at the geometry's origin from the input or from the
    previous sub-step's full-extent scratch and writing its region there.
    Scratch starts as NaN, so a read of a cell no sub-step wrote shows in
    the result.  The tests hold it against :func:`fused_step_ref`; nothing
    on the main path calls it.  A batched kernel's stacks run one member at
    a time.
    """
    return _per_member(_sweep_member, kernel, inputs, coords, out)


def _sweep_member(kernel, inputs, coords, out):
    """:func:`fused_sweep_ref` of one member."""
    h, k = kernel.halo, kernel.k
    nz_of = dict(zip(kernel.in_names, kernel.nz))
    src = dict(zip(kernel.in_names, inputs))
    if out is not None:
        outs = dict(zip(kernel.written, out))
    else:
        outs = {n: inputs[0].new_empty((kernel.bx, kernel.by, nz_of[n]))
                for n in kernel.written}
    scratch = [{n: torch.full_like(src[n], float("nan"))
                for n in kernel.written} for _ in range(min(k - 1, 2))]
    for s, g in enumerate(sweep_geoms(kernel, coords)):
        lo = g.in_off
        cur = {n: a[lo:lo + g.bx + 2 * h, lo:lo + g.by + 2 * h]
               for n, a in src.items()}
        new = _apply_updates(kernel.updates, cur, nz_of, h, g.bx, g.by, g.cx,
                             g.cy, g.nx, g.ny, bool(g.wrap))
        dst = outs if s == k - 1 else scratch[s & 1]
        for n in kernel.written:
            dst[n][g.out_off:g.out_off + g.bx,
                   g.out_off:g.out_off + g.by].copy_(new[n])
        src.update({n: dst[n] for n in kernel.written})
    return tuple(outs[n] for n in kernel.written)


# ---------------------------------------------------------------------------
# the CUDA launcher
# ---------------------------------------------------------------------------

_PTRS = ctypes.c_void_p * MAX_FIELDS
_INTS = ctypes.c_int * MAX_FIELDS
_LIB = None


def _library():
    """The built ``fused_stencil`` library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import load_library

        lib = load_library("fused_stencil")
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        for fn in (lib.fused_sweep_f32, lib.fused_sweep_f64):
            fn.argtypes = [ptrs, ptrs, ptrs, ptrs, ints, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p, ints, ints,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ints,
                           ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.fused_stencil_error.argtypes = [ctypes.c_int]
        lib.fused_stencil_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_inputs(kernel: FusedKernel, inputs) -> torch.device:
    if len(inputs) != len(kernel.in_names):
        raise ValueError(
            f"expected {len(kernel.in_names)} inputs, got {len(inputs)}")
    dev = kernel.device
    ex, ey = kernel.extent
    for name, nz, t in zip(kernel.in_names, kernel.nz, inputs):
        want = kernel.stacked((ex, ey, nz))
        if t.device != dev:
            raise ValueError(f"input {name!r} is on {t.device}, kernel on {dev}")
        if t.dtype != kernel.dtype:
            raise ValueError(f"input {name!r} is {t.dtype}, kernel {kernel.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"input {name!r} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"input {name!r} is not contiguous")
    return dev


def _sweep_held(kernel: FusedKernel, coords: Tuple[int, int]):
    """What the column entry keeps between launches of ``kernel``: the
    ctypes geometry of the brick at ``coords`` with each sub-step's grid,
    the block (:func:`k1_launch_shape` of each region) and the hazard
    stage's bytes (:func:`hazard_stage_bytes`), built at their first
    launch; the host copy of the descriptor, which C checks the stage
    against; and the scratch pointer tables over two buffers per written
    field at the inputs' extent and members (``min(k − 1, 2)`` of them,
    none at k = 1), allocated once (``torch.empty``) and reused by every
    later launch."""
    held = kernel.held
    key = ("geoms", coords, kernel.region)
    if key not in held:
        geoms = sweep_geoms(kernel, coords)
        shapes = [k1_launch_shape(kernel, (g.bx, g.by)) for g in geoms]
        block = shapes[0][1]
        held[key] = ((ctypes.c_int * (len(Geom._fields) * len(geoms)))(
            *itertools.chain.from_iterable(geoms)),
            (ctypes.c_int * (2 * len(geoms)))(
                *itertools.chain.from_iterable(g for g, _ in shapes)),
            block, hazard_stage_bytes(kernel, block[1]))
    if "scratch" not in held:
        ex, ey = kernel.extent
        bufs = [[torch.empty(kernel.stacked((ex, ey, nz)),
                             dtype=kernel.dtype, device=kernel.device)
                 if name in kernel.written and kernel.k > b + 1 else None
                 for name, nz in zip(kernel.in_names, kernel.nz)]
                for b in range(2)]
        held["scratch"] = (bufs, [_PTRS(*[None if t is None else t.data_ptr()
                                          for t in ts]) for ts in bufs])
        held["ints"] = (ctypes.c_int * len(kernel.ints))(*kernel.ints)
    return held[key], held["scratch"][1], held["ints"]


def launch_fused(kernel: FusedKernel, inputs: Sequence[torch.Tensor],
                 coords: Tuple[int, int] = (0, 0),
                 out: Optional[Sequence[torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Launch K1's column entry on CUDA tensors, through the route
    :func:`fused_entry` names (a hazard body through the kernel's hazard
    instantiation).

    Padded mode: returns ``(bx, by, nz)`` outputs (``(B, bx, by, nz)`` for a
    batched kernel, whose inputs are stacks too), fresh, or the caller's
    ``out`` buffers of that shape.  Margin mode: writes the brick interiors
    (a region kernel: its region) of the caller's ``out`` buffers (resident
    extent, no storage shared with an input) and returns them; no output is
    allocated.  Checks device, dtype, shape and contiguity, launches on the
    current stream and raises if a launch was refused.  The sweep's scratch
    is allocated at the kernel's first sweep and held by the kernel (so
    launches of one kernel on two streams at once would race on it); the
    held state is built and each C call enqueued under one process-wide
    lock, so threads launching on one stream (the service's workers)
    enqueue each sweep's sub-steps back to back, and the counters stay
    exact.  The
    k = 1 route also needs the brick (the region) inside the global extent
    (``coords ≥ 0``, ``coords + span ≤ (nx, ny)``), which it checks.  Does
    not synchronise.
    """
    if kernel.device.type != "cuda" or kernel.ints_dev is None:
        raise ValueError(f"kernel was built for {kernel.device}, not CUDA")
    dev = _check_inputs(kernel, inputs)
    _check_outputs(kernel, inputs, out)
    entry = fused_entry(kernel)
    cx, cy = int(coords[0]), int(coords[1])
    rx, ry = kernel.span
    if entry == "k1" and not (0 <= cx and cx + rx <= kernel.nx
                              and 0 <= cy and cy + ry <= kernel.ny):
        raise ValueError(f"brick at {coords} of extent ({rx}, {ry}) leaves "
                         f"the ({kernel.nx}, {kernel.ny}) grid")
    lib = _library()
    k = kernel.k
    if out is not None:
        outs = dict(zip(kernel.written, out))
    else:
        outs = {name: torch.empty(kernel.stacked((kernel.bx, kernel.by, nz)),
                                  dtype=kernel.dtype, device=dev)
                for name, nz in zip(kernel.in_names, kernel.nz)
                if name in kernel.written}
    stream = torch.cuda.current_stream(dev).cuda_stream
    ins = _PTRS(*[t.data_ptr() for t in inputs])
    out_ptrs = _PTRS(*[outs[nm].data_ptr() if nm in outs else None
                       for nm in kernel.in_names])
    fn = (lib.fused_sweep_f32 if kernel.dtype == torch.float32
          else lib.fused_sweep_f64)
    with _LAUNCH_LOCK:
        ((geoms, grids, (bz, bty), stage), (s0, s1),
         host_ints) = _sweep_held(kernel, (cx, cy))
        rc = fn(ins, out_ptrs, s0, s1, _INTS(*kernel.nz),
                len(kernel.in_names), kernel.ints_dev.data_ptr(),
                kernel.coefs_dev.data_ptr(), geoms, grids, k, bz, bty,
                host_ints, int(kernel.hazard), stage, kernel.batch,
                dev.index, stream)
        if rc != 0:
            raise RuntimeError(
                f"fused_stencil {entry} launch failed: "
                f"{lib.fused_stencil_error(rc).decode()} (cudaError {rc})")
        launch_fused.launches += 1
        launch_fused.margin_launches += bool(kernel.margin)
        launch_fused.k1_launches += entry == "k1"
        launch_fused.sweep_launches += entry == "sweep"
        launch_fused.sweep_substeps += k if entry == "sweep" else 0
        launch_fused.hazard_launches += kernel.hazard
        launch_fused.batch_launches += kernel.batch > 1
        launch_fused.brick_launches += not kernel.wrap
        launch_fused.region_launches += kernel.region is not None
    return tuple(outs[nm] for nm in kernel.written)


#: serializes :func:`launch_fused`'s held state, C call and counters
_LAUNCH_LOCK = threading.Lock()


launch_fused.launches = 0
launch_fused.margin_launches = 0
launch_fused.k1_launches = 0
launch_fused.sweep_launches = 0
launch_fused.sweep_substeps = 0
launch_fused.hazard_launches = 0
launch_fused.batch_launches = 0
launch_fused.brick_launches = 0
launch_fused.region_launches = 0
