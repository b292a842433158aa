"""K1 — the generic fused stencil for one loop body, on Hopper.

The port of ``repro/kernels/fused.py::build_fused_call``.  The Pallas body
there is unrolled in Python for each tap set; here CUDA kernels
(``csrc/fused_stencil.cu``, built for ``sm_90a`` at first use) read the same
structure from a descriptor that :func:`build_fused_call` flattens from the
lowered updates:

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

Both modes launch one of two CUDA entries, which share one body evaluator
(the association) and so give the same bits; :func:`fused_entry` picks:

* ``"k1"`` (``fused_k1_kernel``) for ``k == 1`` without a hazard — every
  ``make`` step at ``time_tile=1`` and every solver operator application.
  Each block owns whole z columns of a ``(BZ, BY)`` thread block, laid out
  by :func:`k1_launch_shape`, with no division per cell and no scratch;
* ``"generic"`` (``fused_stencil_kernel``) for ``k > 1`` (the trapezoid on
  block-private scratch windows) and for hazard bodies.

The region mode (overlap) and the batch axis (ensembles) come with later
slices.

Three entry points:

* :func:`launch_fused` launches a CUDA entry on CUDA tensors and counts its
  launches in ``launch_fused.launches`` (both modes, both entries),
  ``launch_fused.margin_launches`` (the margin mode's share) and
  ``launch_fused.k1_launches`` (the k = 1 entry's share);
* :func:`fused_step_ref` is the plain PyTorch version: the same trapezoid,
  the same Moat mask and the same association, over the whole window at
  once.  The CPU path and the tests use it;
* :func:`repro_torch.kernels.ops.fused_step` picks between them by the
  tensors' device.

Bound on the card: bytes (each input's window read once, each output
written once per launch); see the note in the CUDA source.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

#: fields one fused body may touch (the kernel's pointer tables)
MAX_FIELDS = 16
#: shared-memory budget for the descriptor (ints + doubles), bytes
MAX_DESC_BYTES = 40 * 1024
#: threads per block
THREADS = 256
#: scratch windows exist for at most this many blocks; a larger grid of
#: tiles is walked by a block-stride loop
MAX_SCRATCH_BLOCKS = 512
#: the dtypes the kernel is built for
DTYPES = (torch.float32, torch.float64)
#: z cells one thread of the k = 1 entry evaluates at once (``kK1Cells`` in
#: the CUDA source)
K1_CELLS = 4
#: CUDA's limits on gridDim.x and on gridDim.y (the k = 1 entry's x extent)
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535


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
    tile: Tuple[int, int]
    ints: Tuple[int, ...]
    coefs: Tuple[float, ...]
    hazard: bool
    device: torch.device
    margin: int = 0                  # resident margin M; 0: padded mode
    ints_dev: Optional[torch.Tensor] = None
    coefs_dev: Optional[torch.Tensor] = None

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


def default_tile(k: int, bx: int, by: int) -> Tuple[int, int]:
    """Output tile of one block of the generic entry: 16×16 at k = 1 (hazard
    bodies), 32×32 when k > 1 (a wider tile keeps the trapezoid's recompute
    share down)."""
    t = 16 if k == 1 else 32
    return min(t, bx), min(t, by)


def fused_entry(kernel: FusedKernel) -> str:
    """The CUDA entry that serves ``kernel``'s launches: ``"k1"`` for
    ``k == 1`` without a hazard, else ``"generic"``."""
    return "k1" if kernel.k == 1 and not kernel.hazard else "generic"


def k1_launch_shape(kernel: FusedKernel
                    ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``((grid_x, grid_y), (BZ, BY))`` of the k = 1 entry.

    A block is ``BZ × BY ≤ THREADS`` threads, ``BZ = min(128, ⌈max nz /
    K1_CELLS⌉ rounded up to 32)`` and ``BY = THREADS // BZ``; ``grid_y = bx``
    blocks give x, ``grid_x = ceil(by / BY)`` give y (``blockIdx.x·BY +
    threadIdx.y``), and each thread walks ``z = threadIdx.x, +BZ, …``,
    ``K1_CELLS`` of them at once — K6's ``shape_for`` with the z blocks
    folded into that walk.  Raises ``ValueError`` for an empty brick or a
    grid over CUDA's limits.
    """
    per_thread = -(-max(kernel.nz) // K1_CELLS)
    bz = min(128, -(-per_thread // 32) * 32)
    by_threads = THREADS // bz
    grid = (-(-kernel.by // by_threads), kernel.bx)
    if (kernel.bx < 1 or kernel.by < 1 or min(kernel.nz) < 1
            or grid[0] > MAX_GRID_X or grid[1] > MAX_GRID_Y):
        raise ValueError(
            f"brick {kernel.bx}×{kernel.by}×{max(kernel.nz)} is empty or "
            f"over the k = 1 entry's grid limits ({MAX_GRID_X}, {MAX_GRID_Y})")
    return grid, (bz, by_threads)


def build_fused_call(updates: Sequence, field_specs: Dict[str, Tuple[int, object]],
                     halo: int, bx: int, by: int, nx: int, ny: int,
                     time_tile: int = 1, wrap: bool = False, *, device,
                     margin: int = 0):
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

    Returns ``(kernel, written)``: the :class:`FusedKernel` to pass to
    :func:`repro_torch.kernels.ops.fused_step` and the written fields in
    first-written order.  Raises ``ValueError``, on every device and before
    touching CUDA, for a body outside the kernel's limits: another dtype
    than float32/float64, more than one dtype, more than ``MAX_FIELDS``
    fields, or a descriptor over ``MAX_DESC_BYTES``; and for a margin
    below ``k·halo``.
    """
    if margin and margin < time_tile * halo:
        raise ValueError(
            f"resident margin {margin} < window halo {time_tile * halo}")
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
    tile = default_tile(time_tile, bx, by)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    kern = FusedKernel(
        updates=tuple(updates), in_names=in_names, written=tuple(written),
        nz=tuple(nz_of[n] for n in in_names), dtype=next(iter(dtypes)),
        halo=int(halo), k=int(time_tile), bx=bx, by=by, nx=nx, ny=ny,
        wrap=bool(wrap), tile=tile, ints=ints, coefs=coefs, hazard=hazard,
        device=device, margin=int(margin))
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
    """Margin mode's output buffers: one per written field, at the resident
    extent, and none sharing storage with an input or with another output
    (the ping-pong guard: the kernel's blocks would read cells a
    neighbouring block already wrote)."""
    if not kernel.margin:
        if out is not None:
            raise ValueError("out= is the margin mode's; this kernel was "
                             "built with margin=0")
        return
    if out is None or len(out) != len(kernel.written):
        raise ValueError(f"margin mode needs out= with one buffer per written "
                         f"field {kernel.written}")
    ex, ey = kernel.extent
    nz_of = dict(zip(kernel.in_names, kernel.nz))
    for name, o in zip(kernel.written, out):
        want = (ex, ey, nz_of[name])
        if tuple(o.shape) != want or o.dtype != kernel.dtype:
            raise ValueError(f"output {name!r} is {tuple(o.shape)} {o.dtype}, "
                             f"expected {want} {kernel.dtype}")
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


def fused_step_ref(kernel: FusedKernel, inputs: Sequence[torch.Tensor],
                   coords: Tuple[int, int] = (0, 0),
                   out: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of one launch of ``kernel``.

    Padded mode: ``inputs`` are the ``(bx + 2·k·h, by + 2·k·h, nz)`` windows
    in ``kernel.in_names`` order; returns fresh ``(bx, by, nz)`` written
    fields.  Margin mode: ``inputs`` are resident buffers; the window is
    sliced from offset ``M − k·h``, and the written fields land in the
    interior ``[M:M+bx, M:M+by]`` of the ``out`` buffers, which are
    returned (their margins are left as they were).  ``coords`` is the
    brick's global cell origin.  The whole window is one block: each output
    cell's arithmetic is the same whichever block computes it, so this
    matches the tiled kernel bit for bit.
    """
    _check_outputs(kernel, inputs, out)
    k, h = kernel.k, kernel.halo
    if kernel.margin:
        lo = kernel.margin - kernel.pad
        wx, wy = kernel.bx + 2 * kernel.pad, kernel.by + 2 * kernel.pad
        inputs = [t[lo:lo + wx, lo:lo + wy] for t in inputs]
    cur = dict(zip(kernel.in_names, inputs))
    nz_of = dict(zip(kernel.in_names, kernel.nz))
    gx0 = coords[0] - k * h
    gy0 = coords[1] - k * h
    for s in range(k):
        out_x = kernel.bx + 2 * (k - s - 1) * h
        out_y = kernel.by + 2 * (k - s - 1) * h
        gx0 += h
        gy0 += h
        cur = _apply_updates(kernel.updates, cur, nz_of, h, out_x, out_y,
                             gx0, gy0, kernel.nx, kernel.ny, kernel.wrap)
    if not kernel.margin:
        return tuple(cur[n].contiguous() for n in kernel.written)
    M = kernel.margin
    for name, o in zip(kernel.written, out):
        o[M:M + kernel.bx, M:M + kernel.by].copy_(cur[name])
    return tuple(out)


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
        for fn in (lib.fused_stencil_f32, lib.fused_stencil_f64):
            fn.argtypes = [ptrs, ptrs, ptrs, ptrs, ctypes.c_void_p, ints, ints,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ints,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.fused_k1_f32, lib.fused_k1_f64):
            fn.argtypes = [ptrs, ptrs, ints, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ints, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
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
        want = (ex, ey, nz)
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


def launch_fused(kernel: FusedKernel, inputs: Sequence[torch.Tensor],
                 coords: Tuple[int, int] = (0, 0),
                 out: Optional[Sequence[torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Launch K1 on CUDA tensors, through the entry :func:`fused_entry`
    names.

    Padded mode: returns fresh ``(bx, by, nz)`` outputs.  Margin mode:
    writes the brick interiors of the caller's ``out`` buffers (resident
    extent, no storage shared with an input) and returns them; no output is
    allocated.  Checks device, dtype, shape and contiguity, allocates the
    generic entry's k > 1 and hazard scratch with ``torch.empty``, launches
    on the current stream and raises if the launch was refused.  The k = 1
    entry also needs the brick inside the global extent (``coords ≥ 0``,
    ``coords + (bx, by) ≤ (nx, ny)``), which it checks.  Does not
    synchronise.
    """
    if kernel.device.type != "cuda" or kernel.ints_dev is None:
        raise ValueError(f"kernel was built for {kernel.device}, not CUDA")
    dev = _check_inputs(kernel, inputs)
    _check_outputs(kernel, inputs, out)
    entry = fused_entry(kernel)
    cx, cy = int(coords[0]), int(coords[1])
    if entry == "k1" and not (0 <= cx and cx + kernel.bx <= kernel.nx
                              and 0 <= cy and cy + kernel.by <= kernel.ny):
        raise ValueError(f"brick at {coords} of extent ({kernel.bx}, "
                         f"{kernel.by}) leaves the ({kernel.nx}, {kernel.ny}) "
                         "grid")
    lib = _library()
    k, ph = kernel.k, kernel.pad
    tx, ty = kernel.tile
    tiles_x = -(-kernel.bx // tx)
    tiles_y = -(-kernel.by // ty)
    max_nz = max(kernel.nz)
    opts = dict(dtype=kernel.dtype, device=dev)
    if kernel.margin:
        outs = dict(zip(kernel.written, out))
    else:
        outs = {name: torch.empty((kernel.bx, kernel.by, nz), **opts)
                for name, nz in zip(kernel.in_names, kernel.nz)
                if name in kernel.written}
    n = len(kernel.in_names)
    M = kernel.margin
    in_off, out_off = (M - ph, M) if M else (0, 0)
    geom = (ctypes.c_int * 20)(
        kernel.bx, kernel.by, kernel.nx, kernel.ny, cx, cy, k, kernel.halo,
        int(kernel.wrap), tx, ty, tiles_x, tiles_y, len(kernel.ints),
        len(kernel.coefs), max_nz, in_off, kernel.extent[1], out_off,
        kernel.extent[1] if M else kernel.by)
    f32 = kernel.dtype == torch.float32
    stream = torch.cuda.current_stream(dev).cuda_stream
    ins = _PTRS(*[t.data_ptr() for t in inputs])
    out_ptrs = _PTRS(*[outs[nm].data_ptr() if nm in outs else None
                       for nm in kernel.in_names])
    if entry == "k1":
        (gx, gy), (bz, bty) = k1_launch_shape(kernel)
        fn = lib.fused_k1_f32 if f32 else lib.fused_k1_f64
        rc = fn(ins, out_ptrs, _INTS(*kernel.nz), n, kernel.ints_dev.data_ptr(),
                kernel.coefs_dev.data_ptr(), geom, gx, gy, bz, bty, dev.index,
                stream)
    else:
        grid = min(tiles_x * tiles_y, MAX_SCRATCH_BLOCKS)
        win = (tx + 2 * ph) * (ty + 2 * ph)
        # `keep` holds the scratch tensors until the launch is enqueued (the
        # loop rebinds b0/b1); after that the caching allocator orders their
        # reuse on this stream behind the kernel
        bufs0, bufs1, keep = [], [], []
        for name, nz in zip(kernel.in_names, kernel.nz):
            if name in kernel.written and k > 1:
                b0 = torch.empty(grid * win * nz, **opts)
                b1 = torch.empty(grid * win * nz, **opts)
                keep += [b0, b1]
                bufs0.append(b0.data_ptr())
                bufs1.append(b1.data_ptr())
            else:
                bufs0.append(None)
                bufs1.append(None)
        tmp = (torch.empty(grid * win * max_nz, **opts) if kernel.hazard
               else None)
        fn = lib.fused_stencil_f32 if f32 else lib.fused_stencil_f64
        rc = fn(ins, out_ptrs, _PTRS(*bufs0), _PTRS(*bufs1),
                None if tmp is None else tmp.data_ptr(),
                _INTS(*kernel.nz),
                _INTS(*[int(nm in outs) for nm in kernel.in_names]),
                n, kernel.ints_dev.data_ptr(), kernel.coefs_dev.data_ptr(),
                geom, grid, THREADS, dev.index, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_stencil {entry} launch failed: "
            f"{lib.fused_stencil_error(rc).decode()} (cudaError {rc})")
    launch_fused.launches += 1
    launch_fused.margin_launches += bool(M)
    launch_fused.k1_launches += entry == "k1"
    return tuple(outs[nm] for nm in kernel.written)


launch_fused.launches = 0
launch_fused.margin_launches = 0
launch_fused.k1_launches = 0
