"""K1 — the generic fused stencil for one loop body, on Hopper.

The port of ``repro/kernels/fused.py::build_fused_call``.  The Pallas body
there is unrolled in Python for each tap set; here one CUDA kernel
(``csrc/fused_stencil.cu``, built for ``sm_90a`` at first use) reads the same
structure from a descriptor that :func:`build_fused_call` flattens from the
lowered updates:

* per update: the written field, ``z0``, ``zlen``, ``const``, and its
  coefficient groups — taps sharing a coefficient, in first-appearance
  order, each a list of products of 1–2 taps ``(field, dz, dx, dy)``;
* per tap, whether it reads a field an earlier update of the body already
  wrote (the block-local centre value, ``dx == dy == 0`` by lowering).

The descriptor is uploaded once per kernel-cache entry (the ``_get_kernel``
signature of :mod:`repro_torch.compiler.codegen`) and copied into shared
memory by every block.  Only the padded → fresh-output mode is ported: the
resident (aliased) and region modes come with later slices.

Three entry points:

* :func:`launch_fused` launches the CUDA kernel on CUDA tensors and counts
  its launches in ``launch_fused.launches``;
* :func:`fused_step_ref` is the plain PyTorch version: the same trapezoid,
  the same Moat mask and the same association, over the whole padded
  window at once.  The CPU path and the tests use it;
* :func:`repro_torch.kernels.ops.fused_step` picks between them by the
  tensors' device.

Bound on the card: bytes (each padded input read once, each output written
once per launch); see the note in the CUDA source.
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
    ints_dev: Optional[torch.Tensor] = None
    coefs_dev: Optional[torch.Tensor] = None

    @property
    def pad(self) -> int:
        """Depth ``k·h`` of the wrap pad every input carries."""
        return self.k * self.halo


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
    """Output tile of one block: 16×16 untiled, 32×32 when k > 1 (a wider
    tile keeps the trapezoid's recompute share down)."""
    t = 16 if k == 1 else 32
    return min(t, bx), min(t, by)


def build_fused_call(updates: Sequence, field_specs: Dict[str, Tuple[int, object]],
                     halo: int, bx: int, by: int, nx: int, ny: int,
                     time_tile: int = 1, wrap: bool = False, *, device):
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

    Returns ``(kernel, written)``: the :class:`FusedKernel` to pass to
    :func:`repro_torch.kernels.ops.fused_step` and the written fields in
    first-written order.  Raises ``ValueError``, on every device and before
    touching CUDA, for a body outside the kernel's limits: another dtype
    than float32/float64, more than one dtype, more than ``MAX_FIELDS``
    fields, or a descriptor over ``MAX_DESC_BYTES``.
    """
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
        device=device)
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


def fused_step_ref(kernel: FusedKernel, padded: Sequence[torch.Tensor],
                   coords: Tuple[int, int] = (0, 0)) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of one launch of ``kernel``.

    ``padded`` are the ``(bx + 2·k·h, by + 2·k·h, nz)`` inputs in
    ``kernel.in_names`` order; ``coords`` the brick's global cell origin.
    The whole padded window is one block: each output cell's arithmetic is
    the same whichever block computes it, so this matches the tiled kernel
    bit for bit.  Returns the written fields, ``(bx, by, nz)`` each.
    """
    k, h = kernel.k, kernel.halo
    cur = dict(zip(kernel.in_names, padded))
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
    return tuple(cur[n].contiguous() for n in kernel.written)


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
        lib.fused_stencil_error.argtypes = [ctypes.c_int]
        lib.fused_stencil_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_inputs(kernel: FusedKernel, padded) -> torch.device:
    if len(padded) != len(kernel.in_names):
        raise ValueError(
            f"expected {len(kernel.in_names)} inputs, got {len(padded)}")
    dev = kernel.device
    ph = kernel.pad
    for name, nz, t in zip(kernel.in_names, kernel.nz, padded):
        want = (kernel.bx + 2 * ph, kernel.by + 2 * ph, nz)
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


def launch_fused(kernel: FusedKernel, padded: Sequence[torch.Tensor],
                 coords: Tuple[int, int] = (0, 0)) -> Tuple[torch.Tensor, ...]:
    """Launch K1 on CUDA tensors; returns fresh ``(bx, by, nz)`` outputs.

    Checks device, dtype, shape and contiguity, allocates outputs and
    scratch with ``torch.empty``, launches on the current stream and raises
    if the launch was refused.  Does not synchronise.
    """
    if kernel.device.type != "cuda" or kernel.ints_dev is None:
        raise ValueError(f"kernel was built for {kernel.device}, not CUDA")
    dev = _check_inputs(kernel, padded)
    lib = _library()
    k, ph = kernel.k, kernel.pad
    tx, ty = kernel.tile
    tiles_x = -(-kernel.bx // tx)
    tiles_y = -(-kernel.by // ty)
    n_tiles = tiles_x * tiles_y
    need_scratch = k > 1 or kernel.hazard
    grid = min(n_tiles, MAX_SCRATCH_BLOCKS) if need_scratch else n_tiles
    win = (tx + 2 * ph) * (ty + 2 * ph)
    max_nz = max(kernel.nz)
    opts = dict(dtype=kernel.dtype, device=dev)
    # `keep` holds the scratch tensors until the launch is enqueued (the loop
    # rebinds b0/b1); after that the caching allocator orders their reuse on
    # this stream behind the kernel
    outs, bufs0, bufs1, keep = {}, [], [], []
    for name, nz in zip(kernel.in_names, kernel.nz):
        if name in kernel.written:
            outs[name] = torch.empty((kernel.bx, kernel.by, nz), **opts)
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
    n = len(kernel.in_names)
    geom = (ctypes.c_int * 16)(
        kernel.bx, kernel.by, kernel.nx, kernel.ny, int(coords[0]),
        int(coords[1]), k, kernel.halo, int(kernel.wrap), tx, ty, tiles_x,
        tiles_y, len(kernel.ints), len(kernel.coefs), max_nz)
    fn = (lib.fused_stencil_f32 if kernel.dtype == torch.float32
          else lib.fused_stencil_f64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(_PTRS(*[t.data_ptr() for t in padded]),
            _PTRS(*[outs[nm].data_ptr() if nm in outs else None
                    for nm in kernel.in_names]),
            _PTRS(*bufs0), _PTRS(*bufs1),
            None if tmp is None else tmp.data_ptr(),
            _INTS(*kernel.nz), _INTS(*[int(nm in outs) for nm in kernel.in_names]),
            n, kernel.ints_dev.data_ptr(), kernel.coefs_dev.data_ptr(), geom,
            grid, THREADS, dev.index, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_stencil launch failed: {lib.fused_stencil_error(rc).decode()}"
            f" (cudaError {rc})")
    launch_fused.launches += 1
    return tuple(outs[nm] for nm in kernel.written)


launch_fused.launches = 0
