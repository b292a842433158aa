"""Halo-resident field layout: fields stay put, halos move.

The port of ``repro/engine/layout.py``.  Instead of building a wrap-padded
copy of every field for each kernel launch (two full-field ``torch.cat``s
per input, ``compiler/codegen.py::_wrap_pad``), each field is stored once
at its run-wide padded extent ``(nx + 2K, ny + 2K, nz)``, where ``K`` is the
largest window ``k·h`` any scheduled fused segment needs (the plan's
``layout.pad``).

A run then touches memory three ways, none of which repacks a field:

* **enter/exit** — one conversion at each boundary of a run of fused
  segments (:func:`repro_torch.engine.executor.single_runner`);
* **margin refresh** — before a launch reads a depth-``ph`` window, only
  the four edge slabs are rewritten, in place (:func:`wrap_refresh`);
* **ping-pong outputs** — K1's margin mode writes each written field into
  a second resident buffer of the same extent, which the step then swaps
  with the first.  The reference writes in place through
  ``input_output_aliases``, which is valid only while blocks run one at a
  time; on the card blocks run concurrently, and a block's window would
  read cells a neighbour already wrote.

Margin contents are transient: refreshed to depth ``ph`` right before each
launch that reads them and dead in between.

The exchange/compute overlap (``RunOptions(overlap=True)``,
:mod:`repro_torch.compiler.codegen`) never writes a margin: it extracts the
slabs into buffers of their own (:func:`wrap_slabs` on one device,
:func:`repro_torch.core.halo.exchange_slabs` on a mesh), assembles each
boundary shell's padded window from the brick and the slabs
(:func:`strip_window`) and stores each shell's output in the spare
(:func:`land_region`).  Each takes ``out=`` buffers that the step holds, so
a split step allocates nothing either.

Every operation here passes leading (batch) axes through; only the
trailing (X, Y, Z) axes are touched.

>>> import torch
>>> lay = HaloLayout(pad=2, shapes={"T": (4, 4, 3)})
>>> env = {"T": torch.arange(48.0).reshape(4, 4, 3)}
>>> padded = lay.enter(env)
>>> tuple(padded["T"].shape)
(8, 8, 3)
>>> bool((lay.exit(padded)["T"] == env["T"]).all())
True
>>> tuple(lay.enter({"T": torch.stack([env["T"]] * 5)})["T"].shape)
(5, 8, 8, 3)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HaloLayout:
    """Resident padded layout of one plan's fields.

    ``pad`` is the run-wide margin ``K`` (0 disables residency: enter and
    exit degrade to identity).  ``shapes`` records the interior extents the
    plan was built from, as metadata only: enter and exit pad and slice
    whatever env they receive.
    """

    pad: int
    shapes: Dict[str, Tuple[int, int, int]]

    def enter(self, env):
        """Copy every field into a fresh buffer of the resident extent.
        Margins start zero; they are refreshed before any kernel reads
        them.  Leading (batch) axes pass through unpadded."""
        if self.pad == 0:
            return dict(env)
        K = self.pad

        def _pad(v):
            v = torch.as_tensor(v)
            shape = (*v.shape[:-3], v.shape[-3] + 2 * K, v.shape[-2] + 2 * K,
                     v.shape[-1])
            buf = v.new_zeros(shape)
            buf[..., K:-K, K:-K, :].copy_(v)
            return buf

        return {n: _pad(v) for n, v in env.items()}

    def exit(self, env):
        """Slice every field's interior out of the resident buffers, into
        fresh contiguous tensors that alias no resident buffer."""
        if self.pad == 0:
            return dict(env)
        K = self.pad
        return {n: v[..., K:-K, K:-K, :].clone(
                    memory_format=torch.contiguous_format)
                for n, v in env.items()}


def slab_rects(bx: int, by: int, h: int) -> Dict[str, Tuple[int, int, int, int]]:
    """Margin-slab geometry: name -> (ox, oy, sx, sy) in brick coordinates.

    The four depth-``h`` margin slabs of a (bx, by) brick: X slabs span the
    interior columns, Y slabs the x-extended rows, so the corners carry the
    data that wraps in both axes.  The rectangles are pairwise disjoint and
    cover the margin frame exactly.  X slabs come first: a Y slab's source
    reads the X slabs' cells.
    """
    return {
        "lo_x": (-h, 0, h, by),
        "hi_x": (bx, 0, h, by),
        "lo_y": (-h, -h, bx + 2 * h, h),
        "hi_y": (-h, by, bx + 2 * h, h),
    }


def slab_views(resident: torch.Tensor, margin: int,
               h: int) -> Dict[str, torch.Tensor]:
    """The four depth-``h`` margin slabs of a resident buffer as views
    (name -> the :func:`slab_rects` rectangle of the buffer, leading axes
    whole): where a refresh lands."""
    K = margin
    bx = resident.shape[-3] - 2 * K
    by = resident.shape[-2] - 2 * K
    return {name: resident[..., K + ox:K + ox + sx, K + oy:K + oy + sy, :]
            for name, (ox, oy, sx, sy) in slab_rects(bx, by, h).items()}


def slab_buffers(resident: torch.Tensor, bx: int, by: int,
                 h: int) -> Dict[str, torch.Tensor]:
    """Empty buffers shaped as :func:`slab_rects`' slabs of ``resident``
    (its leading axes, dtype and device)."""
    lead, nz = resident.shape[:-3], resident.shape[-1]
    return {name: resident.new_empty((*lead, sx, sy, nz))
            for name, (_, _, sx, sy) in slab_rects(bx, by, h).items()}


def wrap_slabs(resident: torch.Tensor, margin: int, h: int,
               out: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """Extract the depth-``h`` wrap margin slabs into *separate* buffers.

    The slab values are exactly what :func:`wrap_refresh` writes into the
    margin frame (the Y slabs span the x-extended rows, so the corners wrap
    in both axes), but they go to their own tensors (``out``, name ->
    buffer shaped as :func:`slab_rects` says, or fresh ones), so the
    resident buffer is only read: an interior launch can read it at the
    same time.  Leading (member) axes pass through whole.  Returns the
    slabs.
    """
    K = margin
    bx = resident.shape[-3] - 2 * K
    by = resident.shape[-2] - 2 * K
    if out is None:
        out = slab_buffers(resident, bx, by, h)
    lo_x, hi_x = out["lo_x"], out["hi_x"]
    lo_x.copy_(resident[..., K + bx - h:K + bx, K:K + by, :])
    hi_x.copy_(resident[..., K:K + h, K:K + by, :])
    # the Y slabs' x-extended rows: the X slabs' corner pieces flank the
    # interior's edge rows (by - h .. by for lo_y, 0 .. h for hi_y)
    for name, y0 in (("lo_y", by - h), ("hi_y", 0)):
        o = out[name]
        o[..., :h, :, :].copy_(lo_x[..., :, y0:y0 + h, :])
        o[..., h:h + bx, :, :].copy_(resident[..., K:K + bx,
                                              K + y0:K + y0 + h, :])
        o[..., h + bx:, :, :].copy_(hi_x[..., :, y0:y0 + h, :])
    return out


def land_slabs(resident: torch.Tensor, slabs: Dict[str, torch.Tensor],
               margin: int, h: int) -> torch.Tensor:
    """Store margin slabs (name -> tensor, as :func:`slab_rects` shapes
    them) into the resident buffer's margin frame, in place: four
    ``copy_``s into disjoint rectangles, so their order does not matter.
    Leading (member) axes pass through whole.  Returns ``resident``."""
    if h == 0:
        return resident
    for name, view in slab_views(resident, margin, h).items():
        view.copy_(slabs[name])
    return resident


#: where each slab's wrap source lies, in units of the brick extent
_WRAP_SOURCE = {"lo_x": (1, 0), "hi_x": (-1, 0), "lo_y": (0, 1), "hi_y": (0, -1)}


def wrap_refresh(resident: torch.Tensor, margin: int, h: int) -> torch.Tensor:
    """Refresh the depth-``h`` wrap margin of a resident buffer in place.

    Writes exactly what a ``h``-deep periodic pad of the interior holds
    (``compiler/codegen.py::_wrap_pad``, the roll interpreter's semantics)
    into the margin frame: four ``copy_``s of edge slabs from the opposite
    interior edge, X slabs first, then the Y slabs over the x-extended rows.
    Only the slabs move; the interior is untouched and nothing is
    allocated.  Needs ``h <= margin`` and ``h`` at most the brick's extent.
    Returns ``resident``.
    """
    if h == 0:
        return resident
    K = margin
    bx = resident.shape[-3] - 2 * K
    by = resident.shape[-2] - 2 * K
    for name, (ox, oy, sx, sy) in slab_rects(bx, by, h).items():
        fx, fy = _WRAP_SOURCE[name]
        x0, y0 = K + ox, K + oy
        sx0, sy0 = x0 + fx * bx, y0 + fy * by
        resident[..., x0:x0 + sx, y0:y0 + sy, :].copy_(
            resident[..., sx0:sx0 + sx, sy0:sy0 + sy, :])
    return resident


def strip_window(resident: torch.Tensor, slabs: Dict[str, torch.Tensor],
                 margin: int, h: int, region, bx: int, by: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Assemble one boundary region's padded input window.

    ``region`` is a shell :class:`repro_torch.compiler.ir.RegionSpec`; the
    window is the ``(…, rx + 2h, ry + 2h, Z)`` input of its depth-``h``
    (``= k·halo``) padded launch: brick cells copied from the **pre-step**
    resident buffer, margin cells from the ``slabs`` (:func:`slab_rects`'
    rectangles, which cover the window's part outside the brick).  Cell for
    cell this is the window a monolithic launch reads off a refreshed
    buffer, and it reads no margin cell of ``resident``.  Written into
    ``out`` (contiguous, that shape) or a fresh tensor, which is returned.
    """
    K = margin
    wx0, wy0 = region.x0 - h, region.y0 - h
    wx1, wy1 = region.x0 + region.rx + h, region.y0 + region.ry + h
    if out is None:
        out = resident.new_empty((*resident.shape[:-3], wx1 - wx0, wy1 - wy0,
                                  resident.shape[-1]))
    rects = {"brick": (0, 0, bx, by), **slab_rects(bx, by, h)}
    for name, (ox, oy, sx, sy) in rects.items():
        ix0, iy0 = max(ox, wx0), max(oy, wy0)
        ix1, iy1 = min(ox + sx, wx1), min(oy + sy, wy1)
        if ix0 >= ix1 or iy0 >= iy1:
            continue
        if name == "brick":
            piece = resident[..., K + ix0:K + ix1, K + iy0:K + iy1, :]
        else:
            piece = slabs[name][..., ix0 - ox:ix1 - ox, iy0 - oy:iy1 - oy, :]
        out[..., ix0 - wx0:ix1 - wx0, iy0 - wy0:iy1 - wy0, :].copy_(piece)
    return out


def land_region(resident: torch.Tensor, out: torch.Tensor, margin: int,
                region) -> torch.Tensor:
    """Store one region's kernel output ``out`` into the resident buffer's
    brick at the region's origin, in place; returns ``resident``."""
    x0, y0 = margin + region.x0, margin + region.y0
    resident[..., x0:x0 + out.shape[-3], y0:y0 + out.shape[-2], :].copy_(out)
    return resident
