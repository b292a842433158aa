"""A single-process device mesh: the port's counterpart of the JAX objects the
legacy brick drivers and the LM stack use.

The reference decomposes a global ``(X, Y, Z)`` field into x-major bricks of
a 2-D device mesh (``repro/core/jaxcompat.py::make_mesh``), places it with
``jax.device_put(T, NamedSharding(mesh, P(ax_x, ax_y, None)))`` and runs one
SPMD program per brick under ``shard_map``.  Here one process drives every
brick in turn:

* :class:`Mesh` — 1 to 3 named axes (the LM stack's ``(pod, data, model)``),
  one device per position; several positions may share one device (a 2×2
  mesh on one card, or on the CPU).  The brick path below takes 2-D meshes
  only; :mod:`repro_torch.parallel` places tensors on any of them;
* :class:`NamedSharding` — cuts a global tensor into a 2-D mesh's bricks
  and gathers them back;
* :class:`BrickArray` — a sharded field: one tensor per brick, with the
  element-wise arithmetic the drivers need (a replicated 0-d tensor or a
  Python number on one side is used on every brick).  Through
  ``__torch_function__`` the element-wise torch functions act brick by
  brick and ``torch.sum`` / ``torch.all`` reduce over the whole field
  (:func:`psum`), so :mod:`repro_torch.solver.krylov` runs on it
  unchanged;
* :func:`device_put` / :func:`device_get` — the JAX spellings.

Bricks exchange data only through :func:`repro_torch.core.halo._ppermute_shift`
(halo planes), :func:`psum` (reductions over the whole mesh) and
:func:`psum_axes` (over some of its named axes); multi-card transport plugs
in there.

>>> import torch
>>> mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
>>> sh = NamedSharding(mesh, ("data", "model", None))
>>> T = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
>>> x = device_put(T, sh)
>>> [tuple(b.shape) for b in x.bricks]
[(2, 3, 2), (2, 3, 2), (2, 3, 2), (2, 3, 2)]
>>> bool((device_get(2.0 * x + x) == 3 * T.numpy()).all())
True
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """Positions over 1 to 3 named axes, position ``b`` at mesh coordinates
    ``np.unravel_index(b, dims)`` (x-major, as ``jax.make_mesh`` lays
    devices out) on ``devices[b]``.  The brick path (:class:`NamedSharding`,
    :class:`BrickArray`, the halo exchange) takes 2-D meshes only."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Sequence[str],
                 devices: Sequence[torch.device]):
        if not 1 <= len(shape) <= 3 or len(axis_names) != len(shape):
            raise ValueError(f"a mesh has 1 to 3 named axes; got shape "
                             f"{shape} over {tuple(axis_names)}")
        dims = tuple(int(n) for n in shape)
        if min(dims) < 1:
            raise ValueError(f"mesh shape {shape} must be positive")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names {tuple(axis_names)} repeat")
        n = int(np.prod(dims))
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} bricks")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, dims))
        self.devices = tuple(torch.device(d) for d in devices)
        # looked up per brick in the sharded steps' host loops
        self._coords = tuple(tuple(int(c) for c in np.unravel_index(b, dims))
                             for b in range(n))
        self._index = {c: b for b, c in enumerate(self._coords)}

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(self.shape.values())

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """The device that holds replicated values (reduced scalars)."""
        return self.devices[0]

    def coords(self, b: int) -> Tuple[int, ...]:
        """Mesh coordinates of position (brick) ``b``: ``(cx, cy)`` on a
        2-D mesh."""
        return self._coords[b]

    def brick(self, *coords: int) -> int:
        """The position at mesh coordinates ``coords``."""
        return self._index[coords]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(shape, axis_names=("data", "model"), device="cuda") -> Mesh:
    """A single-process mesh of ``shape`` positions.

    ``device`` is one device for every position (default the card; raises
    without one) or a sequence of ``prod(shape)`` devices, position by
    position.
    """
    from repro_torch.engine.plan import resolve_device

    n = int(np.prod(shape))
    if isinstance(device, (list, tuple)):
        devices = [resolve_device(d) for d in device]
    else:
        devices = [resolve_device(device)] * n
    return Mesh(tuple(shape), axis_names, devices)


class NamedSharding:
    """Bricks over the mesh's two axes, Z whole: the reference's
    ``NamedSharding(mesh, PartitionSpec(ax_x, ax_y, None))``."""

    def __init__(self, mesh: Mesh, spec=None):
        if len(mesh.dims) != 2:
            raise ValueError(f"a brick mesh is 2-D; got {mesh.shape}")
        spec = tuple(spec) if spec is not None else (*mesh.axis_names, None)
        if spec != (*mesh.axis_names, None):
            raise ValueError(f"only {(*mesh.axis_names, None)} bricks are "
                             f"supported; got {spec}")
        self.mesh = mesh
        self.spec = spec

    def brick_shape(self, shape) -> Tuple[int, int, int]:
        """``(bx, by, nz)`` of the bricks of a global ``(…, X, Y, Z)``
        shape; raises ``ValueError`` unless X and Y divide the mesh."""
        (mx, my), (nx, ny, nz) = self.mesh.dims, tuple(shape)[-3:]
        if nx % mx or ny % my:
            raise ValueError(f"global shape {tuple(shape)} does not divide "
                             f"into {mx}×{my} bricks")
        return nx // mx, ny // my, nz

    def shard(self, x) -> "BrickArray":
        """Fresh contiguous bricks of the global ``(…, X, Y, Z)`` array
        ``x`` (a tensor or NumPy array), each on its brick's device.
        Leading (member) axes pass through: every brick holds all of
        them."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.ndim < 3:
            raise ValueError(f"expected a global (…, X, Y, Z) field, got "
                             f"{tuple(x.shape)}")
        bx, by, _ = self.brick_shape(x.shape)
        bricks = []
        for b, dev in enumerate(self.mesh.devices):
            cx, cy = self.mesh.coords(b)
            part = x[..., cx * bx:(cx + 1) * bx, cy * by:(cy + 1) * by, :]
            out = torch.empty(part.shape, dtype=x.dtype, device=dev)
            out.copy_(part)
            bricks.append(out)
        return BrickArray(bricks, self)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec})"


class BrickArray:
    """A global field held as one tensor per brick of ``sharding.mesh``."""

    def __init__(self, bricks: Sequence[torch.Tensor], sharding: NamedSharding):
        if len(sharding.mesh.dims) != 2:
            raise ValueError(f"a brick mesh is 2-D; got {sharding.mesh.shape}")
        if len(bricks) != sharding.mesh.size:
            raise ValueError(f"{len(bricks)} bricks for a mesh of "
                             f"{sharding.mesh.size}")
        self.bricks = tuple(bricks)
        self.sharding = sharding

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.bricks[0].dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        (mx, my), shape = self.mesh.dims, tuple(self.bricks[0].shape)
        bx, by, nz = shape[-3:]
        return (*shape[:-3], mx * bx, my * by, nz)

    @property
    def device(self) -> torch.device:
        """The mesh's home device (where reductions land)."""
        return self.mesh.home

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor, on ``device`` (default the mesh's home)."""
        dev = self.mesh.home if device is None else torch.device(device)
        bx, by, _ = self.bricks[0].shape[-3:]
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for b, brick in enumerate(self.bricks):
            cx, cy = self.mesh.coords(b)
            out[..., cx * bx:(cx + 1) * bx,
                cy * by:(cy + 1) * by, :].copy_(brick)
        return out

    def map(self, fn, *others) -> "BrickArray":
        """``fn`` brick by brick; each of ``others`` is a BrickArray on the
        same sharding (its brick is passed) or a replicated value (moved to
        the brick's device when it is a tensor)."""
        out = []
        for b, brick in enumerate(self.bricks):
            args = [_on(o, b, brick.device) for o in others]
            out.append(fn(brick, *args))
        return BrickArray(out, self.sharding)

    def __add__(self, o):
        return self.map(lambda a, b: a + b, o)

    def __sub__(self, o):
        return self.map(lambda a, b: a - b, o)

    def __mul__(self, o):
        return self.map(lambda a, b: a * b, o)

    def __rmul__(self, o):
        return self.map(lambda a, b: b * a, o)

    def __radd__(self, o):
        return self.map(lambda a, b: b + a, o)

    def __rsub__(self, o):
        return self.map(lambda a, b: b - a, o)

    def __truediv__(self, o):
        return self.map(lambda a, b: a / b, o)

    def __neg__(self):
        return self.map(lambda a: -a)

    def all(self) -> torch.Tensor:
        """Whether every cell of every brick is true (0-d, on the home
        device)."""
        return torch.all(self)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """torch functions on BrickArrays: a whole-field reduction
        (``torch.sum`` / ``torch.all`` without ``dim``) reduces each brick
        and combines the parts on the home device; any other function runs
        brick by brick (replicated operands as in :meth:`map`) and must
        return a tensor of the brick's shape."""
        kwargs = kwargs or {}
        ref = next(a for a in (*args, *kwargs.values())
                   if isinstance(a, BrickArray))
        combine = _REDUCTIONS.get(func)
        if combine is not None and (len(args) > 1 or "dim" in kwargs):
            raise TypeError(f"{func.__name__} over a BrickArray reduces the "
                            "whole field only (no dim)")
        parts = []
        for b, brick in enumerate(ref.bricks):
            dev = brick.device
            parts.append(func(*[_on(a, b, dev) for a in args],
                              **{k: _on(v, b, dev) for k, v in kwargs.items()}))
        if combine is not None:
            return combine(parts, ref.mesh)
        for p, brick in zip(parts, ref.bricks):
            if not isinstance(p, torch.Tensor) or p.shape != brick.shape:
                raise TypeError(f"{getattr(func, '__name__', func)} is not "
                                "element-wise over a BrickArray")
        return BrickArray(parts, ref.sharding)

    def __repr__(self) -> str:
        return (f"BrickArray(shape={self.shape}, dtype={self.dtype}, "
                f"mesh={self.mesh.dims})")


def _on(o, b: int, device: torch.device):
    if isinstance(o, BrickArray):
        return o.bricks[b]
    if isinstance(o, torch.Tensor):
        if o.ndim != 0:
            raise ValueError("only 0-d tensors are replicated over bricks")
        return o.to(device)
    return o


#: the collectives bricks have made since :func:`reset_collectives`, by the
#: reference's HLO op names: one ``collective-permute`` per plane shift
#: over a mesh axis (:func:`repro_torch.core.halo._ppermute_shift`), one
#: ``all-reduce`` per reduction over the mesh or some of its axes
#: (:func:`psum`, :func:`psum_axes`, a whole-field ``torch.all``).
#: :mod:`repro_torch.launch.heat_cell` reads one step's schedule here.
collectives: Dict[str, int] = {"collective-permute": 0, "all-reduce": 0}


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Sum of one value per brick, in brick order, on the mesh's home
    device: the reference's ``lax.psum`` over both mesh axes."""
    collectives["all-reduce"] += 1
    total = parts[0].to(mesh.home)
    for p in parts[1:]:
        total = total + p.to(mesh.home)
    return total


def axis_groups(mesh: Mesh, axis_names) -> list:
    """The positions of ``mesh`` grouped by their coordinates off
    ``axis_names`` (a name or a sequence of names): each group, in
    position order, is what a collective over those axes reduces."""
    names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
    unknown = [a for a in names if a not in mesh.shape]
    if unknown:
        raise ValueError(f"axes {unknown} are not in the mesh {mesh.shape}")
    reduced = [mesh.axis_names.index(a) for a in names]
    groups: Dict[tuple, list] = {}
    for b in range(mesh.size):
        key = tuple(c for i, c in enumerate(mesh.coords(b))
                    if i not in reduced)
        groups.setdefault(key, []).append(b)
    return list(groups.values())


def psum_axes(parts: Sequence, mesh: Mesh, axis_names) -> list:
    """The reference's ``lax.psum(x, axis_names)`` over some of the mesh's
    named axes: ``parts`` holds one value per position (x-major), each a
    tensor or a sequence of tensors summed leaf by leaf; returns one value
    per position, the sum of the parts of the positions that differ from
    it only along ``axis_names``, added in position order on the device of
    the first of them.  Positions whose parts are the same objects (a value
    replicated over the other axes) share one sum, computed once."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size}")
    collectives["all-reduce"] += 1
    out: list = [None] * mesh.size
    done: Dict[tuple, object] = {}
    for members in axis_groups(mesh, axis_names):
        ids = tuple(id(parts[b]) for b in members)
        if ids not in done:
            done[ids] = _sum_parts([parts[b] for b in members],
                                   mesh.devices[members[0]])
        for b in members:
            out[b] = done[ids]
    return out


def _sum_parts(parts: Sequence, device: torch.device):
    if isinstance(parts[0], torch.Tensor):
        total = parts[0].to(device, copy=True)
        for p in parts[1:]:
            total.add_(p.to(device))
        return total
    return [_sum_parts(leaf, device) for leaf in zip(*parts)]


def _all(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Whether every brick's part is true, on the mesh's home device."""
    collectives["all-reduce"] += 1
    return torch.stack([p.to(mesh.home) for p in parts]).all()


#: whole-field reductions of :meth:`BrickArray.__torch_function__`
_REDUCTIONS = {torch.sum: psum, torch.Tensor.sum: psum,
               torch.all: _all, torch.Tensor.all: _all}


def device_put(x, sharding: NamedSharding) -> BrickArray:
    """``x`` (a global tensor or NumPy array) cut into ``sharding``'s
    bricks."""
    return sharding.shard(x)


def device_get(x) -> np.ndarray:
    """A host NumPy copy: of the gathered global field for a
    :class:`BrickArray` (or a placed
    :class:`~repro_torch.parallel.ShardedTensor`), of the tensor otherwise
    (waits for the device)."""
    if not isinstance(x, torch.Tensor):
        x = x.gather("cpu")
    return x.detach().cpu().numpy().copy()
