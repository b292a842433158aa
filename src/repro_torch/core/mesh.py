"""A single-process brick mesh: the port's counterpart of the JAX objects the
legacy brick drivers use.

The reference decomposes a global ``(X, Y, Z)`` field into x-major bricks of
a 2-D device mesh (``repro/core/jaxcompat.py::make_mesh``), places it with
``jax.device_put(T, NamedSharding(mesh, P(ax_x, ax_y, None)))`` and runs one
SPMD program per brick under ``shard_map``.  Here one process drives every
brick in turn:

* :class:`Mesh` — ``mx × my`` bricks, each with its own device; several
  bricks may share one device (a 2×2 mesh on one card, or on the CPU);
* :class:`NamedSharding` — cuts a global tensor into the mesh's bricks and
  gathers them back;
* :class:`BrickArray` — a sharded field: one tensor per brick, with the
  element-wise arithmetic the drivers need (a replicated 0-d tensor or a
  Python number on one side is used on every brick);
* :func:`device_put` / :func:`device_get` — the JAX spellings.

Bricks exchange data only through :func:`repro_torch.core.halo._ppermute_shift`
(halo planes) and :func:`psum` (reductions); multi-card transport plugs in
there.

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
    """``mx × my`` bricks over named axes, brick ``b`` at mesh coordinates
    ``divmod(b, my)`` (x-major, as ``jax.make_mesh`` lays devices out) on
    ``devices[b]``."""

    def __init__(self, shape: Tuple[int, int], axis_names: Sequence[str],
                 devices: Sequence[torch.device]):
        if len(shape) != 2 or len(axis_names) != 2:
            raise ValueError(f"a brick mesh is 2-D; got shape {shape} over "
                             f"{tuple(axis_names)}")
        mx, my = (int(n) for n in shape)
        if mx < 1 or my < 1:
            raise ValueError(f"mesh shape {shape} must be positive")
        if len(devices) != mx * my:
            raise ValueError(f"{len(devices)} devices for {mx * my} bricks")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (mx, my)))
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def dims(self) -> Tuple[int, int]:
        return tuple(self.shape.values())

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """The device that holds replicated values (reduced scalars)."""
        return self.devices[0]

    def coords(self, b: int) -> Tuple[int, int]:
        """Mesh coordinates ``(cx, cy)`` of brick ``b``."""
        return divmod(b, self.dims[1])

    def brick(self, cx: int, cy: int) -> int:
        return cx * self.dims[1] + cy

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(shape, axis_names=("data", "model"), device="cuda") -> Mesh:
    """A single-process mesh of ``shape`` bricks.

    ``device`` is one device for every brick (default the card; raises
    without one) or a sequence of ``mx·my`` devices, brick by brick.
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
        spec = tuple(spec) if spec is not None else (*mesh.axis_names, None)
        if spec != (*mesh.axis_names, None):
            raise ValueError(f"only {(*mesh.axis_names, None)} bricks are "
                             f"supported; got {spec}")
        self.mesh = mesh
        self.spec = spec

    def brick_shape(self, shape) -> Tuple[int, int, int]:
        (mx, my), (nx, ny, nz) = self.mesh.dims, shape
        if nx % mx or ny % my:
            raise ValueError(f"global shape {tuple(shape)} does not divide "
                             f"into {mx}×{my} bricks")
        return nx // mx, ny // my, nz

    def shard(self, x) -> "BrickArray":
        """Fresh contiguous bricks of the global ``(X, Y, Z)`` array ``x``
        (a tensor or NumPy array), each on its brick's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.ndim != 3:
            raise ValueError(f"expected a global (X, Y, Z) field, got "
                             f"{tuple(x.shape)}")
        bx, by, _ = self.brick_shape(x.shape)
        bricks = []
        for b, dev in enumerate(self.mesh.devices):
            cx, cy = self.mesh.coords(b)
            part = x[cx * bx:(cx + 1) * bx, cy * by:(cy + 1) * by, :]
            out = torch.empty(part.shape, dtype=x.dtype, device=dev)
            out.copy_(part)
            bricks.append(out)
        return BrickArray(bricks, self)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec})"


class BrickArray:
    """A global field held as one tensor per brick of ``sharding.mesh``."""

    def __init__(self, bricks: Sequence[torch.Tensor], sharding: NamedSharding):
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
    def shape(self) -> Tuple[int, int, int]:
        (mx, my), (bx, by, nz) = self.mesh.dims, self.bricks[0].shape
        return mx * bx, my * by, nz

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor, on ``device`` (default the mesh's home)."""
        dev = self.mesh.home if device is None else torch.device(device)
        bx, by, nz = self.bricks[0].shape
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for b, brick in enumerate(self.bricks):
            cx, cy = self.mesh.coords(b)
            out[cx * bx:(cx + 1) * bx, cy * by:(cy + 1) * by, :].copy_(brick)
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


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Sum of one value per brick, in brick order, on the mesh's home
    device: the reference's ``lax.psum`` over both mesh axes."""
    total = parts[0].to(mesh.home)
    for p in parts[1:]:
        total = total + p.to(mesh.home)
    return total


def device_put(x, sharding: NamedSharding) -> BrickArray:
    """``x`` (a global tensor or NumPy array) cut into ``sharding``'s
    bricks."""
    return sharding.shard(x)


def device_get(x) -> np.ndarray:
    """A host NumPy copy: of the gathered global field for a
    :class:`BrickArray`, of the tensor otherwise (waits for the device)."""
    if isinstance(x, BrickArray):
        x = x.gather("cpu")
    return x.detach().cpu().numpy().copy()
