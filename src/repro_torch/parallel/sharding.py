"""Logical-axis sharding (MaxText-style rules → ``PartitionSpec``).

The port of ``repro/parallel/sharding.py``.  Model code annotates tensors
with *logical* axis names (``pshard(x, 'batch', 'seq', 'embed')``); a
:class:`ShardingRules` table maps logical names to the axes of a
:class:`~repro_torch.core.mesh.Mesh`.  The reference hands the annotation to
GSPMD, which never changes a value; here :func:`pshard` returns its tensor
as it is, in a context and outside one, and in a context it computes the
spec, so a bad annotation raises where the reference's does.  Outside a
context it costs one thread-local read.

What the port does with the specs, by hand and in one process:

* the LM train step (:func:`repro_torch.launch.steps.make_train_step`)
  shards the batch over the rules' ``batch`` axes: one forward and
  backward per replica, the gradients summed into the float32
  accumulators of the one device that holds every position;
* serving and, on placed parameters, the train step
  (:mod:`repro_torch.parallel.tensor`) split heads, ``mlp``, vocab,
  experts and the decode caches' sequence over ``model`` by hand, on
  parameters, optimizer state and caches placed by their specs;
* :func:`place` puts a tensor on a mesh by a spec as a
  :class:`ShardedTensor`, whose blocks are JAX's
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` blocks;
  :func:`repro_torch.runtime.elastic.remesh` moves state between meshes
  through it.

>>> from repro_torch.core.mesh import make_mesh
>>> mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
>>> rules = ShardingRules(mesh)
>>> rules.spec(("batch", "seq", "heads"), (8, 32, 3))
PartitionSpec('data', None, None)
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.optim.tree import tree_map

MeshAxes = Union[None, str, Tuple[str, ...]]

_CTX = threading.local()


def default_rules() -> Dict[str, MeshAxes]:
    """Baseline DP+TP mapping for the (pod, data, model) production mesh."""
    return {
        "batch": ("pod", "data"),     # DP over pod × data
        "seq": None,
        "embed": None,                # activations replicated over model
        "heads": "model",             # TP: attention heads
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",               # TP: ffn hidden
        "vocab": "model",             # TP: embedding/lm-head vocab shard
        "experts": "model",           # EP: routed experts
        "expert_mlp": None,           # (mixtral remaps this to 'model')
        "q_lora": None,
        "kv_lora": None,
        "cache_batch": ("pod", "data"),
        # decode caches shard the SEQUENCE over the model axis (the
        # reference's distributed flash-decode)
        "cache_seq": "model",
        "cache_heads": None,
        "ssm_heads": "model",
        "ssm_state": None,
        "conv_dim": "model",
        "rwkv_heads": "model",
        "layers": None,               # stacked-layer leading axis
        "stage": None,                # pipeline stages (PP rule set)
    }


class PartitionSpec(tuple):
    """Mesh axes per tensor dimension: None (whole), an axis name, or a
    tuple of names (sharded over their product, the first the major).  A
    tuple, equal to the reference's ``jax.sharding.PartitionSpec`` of the
    same entries, and a leaf of the port's trees."""

    tree_leaf = True

    def __new__(cls, *parts: MeshAxes):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


P = PartitionSpec


def _axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A :class:`PartitionSpec` on a mesh: the reference's
    ``jax.sharding.NamedSharding`` for any spec over an N-D mesh (the brick
    path's 2-D one is :class:`repro_torch.core.mesh.NamedSharding`)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)
        used = [a for entry in self.spec for a in _axes(entry)]
        unknown = [a for a in used if a not in mesh.shape]
        if unknown:
            raise ValueError(f"spec {self.spec} names axes {unknown} that "
                             f"are not in the mesh {mesh.shape}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {self.spec} uses a mesh axis twice")

    def _check(self, shape) -> Tuple[int, ...]:
        shape = tuple(int(n) for n in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"rank of shape {shape}")
        for n, entry in zip(shape, self.spec):
            parts = int(np.prod([self.mesh.shape[a] for a in _axes(entry)]))
            if n % parts:
                raise ValueError(f"dimension {n} of shape {shape} does not "
                                 f"divide into {parts} parts ({entry})")
        return shape

    def index(self, coords, shape) -> Tuple[slice, ...]:
        """The block of a global ``shape`` at mesh coordinates ``coords``:
        one slice per dimension (``slice(None)`` where it is whole)."""
        shape = self._check(shape)
        where = dict(zip(self.mesh.axis_names, coords))
        out = []
        for i, n in enumerate(shape):
            axes = _axes(self.spec[i]) if i < len(self.spec) else ()
            if not axes:
                out.append(slice(None))
                continue
            k, parts = 0, 1
            for a in axes:
                k = k * self.mesh.shape[a] + where[a]
                parts *= self.mesh.shape[a]
            step = n // parts
            out.append(slice(k * step, (k + 1) * step))
        return tuple(out)

    def devices_indices_map(self, shape) -> Dict[Tuple[int, ...], tuple]:
        """Mesh coordinates → the block's slices, for every position (JAX
        keys the map by device; here several positions may share one)."""
        return {self.mesh.coords(b): self.index(self.mesh.coords(b), shape)
                for b in range(self.mesh.size)}

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _host_tensor(x) -> torch.Tensor:
    """A tensor of ``x`` (a tensor, or a NumPy array; NumPy bfloat16 goes
    through float32, which is exact)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class ShardedTensor:
    """A global tensor placed on a mesh by a spec (:func:`place`).

    Where every position is on one device the tensor is held once there,
    and each block is a view of it (:meth:`local` is the whole).  Where
    positions are on several devices each block is a copy on its
    position's device; that case needs a machine with more than one device
    and has not run (the chip machine has one card, the CPU is one
    device)."""

    def __init__(self, sharding: NamedSharding, shape, dtype,
                 whole: Optional[torch.Tensor] = None, blocks=None):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype
        self._whole = whole
        self._blocks = blocks
        self._views: Dict[tuple, torch.Tensor] = {}
        self._index: Dict[tuple, tuple] = {}

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def mesh(self):
        return self.sharding.mesh

    def block(self, coords) -> torch.Tensor:
        """The block at mesh coordinates ``coords``, on its position's
        device.  While the whole records gradients (the train step's
        pass) the block is a fresh view of it, so that autograd carries
        the block's gradient into the whole; a view kept from before would
        be a leaf of its own."""
        coords = tuple(coords)
        if self._whole is None:
            return self._blocks[self.mesh.brick(*coords)]
        if self._whole.requires_grad:
            return self._whole[self.index(coords)]
        view = self._views.get(coords)
        if view is None:    # a view of the whole, kept: looked up per layer
            view = self._views[coords] = self._whole[self.index(coords)]
        return view

    def index(self, coords) -> tuple:
        """The slices of the block at mesh coordinates ``coords``."""
        coords = tuple(coords)
        idx = self._index.get(coords)
        if idx is None:
            idx = self._index[coords] = self.sharding.index(coords,
                                                            self.shape)
        return idx

    def blocks(self) -> list:
        """Every position's block, x-major."""
        return [self.block(self.mesh.coords(b)) for b in range(self.mesh.size)]

    def local(self) -> torch.Tensor:
        """The whole tensor, where every position is on one device."""
        if self._whole is None:
            raise ValueError("a tensor placed on several devices is held "
                             "as blocks only")
        return self._whole

    def like(self, whole: torch.Tensor) -> "ShardedTensor":
        """``whole`` (this tensor's global shape, on the device of every
        position) as a tensor placed by this one's sharding, not copied."""
        return ShardedTensor(self.sharding, self.shape, whole.dtype,
                             whole=whole)

    def copy_(self, src: "ShardedTensor") -> "ShardedTensor":
        """Copy ``src`` (the same global shape, every position on one
        device) into this tensor, in place."""
        self.local().copy_(src.local())
        return self

    def gather(self, device="cpu") -> torch.Tensor:
        """The global tensor on ``device``, a copy."""
        if self._whole is not None:
            return self._whole.to(device, copy=True)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for b, blk in enumerate(self._blocks):
            out[self.sharding.index(self.mesh.coords(b), self.shape)] \
                .copy_(blk)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec!r}, mesh={self.mesh.shape})")


def place(x, mesh, spec) -> ShardedTensor:
    """``x`` (a tensor on any device or a NumPy array) placed on ``mesh`` by
    ``spec``, copied: the reference's ``jax.device_put(x,
    NamedSharding(mesh, spec))``.  Raises ``ValueError`` where a sharded
    dimension does not divide its axes."""
    sharding = NamedSharding(mesh, spec)
    x = _host_tensor(x)
    sharding._check(x.shape)
    devices = set(mesh.devices)
    if len(devices) == 1:
        (dev,) = devices
        return ShardedTensor(sharding, x.shape, x.dtype,
                             whole=x.to(dev, copy=True))
    blocks = []
    for b, dev in enumerate(mesh.devices):
        part = x[sharding.index(mesh.coords(b), x.shape)]
        blocks.append(torch.empty(part.shape, dtype=x.dtype,
                                  device=dev).copy_(part))
    return ShardedTensor(sharding, x.shape, x.dtype, blocks=blocks)


class ShardingRules:
    def __init__(self, mesh, rules: Optional[Dict[str, MeshAxes]] = None):
        self.mesh = mesh
        self.rules = dict(default_rules())
        if rules:
            self.rules.update(rules)
        self._axis_sizes = dict(mesh.shape)

    def mesh_axes(self, logical: Optional[str], dim_size: Optional[int] = None
                  ) -> MeshAxes:
        if logical is None:
            return None
        ax = self.rules.get(logical)
        if ax is None:
            return None
        # keep only axes present in this mesh (single-pod meshes have no
        # 'pod' axis; the same rule table serves both)
        axes = tuple(a for a in ((ax,) if isinstance(ax, str) else ax)
                     if a in self._axis_sizes)
        if not axes:
            return None
        # drop the mapping if the dimension does not divide the mesh axis
        if dim_size is not None:
            total = 1
            for a in axes:
                total *= self._axis_sizes[a]
            if dim_size % total:
                return None
        return axes[0] if len(axes) == 1 else axes

    def spec(self, logical_axes, shape=None) -> PartitionSpec:
        parts = []
        for i, name in enumerate(logical_axes):
            size = None if shape is None else shape[i]
            parts.append(self.mesh_axes(name, size))
        return PartitionSpec(*parts)

    def sharding(self, logical_axes, shape=None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical_axes, shape))


def current_rules() -> Optional[ShardingRules]:
    return getattr(_CTX, "rules", None)


@contextlib.contextmanager
def use_sharding(rules: Optional[ShardingRules]):
    prev = getattr(_CTX, "rules", None)
    _CTX.rules = rules
    try:
        yield rules
    finally:
        _CTX.rules = prev


def pshard(x, *logical_axes):
    """Annotate ``x`` with logical axes: ``x`` itself, always.  In a
    context the spec is computed (and raises on an annotation of more axes
    than ``x`` has dimensions, as the reference's does)."""
    rules = getattr(_CTX, "rules", None)
    if rules is not None:
        rules.spec(logical_axes, x.shape)
    return x


def spec_for(rules: Optional[ShardingRules], logical_axes, shape=None):
    if rules is None:
        return PartitionSpec()
    return rules.spec(logical_axes, shape)


def param_specs(params_axes, rules: ShardingRules):
    """Map a tree of :class:`AxisInfo` leaves to a tree of PartitionSpec."""
    return tree_map(lambda axes: rules.spec(axes.axes, axes.shape),
                    params_axes)


class AxisInfo:
    """Leaf marker: logical axes + shape for one parameter."""

    def __init__(self, axes, shape):
        self.axes = tuple(axes)
        self.shape = tuple(shape)

    def __repr__(self):
        return f"AxisInfo({self.axes}, {self.shape})"
