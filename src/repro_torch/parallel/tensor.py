"""Tensor parallelism over the mesh's ``model`` axis, by hand.

The port's own module: the reference has no counterpart, because there
GSPMD does this work.  The reference places the LM's parameters by their
specs (``param_specs_for``) and runs prefill and decode under
``use_sharding(rules)``; XLA then splits every product whose operand is
sharded over ``model`` — heads, ``mlp``, vocab, experts, and the decode
caches' sequence — and inserts the collectives.  The port has no such
compiler, so its model functions take a split path when their parameters
are a :class:`PlacedParams` (:func:`place_params`), with one
:class:`ModelSplit` a call:

* a *unit* ``(r, j)`` is row block ``r`` of the batch (the rows of the
  rules' ``batch`` axes, x-major over them, as the data-parallel train step
  splits them) at coordinate ``j`` of ``model``.  The first mesh position
  with those coordinates computes it, on its device, with its blocks of
  the parameters and caches (:meth:`ShardedTensor.block
  <repro_torch.parallel.sharding.ShardedTensor.block>`).  A split bound
  to one replica (:meth:`ModelSplit.bind`, the train step's pass) has one
  row block, computed at that replica's positions;
* an activation replicated over ``model`` is a list with one tensor a row
  block, on the device of the block's ``j = 0`` position;
* where GSPMD all-reduces, :meth:`ModelSplit.psum` / :meth:`ModelSplit.pmax`
  reduce the units' partials over ``model`` through
  :func:`~repro_torch.core.mesh.psum_axes` / ``pmax_axes``: one counted
  ``all-reduce`` each, the parts combined in ``model`` order.  Where it
  all-gathers, :meth:`ModelSplit.gather` concatenates the blocks;
* under autograd (the train step) each collective has its transpose as
  its backward: :meth:`~ModelSplit.psum` hands each part the sum's
  gradient; a tensor that several units read whole goes to them through
  :meth:`~ModelSplit.fan` (an activation: the input of a column-parallel
  product, a gathered or reduced value; a parameter replicated over
  ``model`` that each unit applies whole, :meth:`~ModelSplit.unit_params`),
  whose backward sums the units' gradients over ``model`` through
  ``psum_axes`` — GSPMD's all-reduce of such an input's gradient; a
  gather's backward is the concatenation's own, each unit its slice.
  Parts that units read in disjoint slices (``mm_rows``' columns, the
  experts' slots, rwkv's and mamba's per-head parameters) get their
  gradients assembled, not reduced.  ``pmax`` (the decode's softmax) does
  not record gradients: no pass that records reaches it;
* a recurrent state (``rwkv_heads``, ``ssm_heads`` or ``conv_dim`` over
  ``model``) is read and written in place a unit's block at a time
  (:meth:`ModelSplit.blocks_along`); a replicated parameter that a unit
  uses in part (``w0``, ``u``, ``ln_x``; ``a_log``, ``dt_bias``,
  ``d_skip``, the gated norm's ``scale``) is sliced by the block index of
  the weight that splits its axis (:meth:`ModelSplit.index`).

Every movement of data between positions is charged to a collective in
:data:`~repro_torch.core.mesh.position_collectives` (what the dry-run
reads, :mod:`repro_torch.launch.roofline`), at the positions that take
part:

* :meth:`~ModelSplit.psum`, :meth:`~ModelSplit.pmax` (the softmax takes
  one of each) and the backward of :meth:`~ModelSplit.fan` — an
  ``all-reduce`` over ``model`` at every position of the group, of the
  position's part;
* :meth:`~ModelSplit.gather` (column-parallel products, gathered keys and
  values, experts over ``model``, the lm_head's vocab blocks) and
  :meth:`~ModelSplit.whole` of a leaf split over ``model`` (MLA's
  ``wkv_b`` in decode) — an ``all-gather`` at row block ``r``'s
  positions, of the gathered result;
* charged to those, not on their own: :meth:`~ModelSplit.fan`'s and
  :meth:`~ModelSplit.on`'s copies of a value replicated over ``model``
  (an input, or what a reduction or gather just produced, which every
  position of the group holds), and the backward of a gather or of
  :meth:`~ModelSplit.psum` (each unit its slice, or the sum's gradient,
  of a gradient replicated over ``model``);
* no collective: :meth:`~ModelSplit.rows_of` and :meth:`~ModelSplit.join`
  (the batch's rows placed over the batch axes on the way in, the
  logits' row blocks on the way out, the reference's batch-sharded
  output; MoE's router statistics, which serving drops and a bound pass
  holds in one block), and the caches' blocks, read and written where
  they are held.

Where every position is on one device (one card, or the CPU) a placed
tensor is one tensor and its blocks are views, so the split holds the
weights once, and the train step records gradients on that tensor.
Where positions sit on several devices each partial stays on its unit's
device until its reduction or gather; serving there has not run, and the
train step refuses it.

>>> import torch
>>> from repro_torch.core.mesh import make_mesh
>>> from repro_torch.parallel.sharding import ShardingRules
>>> split = ModelSplit(ShardingRules(make_mesh((2, 2), ("data", "model"),
...                                             device="cpu")), 4)
>>> (split.dp, split.m, split.rows)
(2, 2, 2)
>>> [float(t) for t in split.psum([[torch.tensor(1.), torch.tensor(2.)],
...                                [torch.tensor(3.), torch.tensor(4.)]])]
[3.0, 7.0]
"""
from __future__ import annotations

import copy
import math
from typing import List, Sequence

import torch

from repro_torch.core.mesh import (Mesh, nbytes, pmax_axes, psum_axes,
                                   record_collective)
from repro_torch.optim.tree import leaves, tree_map, unflatten
from repro_torch.parallel.params import (_CACHE_AXES, cache_specs_for,
                                         param_specs_for)
from repro_torch.parallel.sharding import (NamedSharding, ShardedTensor,
                                           _axes, place)

MODEL = "model"


class PlacedParams(dict):
    """A parameter tree (the dicts and lists of ``ParamTree.tree()``)
    whose leaves are :class:`ShardedTensor` s placed on :attr:`mesh` by
    their specs: what the model functions split over ``model``."""

    mesh = None


def place_params(params, rules, cfg, specs=None) -> PlacedParams:
    """``params`` (a ``ParamTree`` or its tree) placed on ``rules.mesh`` by
    ``specs`` (default ``param_specs_for``): the reference's ``device_put``
    of each leaf with ``NamedSharding(mesh, spec)``."""
    tree = params.tree() if hasattr(params, "tree") else params
    if specs is None:
        specs = param_specs_for(cfg, tree, rules)
    out = PlacedParams(tree_map(lambda x, s: place(x, rules.mesh, s),
                                tree, specs))
    out.mesh = rules.mesh
    return out


def place_cache(cache, rules, cfg):
    """A decode cache (per segment, per layer) placed on ``rules.mesh`` by
    ``cache_specs_for``: the sequence over ``model``, rows over the batch
    axes."""
    specs = cache_specs_for(cfg, cache, rules)
    return tree_map(lambda x, s: place(x, rules.mesh, s), cache, specs)


def zeros(shape, dtype, mesh, spec) -> ShardedTensor:
    """A zeroed tensor of ``shape`` placed on ``mesh`` by ``spec``,
    allocated in place (one tensor where every position is on one device,
    else one block a position)."""
    sharding = NamedSharding(mesh, spec)
    shape = sharding._check(shape)
    devices = set(mesh.devices)
    if len(devices) == 1:
        (dev,) = devices
        return ShardedTensor(sharding, shape, dtype,
                             whole=torch.zeros(shape, dtype=dtype, device=dev))
    blocks = []
    for b, dev in enumerate(mesh.devices):
        idx = sharding.index(mesh.coords(b), shape)
        blocks.append(torch.zeros(
            [len(range(*s.indices(n))) for s, n in zip(idx, shape)],
            dtype=dtype, device=dev))
    return ShardedTensor(sharding, shape, dtype, blocks=blocks)


class ModelSplit:
    """One call's split of ``rows`` batch rows over ``rules.mesh``: ``dp``
    row blocks of :attr:`rows` rows (the rules' ``batch`` axes, where they
    divide the rows) by :attr:`m` positions of ``model``.  ``dtype`` is
    the compute dtype that :meth:`local` casts parameter blocks to.
    :attr:`scratch` holds what one call computes once for every layer (the
    decode masks)."""

    def __init__(self, rules, rows: int, dtype=None):
        mesh = rules.mesh
        if MODEL not in mesh.shape:
            raise ValueError(f"the model split needs a {MODEL!r} axis; got "
                             f"{mesh.shape}")
        self.mesh, self.rules, self.dtype = mesh, rules, dtype
        self.scratch: dict = {}
        self.m = mesh.shape[MODEL]
        self.batch_axes = _axes(rules.mesh_axes("batch", rows))
        if MODEL in self.batch_axes:
            raise ValueError("the batch and the model split share an axis")
        self.dp = math.prod(mesh.shape[a] for a in self.batch_axes)
        self.rows = rows // self.dp
        self._units, self._first = [], {}
        for b in range(mesh.size):
            c = dict(zip(mesh.axis_names, mesh.coords(b)))
            r = 0
            for a in self.batch_axes:
                r = r * mesh.shape[a] + c[a]
            self._units.append((r, c[MODEL]))
            self._first.setdefault((r, c[MODEL]), b)
        self._bound = False
        self._row_meshes: dict = {}

    def bind(self, r: int) -> "ModelSplit":
        """This split bound to row block ``r``: a split of that block's
        :attr:`rows` rows alone (``dp = 1``), each unit ``(0, j)`` computed
        at row block ``r``'s position of ``model`` coordinate ``j`` and its
        reductions over those positions — one replica's pass of the train
        step."""
        out = copy.copy(self)
        out.dp, out.scratch, out._bound = 1, {}, True
        out._first = {(0, j): self._first[(r, j)] for j in range(self.m)}
        out._units = [(0, j) for _, j in self._units]
        out._row_meshes = {}
        return out

    def _row_mesh(self, r: int) -> Mesh:
        """Row block ``r``'s positions along ``model``, as a mesh of that
        axis alone: what a reduction of one row block's parts runs on."""
        mesh = self._row_meshes.get(r)
        if mesh is None:
            mesh = self._row_meshes[r] = Mesh(
                (self.m,), (MODEL,), [self.device(r, j)
                                      for j in range(self.m)],
                positions=self._row_positions(r))
        return mesh

    def _row_positions(self, r: int) -> list:
        """The mesh positions that take part in row block ``r``'s
        collectives: those of its units, in ``model`` order (bound: the
        replica's)."""
        return [self._first[(r, j)] for j in range(self.m)]

    # -- where a unit is ---------------------------------------------------

    def coords(self, r: int, j: int = 0) -> tuple:
        """Mesh coordinates of the position that computes unit ``(r, j)``."""
        return self.mesh.coords(self._first[(r, j)])

    def device(self, r: int, j: int = 0) -> torch.device:
        return self.mesh.devices[self._first[(r, j)]]

    def on(self, x: torch.Tensor, r: int, j: int = 0) -> torch.Tensor:
        """``x`` on unit ``(r, j)``'s device (itself where it is there)."""
        return x.to(self.device(r, j))

    # -- blocks ------------------------------------------------------------

    def parts(self, st: ShardedTensor, dim: int) -> int:
        """How many blocks ``st`` has along ``dim`` over ``model``: ``m``
        where its spec puts ``model`` there, else 1 (whole)."""
        axes = _axes(st.spec[dim]) if dim < len(st.spec) else ()
        if not axes:
            return 1
        if axes != (MODEL,):
            raise NotImplementedError(f"dimension {dim} of a {st.shape} "
                                      f"tensor is split over {axes}; the "
                                      f"model split takes {MODEL!r} alone")
        return self.m

    def index(self, st: ShardedTensor, r: int, j: int) -> tuple:
        """The slices of ``st``'s block at unit ``(r, j)``."""
        return st.index(self.coords(r, j))

    def block(self, st: ShardedTensor, r: int, j: int) -> torch.Tensor:
        return st.block(self.coords(r, j))

    def local(self, tree, r: int, j: int):
        """Unit ``(r, j)``'s blocks of a tree of placed parameters, cast to
        the compute dtype (the one-device path's ``layer.tree(cdt)``)."""
        coords = self.coords(r, j)
        return tree_map(lambda st: st.block(coords).to(self.dtype), tree)

    def unit_params(self, tree, r: int, n: int) -> list:
        """:meth:`local` for units ``(r, 0) … (r, n − 1)`` at once: a tree
        a unit, each leaf that is replicated over ``model`` (a unit applies
        it whole) handed to the units through :meth:`fan`, so that under
        autograd their gradients of it are summed over ``model``."""
        if n == 1:
            return [self.local(tree, r, 0)]
        per = [[] for _ in range(n)]
        for st in leaves(tree):
            if any(MODEL in _axes(e) for e in st.spec):
                views = [self.block(st, r, j) for j in range(n)]
            else:
                views = self.fan(self.block(st, r, 0), r, n)
            for j, v in enumerate(views):
                per[j].append(v.to(self.dtype))
        return [unflatten(tree, vals) for vals in per]

    def whole(self, st: ShardedTensor, r: int) -> torch.Tensor:
        """A placed parameter gathered whole on row block ``r``'s device,
        in the compute dtype (where it is one tensor there: itself); an
        ``all-gather`` at the row block's positions where it is split over
        ``model``."""
        dev = self.device(r)
        if any(MODEL in _axes(e) for e in st.spec):
            record_collective("all-gather", self.mesh, self._row_positions(r),
                              math.prod(st.shape) * st.dtype.itemsize)
        try:
            w = st.local()
        except ValueError:
            w = st.gather(dev)
        return w.to(dev, self.dtype)

    # -- rows --------------------------------------------------------------

    def rows_of(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` (batch first) cut into the row blocks, each on its
        block's device."""
        n = self.rows
        return [self.on(x[r * n:(r + 1) * n], r) for r in range(self.dp)]

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The row blocks concatenated on the mesh's home device."""
        if len(xs) == 1:
            return xs[0].to(self.mesh.home)
        return torch.cat([x.to(self.mesh.home) for x in xs], dim=0)

    # -- collectives over model --------------------------------------------

    def _reduce(self, reduce, parts) -> list:
        if len(parts[0]) == 1:          # not split: nothing to reduce
            return [p[0] for p in parts]
        if self._bound:
            return [reduce(list(parts[0]), self._row_mesh(0), MODEL)[0]]
        out = reduce([parts[r][j] for r, j in self._units], self.mesh, MODEL)
        return [out[self._first[(r, 0)]] for r in range(self.dp)]

    def psum(self, parts) -> list:
        """``parts[r][j]``, unit ``(r, j)``'s partial, summed over ``model``
        in ``j`` order: one value a row block, on its device.  A row of one
        part (a product that is not split) is its own value, with no
        reduction.  Under autograd its backward hands every part the sum's
        gradient, with no reduction."""
        if len(parts[0]) == 1:
            return [p[0] for p in parts]
        flat = [p for row in parts for p in row]
        if torch.is_grad_enabled() and any(p.requires_grad for p in flat):
            return list(_PSum.apply(self, len(parts[0]), *flat))
        return self._reduce(psum_axes, parts)

    def pmax(self, parts) -> list:
        """:meth:`psum` with the element-wise maximum (written with
        ``out=``: it records no gradient, and only the decode's
        :meth:`softmax` takes it)."""
        return self._reduce(pmax_axes, parts)

    def fan(self, x: torch.Tensor, r: int, n: int) -> list:
        """``x``, a value of row block ``r`` that ``n`` units read whole,
        one tensor a unit ``(r, j)`` on its device.  Under autograd the
        units' gradients of ``x`` are summed over ``model`` in ``j`` order
        (:func:`~repro_torch.core.mesh.psum_axes` over row block ``r``'s
        positions: one counted ``all-reduce``, GSPMD's reduction of the
        input gradient of a column-parallel product); else (serving) it is
        ``x`` on each unit's device."""
        if n > 1 and torch.is_grad_enabled() and x.requires_grad:
            return list(_Fan.apply(self, r, n, x))
        return [self.on(x, r, j) for j in range(n)]

    def _fan_grad(self, grads, r: int, device: torch.device):
        """The backward of :meth:`fan`: the units' gradients summed over
        ``model`` onto ``device``, ``x``'s (none where no unit's was used,
        the one where one was)."""
        used = [g for g in grads if g is not None]
        if len(used) <= 1:
            return used[0].to(device) if used else None
        grads = [torch.zeros_like(used[0], device=self.device(r, j))
                 if g is None else g for j, g in enumerate(grads)]
        return psum_axes(grads, self._row_mesh(r), MODEL)[0].to(device)

    def gather(self, parts: Sequence[torch.Tensor], dim: int,
               r: int) -> torch.Tensor:
        """Row block ``r``'s blocks over ``model`` concatenated along
        ``dim`` on its device: an ``all-gather`` at the row block's
        positions (under autograd its backward hands each unit its
        slice)."""
        if len(parts) == 1:
            return parts[0]
        record_collective("all-gather", self.mesh, self._row_positions(r),
                          nbytes(parts))
        return torch.cat([self.on(p, r) for p in parts], dim=dim)

    # -- products ----------------------------------------------------------

    def mm_cols(self, params, r: int):
        """``mm(x, name)``: ``x @ params[name]`` for row block ``r``, each
        unit with its columns of the weight, gathered (column-parallel).
        The units read ``x`` through :meth:`fan`, once for successive
        products of the same ``x`` (the q, k, v projections)."""
        last = {}

        def mm(x, name):
            w = params[name]
            n = self.parts(w, len(w.shape) - 1)
            if last.get("x") is not x or last.get("n") != n:
                last.update(x=x, n=n, xs=self.fan(x, r, n))
            return self.gather([xj @ self.local(w, r, j)
                                for j, xj in enumerate(last["xs"])], -1, r)
        return mm

    def mm_rows(self, x: torch.Tensor, w: ShardedTensor, r: int) -> list:
        """The partials of ``x @ w`` for row block ``r``: unit ``j``'s
        columns of ``x`` by its rows of ``w`` (row-parallel), to be summed
        with :meth:`psum`."""
        return [self.on(x[..., self.index(w, r, j)[0]], r, j)
                @ self.local(w, r, j) for j in range(self.parts(w, 0))]

    def softmax(self, scores) -> list:
        """The softmax over the last axis of scores whose blocks along it
        are ``scores[r][j]`` (GSPMD's softmax over an axis sharded on
        ``model``): one max-reduction, ``exp(s − max)`` a block, a
        sum-reduction of the denominators, each block divided by it."""
        top = self.pmax([[s.amax(dim=-1, keepdim=True) for s in row]
                         for row in scores])
        ex = [[torch.exp(s - self.on(top[r], r, j)) for j, s in enumerate(row)]
              for r, row in enumerate(scores)]
        den = self.psum([[e.sum(dim=-1, keepdim=True) for e in row]
                         for row in ex])
        return [[e / self.on(den[r], r, j) for j, e in enumerate(row)]
                for r, row in enumerate(ex)]

    # -- decode caches (sequence over model) --------------------------------

    def cache_zeros(self, name: str, shape, dtype) -> ShardedTensor:
        """A zeroed cache leaf ``name`` (a field of ``KVCache`` /
        ``MLACache``) placed by the rules' cache axes."""
        return zeros(shape, dtype, self.mesh,
                     self.rules.spec(_CACHE_AXES[name], shape))

    def cache_block(self, st: ShardedTensor, r: int, j: int) -> torch.Tensor:
        """Row block ``r``'s rows of the cache block at unit ``(r, j)``: a
        view."""
        blk = self.block(st, r, j)
        axes = _axes(st.spec[0]) if st.spec else ()
        if axes == self.batch_axes:
            return blk
        if axes:
            raise ValueError(f"a cache's rows are split over {axes}, the "
                             f"batch over {self.batch_axes}")
        return blk[r * self.rows:(r + 1) * self.rows] if self.dp > 1 else blk

    def seq_blocks(self, st: ShardedTensor, r: int) -> list:
        """``(first position, block)`` of each of row block ``r``'s
        sequence blocks of a cache leaf, in ``model`` order."""
        n = self.parts(st, 1)
        size = st.shape[1] // n
        return [(j * size, self.cache_block(st, r, j)) for j in range(n)]

    # -- recurrent states (heads or channels over model) --------------------

    def blocks_along(self, st: ShardedTensor, r: int, dim: int,
                     n: int) -> list:
        """Row block ``r``'s value of a state leaf cut into ``n`` equal
        blocks along ``dim``, in ``model`` order, to be read and written in
        place: the leaf's own blocks where its spec splits ``dim`` ``n``
        ways over ``model`` (the units' ``rwkv_heads``, ``ssm_heads`` or
        ``conv_dim`` blocks), else slices of its block at ``j = 0`` where
        ``dim`` is whole (a unit computing heads that the leaf holds
        replicated, as ``smoke()``'s two SSM heads on 1×4)."""
        k = self.parts(st, dim)
        if k == n:
            return [self.cache_block(st, r, j) for j in range(n)]
        if k != 1:
            raise ValueError(f"a {st.shape} leaf in {k} blocks along "
                             f"{dim} read as {n}")
        whole = self.cache_block(st, r, 0)
        size = whole.shape[dim] // n
        return [whole.narrow(dim, j * size, size) for j in range(n)]

    def write_seq(self, st: ShardedTensor, r: int, x: torch.Tensor,
                  start: int) -> None:
        """Write ``x`` (row block ``r``'s rows, positions ``start`` on)
        into the sequence blocks that own those positions, in place."""
        end = start + x.shape[1]
        for off, blk in self.seq_blocks(st, r):
            lo, hi = max(start, off), min(end, off + blk.shape[1])
            if lo < hi:
                blk[:, lo - off:hi - off].copy_(x[:, lo - start:hi - start])


class _PSum(torch.autograd.Function):
    """:meth:`ModelSplit.psum` under autograd: the forward is the counted
    reduction, the backward hands each unit's part its row block's
    gradient (on the part's device), with no reduction."""

    @staticmethod
    def forward(ctx, split, width, *flat):
        ctx.width = width
        ctx.devices = [p.device for p in flat]
        rows = [flat[i:i + width] for i in range(0, len(flat), width)]
        return tuple(split._reduce(psum_axes, rows))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(
            None if grads[i // ctx.width] is None
            else grads[i // ctx.width].to(dev)
            for i, dev in enumerate(ctx.devices)))


class _Fan(torch.autograd.Function):
    """:meth:`ModelSplit.fan` under autograd: ``x`` to each of ``n`` units
    (a view where the unit is on ``x``'s device); the backward sums the
    units' gradients over ``model`` (:meth:`ModelSplit._fan_grad`)."""

    @staticmethod
    def forward(ctx, split, r, n, x):
        ctx.split, ctx.r, ctx.device = split, r, x.device
        out = []
        for j in range(n):
            dev = split.device(r, j)
            out.append(x.view_as(x) if dev == x.device else x.to(dev))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return None, None, None, ctx.split._fan_grad(grads, ctx.r,
                                                     ctx.device)
