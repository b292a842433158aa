"""Elastic scaling: reshard live state onto a different mesh.

The port of ``repro/runtime/elastic.py``.  The restart path after losing
(or gaining) a slice: rebuild the mesh from the surviving device set,
re-derive specs from the same logical-axis rules
(:func:`repro_torch.parallel.param_specs_for`), and place every leaf
(:func:`repro_torch.parallel.place`).  Works across any device-count change
as long as the new mesh axes still divide the sharded dims (the rules table
falls back to replication otherwise — see ``ShardingRules.mesh_axes``).

Global-batch invariance on shrink is the caller's policy: either raise
``num_microbatches`` (keep tokens/step constant) or keep per-chip batch and
rescale LR; ``shrink_plan`` computes both options.
"""
from __future__ import annotations

import torch

from repro_torch.optim.tree import tree_map
from repro_torch.parallel.sharding import ShardedTensor, place
from repro_torch.parallel.tensor import PlacedParams


def _to_host(leaf):
    if isinstance(leaf, ShardedTensor):
        return leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf                     # a NumPy array: ``place`` copies it


def remesh(tree, specs_tree, new_mesh):
    """Reshard every leaf of ``tree`` (a tensor, a placed
    :class:`~repro_torch.parallel.ShardedTensor` or a NumPy array; dicts,
    lists and ``NamedTuple`` s such as ``AdamWState`` between them) to its
    spec in ``specs_tree`` on ``new_mesh``: gathered to the host, then
    placed.  Returns the tree of placed tensors; placed parameters
    (:class:`~repro_torch.parallel.tensor.PlacedParams`) anywhere in it
    come back as placed parameters on ``new_mesh``, which the train step
    there takes."""
    out = tree_map(lambda leaf, spec: place(_to_host(leaf), new_mesh, spec),
                   tree, specs_tree)
    return _as_placed(tree, out, new_mesh)


def _as_placed(old, new, mesh):
    """``new`` with each dict that is :class:`PlacedParams` in ``old`` made
    one again, on ``mesh``."""
    if isinstance(old, PlacedParams):
        out = PlacedParams(new)
        out.mesh = mesh
        return out
    if isinstance(old, dict):
        return {k: _as_placed(old[k], v, mesh) for k, v in new.items()}
    return new


def shrink_plan(old_dp: int, new_dp: int, global_batch: int,
                num_microbatches: int):
    """Options for keeping training semantics across a DP-width change."""
    per_chip = global_batch // (old_dp * num_microbatches)
    # option A: same global batch, more microbatches
    mb_needed = -(-global_batch // (new_dp * per_chip))
    # option B: same microbatches, smaller global batch (+ LR rescale)
    new_global = new_dp * num_microbatches * per_chip
    return {
        "keep_global_batch": {"num_microbatches": mb_needed},
        "keep_microbatches": {"global_batch": new_global,
                              "lr_scale": new_global / global_batch},
    }
