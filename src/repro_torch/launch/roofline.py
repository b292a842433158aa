"""Roofline terms of a dry-run cell, counted from the port's own step.

The port of ``repro/launch/roofline.py``.  Three terms per (arch × shape ×
mesh), all per chip per step, on the H100 SXM constants of
:mod:`repro_torch.core.perfmodel`:

    compute    = FLOPs / peak FLOP/s of the compute dtype
    memory     = HBM bytes / HBM rate
    collective = collective bytes / NVLink rate (one direction)

The reference reads them from XLA (``cost_analysis`` and the partitioned
HLO text).  The port has no compiler to ask, so it counts:

* **FLOPs** — what the port's step computes, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` while the step runs on
  ``meta`` tensors (nothing is allocated).  The counter sees the
  matmul-class ops (``mm``, ``bmm``, ``addmm``, convolutions, fused
  attention); element-wise work is not counted.  Per chip is the counted
  global count divided by ``chips``: the ideal partition.
* **HBM bytes** — each argument's per-device block read once, each
  result's written once (:func:`repro_torch.launch.specs.memory_fields`),
  plus the operands and results of the ops the counter sees (global,
  divided by ``chips``).  This stands in for the reference's
  ``fused_bytes_estimate``; XLA's own ``bytes accessed`` has no
  counterpart.
* **Collective bytes** — modelled, not what the port runs: ``train`` is
  charged the ring all-reduce (``2(n−1)/n`` of the bytes) that a
  data-parallel step over several cards would make of its float32
  gradient accumulators over the rules' batch axes, each position holding
  its blocks of the spec table (:func:`gradient_reduction`).  The port's
  step keeps every position on one card with one set of accumulators and
  makes no reduction (:mod:`repro_torch.launch.steps`).  ``prefill`` and
  ``decode`` are charged none.  The model axis's collectives (tensor
  parallelism of the step) are not ported yet, and GSPMD's are not
  modelled.

Counting a whole cell on ``meta`` is too slow for long sequences (the
chunked attention runs a Python loop over chunk pairs), so
:func:`layer_extrapolated` extrapolates, as the reference's
``calibrated_terms`` does: over layers
(1 and 2 layers of each segment kind; the per-layer cost is exact), over
microbatches (one microbatch counted, times their number: each is the same
pass) and, above :data:`SEQ_DIRECT` tokens, over the sequence (counts at
three lengths that are multiples of :data:`SEQ_UNIT`, where the chunking is
the same as at the cell's length, and the quadratic through them: the
counted work is a polynomial of degree ≤ 2 in the length there — chunk
pairs of attention, chunks of the scans, capacity of the experts).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from fractions import Fraction
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.perfmodel import (H100_NVLINK_BW, H100_NVLINK_LAT,
                                        H100_SXM_BF16_DENSE_FLOPS,
                                        H100_SXM_HBM_BW, PEAK_FLOPS)
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.specs import (TUPLE_ENTRY_BYTES, block_bytes,
                                      stacked_leaves)
from repro_torch.models import model as M
from repro_torch.optim.tree import leaves_with_path, tree_map

# -- hardware constants (H100 SXM) -------------------------------------------
PEAK_BF16 = H100_SXM_BF16_DENSE_FLOPS
HBM_BW = H100_SXM_HBM_BW
ICI_BW = H100_NVLINK_BW          # the reference's name for the link rate

#: peak FLOP/s by compute dtype: bfloat16 on the tensor cores (dense), the
#: others outside them
PEAK_BY_DTYPE = {**PEAK_FLOPS, "bfloat16": H100_SXM_BF16_DENSE_FLOPS}

#: longest sequence :func:`layer_extrapolated` counts directly
SEQ_DIRECT = 4096
#: the sequence lengths it extrapolates from are 1, 2 and 3 of these
SEQ_UNIT = 1024

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def no_collectives() -> Dict[str, int]:
    """A collective breakdown of nothing, keyed as the reference's."""
    out = {k: 0 for k in _COLLECTIVES}
    out.update({k + "_n": 0 for k in _COLLECTIVES})
    out["count"] = 0
    return out


def collective_latency(coll: Dict[str, int], mesh_x: int, mesh_y: int,
                       hop_lat: float = H100_NVLINK_LAT) -> float:
    """Latency floor of the collective schedule on an (X, Y) mesh:
    permutes are single-hop; reductions traverse ~the mesh diameter both
    ways (the Eq. 16/17 ``2(X+Y)`` analogue)."""
    diam = 2 * (mesh_x + mesh_y)
    lat = coll.get("collective-permute_n", 0) * hop_lat
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"):
        lat += coll.get(kind + "_n", 0) * diam * hop_lat
    return lat


def analyze(*, flops_per_chip: float, hbm_bytes_per_chip: float,
            collective_bytes_per_chip: float, collective_breakdown=None,
            peak_flops: float = PEAK_BF16) -> Dict:
    """Roofline terms from counted per-chip work (per step)."""
    flops = float(flops_per_chip)
    mem_bytes = float(hbm_bytes_per_chip)
    coll_total = float(collective_bytes_per_chip)
    t_comp = flops / peak_flops
    t_mem = mem_bytes / HBM_BW
    t_coll = coll_total / ICI_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    return {
        "flops_per_chip": flops,
        "hbm_bytes_per_chip": mem_bytes,
        "collective_bytes_per_chip": coll_total,
        "collective_breakdown": dict(collective_breakdown
                                     or no_collectives()),
        "t_compute": t_comp, "t_memory": t_mem,
        "t_collective": t_coll,
        "t_total": max(t_comp, t_mem) + t_coll,
        "bound": max(terms, key=terms.get),
    }


# ---------------------------------------------------------------------------
# counting on meta
# ---------------------------------------------------------------------------

class _OperandBytes(TorchDispatchMode):
    """Bytes of the operands and results of every op in ``ops`` (the
    counter's registry), as the op sees them."""

    def __init__(self, ops):
        super().__init__()
        self.ops = ops
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket in self.ops:
            flat, _ = tree_flatten((args, kwargs, out))
            self.bytes += sum(t.numel() * t.element_size() for t in flat
                              if isinstance(t, torch.Tensor))
        return out


def count(fn, *args) -> Dict[str, int]:
    """``{"flops", "matmul_bytes"}`` of one call ``fn(*args)`` (global:
    every op of the call)."""
    fc = FlopCounterMode(display=False)
    with fc, _OperandBytes(fc.flop_registry) as ob:
        fn(*args)
    return {"flops": int(fc.get_total_flops()), "matmul_bytes": int(ob.bytes)}


def _tokens(cfg, rows: int, s: int) -> torch.Tensor:
    """int64 meta tokens, the port's step's index dtype (a token's dtype
    changes no counted op)."""
    shape = (rows, s) if cfg.n_codebooks == 1 else (rows, s, cfg.n_codebooks)
    return torch.empty(shape, dtype=torch.int64, device="meta")


def count_pass(cfg, kind: str, rows: int, s: int) -> Dict[str, int]:
    """Counts of one pass of the port's step for ``kind`` over ``rows``
    rows at sequence length ``s`` (a train step of one microbatch, a
    prefill, a decode against an ``s``-token cache), on meta tensors."""
    cfg = dataclasses.replace(cfg, num_microbatches=1)
    params = M.init_params(cfg, device="meta")
    if kind == "train":
        opt = steps_mod.make_opt_state(params)
        tok = _tokens(cfg, rows, s)
        return count(steps_mod.make_train_step(cfg), params, opt,
                     {"tokens": tok, "labels": tok})
    if kind == "prefill":
        return count(steps_mod.make_prefill_step(cfg), params,
                     _tokens(cfg, rows, s))
    cache = M.init_cache(cfg, rows, s, device="meta")
    return count(steps_mod.make_decode_step(cfg), params, cache,
                 _tokens(cfg, rows, 1), s - 1)


def _quadratic_at(xs, ys, x) -> int:
    """The quadratic through three points, at ``x`` (exact: Lagrange over
    fractions of integer counts)."""
    total = Fraction(0)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        term = Fraction(yi)
        for j, xj in enumerate(xs):
            if j != i:
                term *= Fraction(x - xj, xi - xj)
        total += term
    return round(total)


def count_cell(cfg, shape, *, seq_direct: int = SEQ_DIRECT
               ) -> Dict[str, int]:
    """Global counts of one step of the cell ``shape`` for ``cfg`` (every
    layer of ``cfg``): a train step is its microbatches' passes (one pass
    counted, times their number); a train or prefill step longer than
    ``seq_direct`` tokens is the quadratic through counts at 1, 2 and 3 ×
    :data:`SEQ_UNIT` tokens.  Counts do not depend on the mesh, so each is
    made once a process."""
    return dict(_count_cell(cfg, shape, seq_direct))


@functools.lru_cache(maxsize=None)
def _count_cell(cfg, shape, seq_direct: int) -> Dict[str, int]:
    mb = cfg.num_microbatches if shape.kind == "train" else 1
    rows = shape.global_batch // mb
    s = shape.seq_len
    if shape.kind == "decode" or s <= seq_direct:
        c = count_pass(cfg, shape.kind, rows, s)
    else:
        if s % SEQ_UNIT:
            raise ValueError(f"sequence {s} is not a multiple of {SEQ_UNIT}")
        xs = [SEQ_UNIT * i for i in (1, 2, 3)]
        ys = [count_pass(cfg, shape.kind, rows, x) for x in xs]
        c = {k: _quadratic_at(xs, [y[k] for y in ys], s) for k in ys[0]}
    return {k: mb * v for k, v in c.items()}


# ---------------------------------------------------------------------------
# calibrated per-step costs
#
# A whole cell of a deep model is slow to count, so, as the reference does
# with its flat 1-layer and 2-layer compiles, count variants with one and
# two layers of each segment kind and extrapolate.  A layer's cost depends
# on its kind alone, so the per-layer cost B_k is exact,
#
#     metric(full) = f(one layer of each kind) + Σ_kind (T_k − 1) · B_k
#
# The reference's variants keep every segment (one layer each); the port's
# keep the first segment of each kind, the same sum with fewer layers to
# run (zamba2: 2 in place of 18).
# ---------------------------------------------------------------------------

_METRICS = ("flops", "matmul_bytes")


def _variant_cfg(cfg, seg_counts):
    kinds = list(dict.fromkeys(k for k, _ in cfg.segments))
    segments = tuple((k, seg_counts.get(k, 1)) for k in kinds)
    return dataclasses.replace(cfg, segments=segments,
                               n_layers=sum(c for _, c in segments))


def layer_extrapolated(cfg, shape, *, seq_direct: int = SEQ_DIRECT
                       ) -> Dict[str, int]:
    """Global counts of the full cell from the 1- and 2-layer variants."""
    t_k: Dict[str, int] = {}
    for kind, n in cfg.segments:
        t_k[kind] = t_k.get(kind, 0) + n
    f_a = count_cell(_variant_cfg(cfg, {}), shape, seq_direct=seq_direct)
    out = dict(f_a)
    for kind, total in t_k.items():
        f_b = count_cell(_variant_cfg(cfg, {kind: 2}), shape,
                         seq_direct=seq_direct)
        for m in _METRICS:
            out[m] += (total - 1) * (f_b[m] - f_a[m])
    return out


def gradient_reduction(spec, mesh) -> Dict[str, int]:
    """The modelled collective breakdown of one step of the cell ``spec``
    (:func:`repro_torch.launch.specs.cell_specs`): where the rules shard a
    train microbatch's rows over more than one position, the ring
    all-reduce that a data-parallel step over several cards would make of
    its float32 accumulators over those axes once a step, ``2(n−1)/n`` of
    the bytes each position holds of them (its parameter blocks of the
    spec table, in float32); nothing else.  The one-card port makes no
    such reduction."""
    coll = no_collectives()
    if spec["shape"].kind != "train":
        return coll
    rows = spec["shape"].global_batch // spec["cfg"].num_microbatches
    plan = steps_mod.batch_axes(spec["rules"], rows)
    if plan is None:
        return coll
    _, dp = plan
    acc = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                         device="meta"),
                   spec["args"][0].tree())
    held = block_bytes(acc, spec["in_specs"][0], mesh)
    coll["all-reduce"] = int(2 * (dp - 1) * held // dp)
    coll["all-reduce_n"] = 1
    coll["count"] = 1
    return coll


def terms(spec, mesh, counts: Dict[str, int], memory: Dict[str, int]
          ) -> Dict:
    """The roofline record of a cell from its global ``counts``
    (:func:`count_cell` / :func:`layer_extrapolated`) and its
    ``memory`` fields (:func:`repro_torch.launch.specs.memory_fields`)."""
    chips = mesh.size
    out_bytes = memory["output_size_in_bytes"]
    n_out = stacked_leaves(spec["outs"])
    if n_out > 1:                 # the tuple's index table moves no data
        out_bytes -= TUPLE_ENTRY_BYTES * n_out
    coll = gradient_reduction(spec, mesh)
    rec = analyze(
        flops_per_chip=counts["flops"] / chips,
        hbm_bytes_per_chip=(memory["argument_size_in_bytes"] + out_bytes
                            + counts["matmul_bytes"] / chips),
        collective_bytes_per_chip=sum(coll[k] for k in _COLLECTIVES),
        collective_breakdown=coll,
        peak_flops=PEAK_BY_DTYPE[spec["cfg"].compute_dtype])
    rec["matmul_bytes_per_chip"] = counts["matmul_bytes"] / chips
    return rec


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N_active·B (decode), GLOBAL."""
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n_active * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n_active * d
    return 2.0 * n_active * shape.global_batch      # decode: one token


def count_params(cfg) -> Dict[str, int]:
    """Total + active (MoE-discounted) parameter counts from the meta
    parameters."""
    params = M.init_params(cfg, device="meta")
    total = 0
    routed = 0
    for path, leaf in leaves_with_path(params.tree()):
        n = math.prod(leaf.shape)
        total += n
        if any(str(n_) in ("w_gate", "w_up", "w_down") for n_ in path):
            routed += n
    active = total - routed
    if cfg.moe:
        active += routed * cfg.moe.top_k // cfg.moe.n_experts
    return {"total": total, "active": active}
