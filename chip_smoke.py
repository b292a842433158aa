#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

Drives the port (``src/repro_torch``) and nothing of the JAX package:

1. ``build``           — builds every kernel of the main paths from
                         ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a),
                         one nvcc per source, all started together;
2. ``kernel_vs_ref``   — holds K1 bitwise against its plain PyTorch version
                         on the card, at float32 and float64, through both
                         routes of the column entry (once at k = 1, k times
                         — the sweep — at k > 1; a hazard body through its
                         hazard instantiation; every launch checked to go
                         through the route ``fused_entry`` names and to
                         count as a hazard launch exactly for a hazard
                         body): the heat3d body at its full main-path shapes
                         (k = 1 and the auto tile, a sweep), in the padded
                         mode and in the margin mode (resident inputs,
                         ping-pong outputs; M = k·h and k·h + 1, interiors
                         also equal to the padded mode's, margins
                         untouched), the hazard body of ``record_coupled``
                         at 512×512×128 at k = 1 and its auto tile, padded
                         and margin (M = k·h), float32 and float64,
                         small multi-field, off-axis, multi-update bodies at
                         k = 1 and k = 2 in both modes (one with a hazard),
                         the column entry's edge cases (a second update
                         reading the first's new value at dz = ±1, nz = 200,
                         a 3×3×2 coarse level), and ``make`` with a
                         remainder launch;
3. ``dual_dot_vs_ref`` — K2 on 512×512×128 float32 and float64 operands,
                         distinct and aliased as pipelined CG passes them,
                         within ``1e-5·Σ|aᵢbᵢ|`` (f32) / ``1e-13·Σ|aᵢbᵢ|``
                         (f64) of the plain version evaluated in float64,
                         and bitwise deterministic;
4. ``transfer_vs_ref`` — K3 and K4 bitwise against their plain versions at
                         every level pair of the 512×512×128 hierarchy, at
                         float32 and float64 (random coarse levels, Moat
                         included); each pair's float32 time queued behind
                         a sleep kernel beside its bytes bound, and K4's
                         beside ``PREDICTED``;
5. ``heat3d``          — ``HeatConfig()`` (512×512×128 float32) through
                         ``make(backend="pallas")`` at ``time_tile=1`` and at
                         the auto pick, each on the halo-resident layout (the
                         default; K1's margin mode) and with
                         ``resident=False`` (the repacking step; K1's padded
                         mode): all four bitwise equal, and checked against
                         the ``jit`` roll interpreter on the card, with K1's
                         launch counts by mode equal to the engine's and
                         every launch of the k = 1 runs through the k = 1
                         entry and every launch of the auto runs through
                         the sweep (one sweep and k sub-steps per launch);
                         ms per step by CUDA events after a warm-up, host µs
                         per step (median of 5 runs) and per K1 launch
                         (median of 50), the device idle share with the profiler
                         off and the device breakdown of all four, beside
                         the bytes bound and beside ``PREDICTED``; the device
                         allocations per step of the resident k = 1 and auto
                         loops (must be 0);
5b. ``hazard_make``    — ``record_coupled`` (the hazard body) at
                         ``HeatConfig()``'s 512×512×128 float32 grid through
                         ``make(backend="pallas")`` at the auto tile,
                         resident and ``resident=False``: bitwise equal,
                         within the ``jit`` tolerance of ``heat3d`` against
                         the roll interpreter, every launch a hazard sweep,
                         0 device allocations per resident step; ms per step
                         by CUDA events, and the hazard kernel's k = 8 and
                         k = 1 margin launches timed beside their bounds and
                         ``PREDICTED``;
5c. ``ensemble_make``  — ``HeatConfig()`` with 8 members from ``--seed``
                         (the interior moved by up to ±50 K) through
                         ``Ensemble.make`` at k = 1 and the auto tile,
                         resident and ``resident=False``: the four runs
                         bitwise equal, each member bitwise its own single
                         ``make``, every K1 launch a batched one through the
                         route its tile names, as many as the engine's,
                         0 fallbacks, 0 device allocations per resident
                         step; K1 built for 8 members (k = 1 and the auto
                         tile, margin and padded mode) bitwise against its
                         plain version and against 8 single launches; ms
                         per step and per member-step by CUDA events, host
                         µs per member-step, idle share, the batched
                         launches' times beside ``PREDICTED``;
6. ``solve_heat3d``    — ``record_implicit(HeatConfig())`` through
                         ``solve(backend="pallas")`` with ``cg``, ``pipecg``
                         and ``cg`` + ``precondition="mg"`` at
                         ``tol = 1e-5·‖b‖``: the outcome word, iterations,
                         K1–K4 launches (K1 through its k = 1 entry), an
                         independent float64 residual,
                         the difference from ``backend="jit"``, ms per solve
                         and per iteration, the device time by kernel and
                         the device idle share;
6b. ``ensemble_solve`` — BTCS at 512×512×128 float32 with 4 members through
                         ``solve(ensemble, …)``: cg and pipecg from
                         per-member states from ``--seed``, bicgstab with
                         per-member diffusivities (``record_varcoef_btcs``);
                         every member ``CONVERGED``, its float64 relative
                         residual ≤ 1e-5 and within 10·tol of its own
                         single solve; every K1 launch a batched one;
7. ``mg_poisson``      — ``record_poisson`` at 512×512×128 with a unit-norm
                         random interior right-hand side from ``--seed``,
                         ``method="mg"`` and ``cg`` + ``precondition="mg"``;
8. ``legacy_kernels_vs_ref`` — K6 and K7 bitwise against their plain
                         versions at float32 and float64: K6 on the padded
                         514×514×128 brick (1×1 mesh), the padded 258×258×128
                         brick (2×2 mesh) and the reference's test shapes, K7
                         with random planes on the 1×1 mesh's brick, on
                         each brick of a 2×2 mesh and, as the middle brick
                         of a 3×3 mesh, on the reference's test shapes and
                         a ragged 70×37×130 one (two runs the same bits);
                         K7 timed on the 512×512×128 and 256×256×128 bricks
                         with its grid and tile depth; K5's ``Ap`` bitwise, its
                         dot within ``1e-5·Σ|c·Ap|`` (f32) / ``1e-13·Σ|c·Ap|``
                         (f64) of the plain version in float64, each of its
                         per-tile partials within the same share of its
                         tile's ``Σ|c·Ap|`` of ``spmv_dot_tiles_ref`` in
                         float64, as many as ``spmv_launch_shape`` says, and
                         bitwise deterministic, on the same bricks and a
                         ragged 72×39×130 one; K5 timed on the 514×514×128
                         and the 258×258×128 padded bricks (the 1×1 and 2×2
                         meshes' bricks), beside ``PREDICTED``;
9. ``legacy_ftcs``     — ``HeatConfig()`` through ``make_sharded_ftcs`` with
                         all five variants on a 1×1 mesh, then a random field
                         from ``--seed`` on 1×1 and 2×2 meshes: every variant
                         and mesh bitwise equal, ``ftcs_solve`` within 1 f32
                         ulp of the field per step, K6/K7 launched once per
                         brick per step; ms per step and device idle share;
10. ``legacy_btcs``    — ``make_sharded_iteration`` (cg, pipecg, chebyshev;
                         with and without kernels; 1×1 and 2×2 meshes) from a
                         seeded 512×512×128 state for 20 iterations: kernel
                         vs plain and 2×2 vs 1×1 within 4 f32 ulp of the field
                         per iteration and their recurrence scalars within
                         1e-4 relative — cg and pipecg at their last iteration
                         with ‖r‖ above 1e-6·‖r₀‖, chebyshev bitwise at the
                         20th — one K5 per brick per iteration
                         and one K2 per brick per pipecg iteration; ms per
                         iteration on both meshes; one ``btcs_solve`` cg
                         step with its independent float64 residual;
10b. ``sharded_make`` — ``HeatConfig()`` on a 2×2 mesh of the one card
                         (four 256×256×128 bricks, one process) through
                         ``make(backend="pallas", mesh=…)`` at k = 1 and the
                         auto tile, resident and ``resident=False``: all
                         four bitwise equal to the single-device ``make``,
                         ``backend="shard_map"`` within ``heat3d``'s 2e-4 of
                         the single-device ``jit`` over 16 steps, K1
                         launched 4 × the engine's launch events, each
                         through the route ``fused_entry`` names, 0 device
                         allocations per resident step; K1 built for the
                         bricks (``wrap=False``, the brick's global origin
                         as coords; k = 1 and the auto tile, margin mode,
                         float32 and float64) bitwise against its plain
                         version on every brick's refreshed inputs, and the
                         split launch of those bricks (the interior in
                         region mode, four shells on ``exchange_slabs``'
                         windows, each at the brick's global origin plus
                         the region's) bitwise against its plain versions
                         and the monolithic launch's cells; ms per
                         step by CUDA events, host µs per step, idle share,
                         K1's per-brick time (queued) beside its bound and
                         ``PREDICTED``;
10c. ``sharded_solve`` — BTCS 512×512×128 (``record_implicit``) with cg,
                         pipecg and cg + mg on the 2×2 mesh: ``CONVERGED``,
                         float64 residual ≤ 1e-5, within 2e-4 (cg, pipecg)
                         / 1e-4 and ±1 iteration (cg + mg) of the
                         single-device solve; K1 per brick through its
                         k = 1 entry, K2 per brick (pipecg, cg + mg), K3/K4
                         on the gathered hierarchy; ms per solve;
10d. ``overlap_make`` — ``HeatConfig()`` through ``make(overlap=True)``
                         (the interior/boundary split, resident) on one
                         device and on the 2×2 mesh, k = 1 and the auto
                         tile, and 8 members at k = 1: each run bitwise
                         its ``overlap=False`` run, the engine's split
                         counts (one interior, four shells, one overlapped
                         exchange per launch), K1 launched once in region
                         mode and four times padded per brick per launch
                         through the route its tile names, ``overlap=
                         "auto"`` plans unsplit, 0 device allocations per
                         split step; split and monolithic ms per step, host
                         µs per step, idle share, and from the profiler's
                         trace whether the slab copies on the side stream
                         ran beside a K1 launch; the interior's k = 1 and
                         auto launches and each shell's (queued) beside
                         their bounds and ``PREDICTED``.  (``kernel_vs_ref``
                         holds the split launch itself: the interior of
                         ``split_regions`` in region mode and each shell's
                         padded launch on its ``strip_window``, bitwise
                         against their plain versions and the monolithic
                         launch's cells, heat3d at k = 1 and the auto tile
                         with 1 and 8 members and the hazard body, f32 and
                         f64.)
10e. ``health_make``  — ``HeatConfig()`` through ``make(check_finite=64)``
                         (resident) on one device and the 2×2 mesh at
                         k = 1 and the auto tile, and 8 members at k = 1:
                         each run bitwise its unguarded run, the
                         reference's probe count (entry, one per full
                         chunk, one per tail), K1 launched as unguarded,
                         0 fallbacks; guarded and unguarded ms per step
                         (CUDA events, in turns), host µs per step and
                         idle share; the one-device k = 1 overhead held
                         to ``HEALTH_BUDGET`` (2 %) in the steady state of
                         ``benchmarks/health_overhead.py`` (2048-step
                         runs, both read back, in shuffled turns, the
                         floor of each side); ``T ← 4·T`` with one
                         cell overflowing at step 100 on one device and
                         on the mesh: ``NumericalFault`` at the first
                         probe after it, ``last_good`` bitwise the
                         unguarded run at the last good probe; the
                         ``time_tile=4`` retry: one recovery attempt, two
                         faults;
10f. ``health_solve`` — BTCS at 512×512×128 (tol = 1e-5·‖b‖) with a NaN in
                         the state: every method ``NAN_RESIDUAL``; healthy
                         cg and pipecg with ``RecoveryPolicy()`` bitwise
                         the plain solves, the ladder never entered; 4
                         members with one poisoned, the other three
                         bitwise an all-healthy batch's; the ladder at the
                         reference tests' sizes: BiCGSTAB's breakdown on a
                         2×2 rotation, the ladder's rungs on an
                         antisymmetric stencil with bicgstab (restart,
                         float64) and cg (escalation, float64), and the
                         float32 overflow that converges on the float64
                         rung, each against its ``RecoveryTrace``;
10g. ``adjoint_solve`` — ``make_differentiable_solver`` at 512×512×128:
                         cg, pipecg and cg + mg on BTCS (symmetric: no
                         kernel built by the backward), bicgstab on
                         variable-coefficient BTCS (the transposed taps
                         built at build time), each gradient's
                         dot-product test ``⟨Aᵀ⁻¹ x̄, b⟩ = ⟨x̄, A⁻¹ b⟩``
                         within ``4·tol·(‖x̄‖ + ‖b‖)``, forward and
                         backward ms and launches; then
                         ``examples/inverse_diffusivity.py`` at its own
                         size, float64, below 1e-2 relative error;
10h. ``adjoint_make`` — the differentiable heat3d ``make``
                         (``differentiable_runner``, k = 1, 64 steps, and
                         16 on the 2×2 mesh): the forward bitwise the
                         repacking ``make``, the checkpointed gradient of
                         ``sum(T²)`` bitwise the all-residuals one, the
                         mesh's forward bitwise and its gradient within 2
                         f32 ulp a step of one device's, the dot-product
                         test ``⟨J v, w⟩ = ⟨v, Jᵀ w⟩``, peak device memory
                         of both ladders, forward and backward ms;
10i. ``service``      — the simulation service (``repro_torch.service``)
                         at ``HeatConfig()``'s 512×512×128 float32 grid:
                         the port's own ``python -m repro_torch.service
                         --smoke`` in process (16 requests of 48 steps, 4
                         workers, every gate); heat3d and advdiff step
                         requests of 200 steps and jacobi3d at
                         ``time_tile=2`` bitwise their ``make``; a request
                         checkpointing every 50 steps with a fault
                         injected at step 100 (retried, restored, bitwise);
                         80 steps, a new service and ``resume=True`` to 200
                         (only 120 rerun, bitwise); 8 requests coalesced by
                         ``micro_batch=8`` (``stats.batch == 8``, each
                         bitwise its single request); heat3d and jacobi3d
                         on the 2×2 mesh of the card bitwise the
                         single-device service; cg and pipecg
                         ``SolveRequest``s ``CONVERGED`` to 1e-5·‖b‖ (float64
                         residual ≤ 1e-5) and a NaN-initialized solve
                         failing fast with ``NumericalFault``; a stream of 32
                         heat3d requests (200 steps, 4 workers, 4
                         signatures warm): requests/s, p50/p99 latency,
                         mean queue wait, device ms per served step beside
                         ``make``'s, idle share; host µs per chunk,
                         allocations per chunk in the steady state (must
                         be 0), checkpoint write and restore seconds at
                         134 MB a field, kernels built after warm-up (must
                         be 0); its K1 launches (margin, sweep, padded,
                         members, bricks) and K2's added to the rows they
                         belong to;
10j. ``cost_model``  — the measured cost model at ``HeatConfig()``'s
                         512×512×128 float32: the resident fused step at
                         k = 1, 2, 4, 8 and the split step at k = 1, 4
                         (CUDA events over ``--steps`` steps);
                         ``calibrate_program`` at k = 1, 2, 4 on the card
                         (the entry, its seconds, ``predict_step_us``
                         beside every measured schedule); ``make`` with
                         ``time_tile=None`` and ``overlap="auto"`` on the
                         calibrated model: its k and split,
                         ``cost_model_hits`` ≥ 1, ms per step, bitwise the
                         uncalibrated ``make``, 0 allocations per step; a
                         ``cpu``-tagged entry gives the card plan no hit; a
                         manifest written on the card reloads to an equal
                         entry; Eq. 12's rate beside the measured one; the
                         calibration's and the calibrated make's K1
                         launches added to the rows of their routes;
10k. ``lm_serve``     — the LM serving path (``repro_torch.{models,launch}``,
                         no kernel of ``kernels/``): qwen3-0.6b at full
                         width and 28 layers in bfloat16 through ``serve``
                         (batch 8, prompt 512, gen 64; seeded weights):
                         tokens in range, the served tokens replayed by
                         ``prefill`` + ``make_decode_step``; prefill ms and
                         tokens/s beside its operations bound, decode ms a
                         token and tokens/s beside its bytes bound, idle
                         share, peak memory; teacher-forced decode (448 of
                         512 prefilled) against the forward, bfloat16 and
                         float32 (the same weights cast, TF32 off), within
                         ``LM_BF16_REL`` / ``LM_F32_REL`` of max|logit|;
                         bfloat16 against float32 last-token logits
                         (relative Frobenius, ``LM_BF16_VS_F32``); the card
                         against the CPU at ``smoke()`` with the same
                         weights within ``LM_CARD_CPU_REL``; no kernel of
                         ``kernels/`` launched or built; the nine other
                         architectures at published width, each block
                         kind's first segment capped at two layers, float32
                         teacher-forced (prompt 64, 8 steps) within
                         ``LM_F32_REL``;
10l. ``lm_train``     — LM training on the card
                         (``repro_torch.{optim,data}``,
                         ``launch/{steps,train}.py``, no kernel of
                         ``kernels/``), under
                         ``torch.use_deterministic_algorithms``: qwen3-0.6b
                         at full width, its first ``LM_TRAIN_LAYERS`` (16)
                         of 28 layers (the smoke's budget; ``lm_train_mesh``
                         trains all 28), in bfloat16 with its
                         ``remat="dots"`` and 8 microbatches, 24 steps of
                         ``make_train_step`` on ``TokenDataset`` (8 × 512):
                         every loss and gradient norm finite, the loss
                         falling (mean of the last 5 below the first 5's);
                         step ms (CUDA events, median after 2 warm-up
                         steps), tokens/s, idle share, peak memory beside
                         the operations bound and the memory floor; a
                         second run through ``launch/train.py``'s
                         ``ResilientLoop`` with a fault in step 13 and
                         checkpoints every 8 steps, bitwise the first
                         run's parameters, moments and step; ``"dots"``
                         against ``"none"`` on one batch, bitwise; 4
                         compressed steps (finite, step 1's loss the
                         uncompressed one's); the card against the CPU
                         for one step at ``smoke()`` in float32 within
                         the CPU parity tests' bounds; no kernel of
                         ``kernels/`` launched or built;
10m. ``lm_train_mesh`` — LM training on a 2×2 (data, model) mesh of the
                         card (``repro_torch.parallel``,
                         ``launch/{mesh,steps,train}.py``,
                         ``runtime/elastic.py``, ``psum_compressed``; no
                         kernel of ``kernels/``), under deterministic
                         algorithms: qwen3-0.6b at full width and 28 layers
                         in bfloat16, ``"dots"``, 8 microbatches, 16 × 512
                         rows (each replica one row of each microbatch)
                         through ``launch/train.py::build`` and the step
                         under ``use_sharding(rules)``: one warm-up step
                         under the profiler (the card's kernels only: busy
                         time, and the idle share of a timed step with it
                         off), three timed (CUDA events; tokens/s), peak memory
                         beside one 1×1 step's;
                         the 2×2 step against the 1×1 step from the same
                         weights and batch within ``LM_MESH_BF16_REL``;
                         after step 2 ``remesh`` of {params, opt} onto 1×2
                         (bitwise) and the next step there with
                         ``shrink_plan``'s 16 microbatches: its loss,
                         gradient norm, parameters and moments bitwise the
                         2×2 run's own step 3's; at ``smoke()`` in
                         float32 2×2 against 1×1 within ``lm_train``'s
                         card-against-CPU bounds;
                         ``psum_compressed`` on the card bitwise its CPU
                         run; no kernel of ``kernels/`` launched or built;
10n. ``dryrun``        — the dry-run analysis (``launch/{specs,roofline,
                         heat_cell,dryrun}.py``): qwen3-0.6b's three cells
                         through ``run_cell`` on the 16×16 and 2×16×16
                         meshes on ``meta`` (each record and its host
                         seconds; the card's allocated bytes unchanged;
                         every ``t_total > 0``); the ``lm_train`` model at
                         full depth (bfloat16, AdamW, 8 × 512) on a 1×1
                         mesh: ``argument_size_in_bytes`` equal to the
                         bytes ``init_params`` + ``make_opt_state`` + the
                         batch request on the card (what the allocator
                         holds beyond that is read); ``run_heat_cells``
                         on a 2×2 mesh of the card at the production brick
                         128×128×512 (256×256×512): each variant's ms a
                         step (CUDA events) beside its modelled ``t_total``
                         and 4 × ``t_total``, the five FTCS variants
                         bitwise, ``implicit_cg_kernel``'s state after one
                         iteration against ``implicit_cg``'s at
                         ``legacy_btcs``'s bounds, K5/K6/K7 launched per
                         brick there; on one brick K6 and K7 bitwise their
                         plain versions, K5's ``Ap`` bitwise and its dot
                         within ``K5_REL`` of Σ|c·Ap|, and each timed
                         (queued);
11. ``kernels``        — one JSON line describing every kernel of the paths
                         (K1 on six rows: the k = 1 entry in the padded and
                         the margin mode, the sweep at the auto tile, and
                         the column entry on the hazard body — its launches
                         those of ``hazard_make``, its k = 8 time beside the
                         sweep schedule's bound, its k = 1 time beside its
                         own; two rows for K1 built for 8 members, the
                         k = 1 entry (the ensemble phases' k = 1 launches)
                         and the sweep, timed in margin mode beside 8 ×
                         the single bound; K5's row adds its launches by
                         mesh, its partial count and its times on the 2×2
                         mesh's brick; K3's and K4's rows count the launches
                         of ``solve_heat3d``, ``mg_poisson`` and
                         ``sharded_solve``, in all and by level pair, with
                         each pair's time; K2's adds ``sharded_solve``'s;
                         two rows for K1 on the 2×2 mesh's bricks, the k = 1
                         entry and the sweep, timed per brick in margin
                         mode, their launches by mesh and by mode; two rows
                         for the overlap's split launch: the interior in
                         region mode (k = 1, its auto-tile sweep beside it)
                         and the shells' padded launches (the mean of the
                         four at k = 1), launches by tile; the health,
                         adjoint, service and cost_model phases' launches
                         added to the rows of their routes, by phase in
                         ``launches_by_phase``).

Each main path (``heat3d``, ``hazard_make``, ``ensemble_make``,
``solve_heat3d``, ``ensemble_solve``, ``mg_poisson``, ``legacy_ftcs``,
``legacy_btcs``, ``sharded_make``, ``sharded_solve``, ``overlap_make``,
``health_make``, ``health_solve``, ``adjoint_solve``, ``adjoint_make``,
``service``, ``cost_model``, ``dryrun``) runs with the launch counters set to 0 just before it and read just after,
and fails if one of its kernels was not launched (``lm_serve``,
``lm_train`` and ``lm_train_mesh``: if one was).  K1's k = 1 rows on the
padded field, on 8
members and on the 2×2 mesh's bricks carry ``F.conv3d``'s time as their
library call (``heat3d``, ``ensemble_make``, ``sharded_make``: one call
on the padded field, the 8 padded members, one padded brick; within one
float32 ulp of K1 on the cells the body updates).  Then the card's name and
power limit, and last the result line.  Any failed check raises: the script exits
non-zero and prints no result line.  Without a CUDA device it exits
non-zero before printing anything.

    python3 chip_smoke.py [--steps 200] [--seed 0]
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
#: ``lm_train`` runs under ``torch.use_deterministic_algorithms``, which
#: needs cuBLAS's workspace fixed before cuBLAS starts; ":4096:8" (32 MiB)
#: is PyTorch's own default on Hopper, so the other phases are unchanged
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

#: what K1's sweep (k > 1 through the column entry) and K5's and K7's
#: x-marching kernels (K4's, K5's and K7's) were predicted to give on one
#: NVIDIA H100 80GB HBM3 at 700 W, each written before its first run on a
#: card (PERF.md §6): a k = 8 sweep ≈ 8 × the 0.3139 ms margin-mode k = 1
#: launch × 1.028 (the regions' mean area over the brick's); the k = 1
#: numbers are the last measured ones, which the change must keep; phases
#: ``heat3d``, ``transfer_vs_ref``, ``legacy_kernels_vs_ref`` and
#: ``legacy_ftcs`` print it beside what they measure
PREDICTED = {
    "card": "NVIDIA H100 80GB HBM3, 700 W",
    "k1_entry_ms": {"padded": 0.3148, "margin": 0.3139},
    "sweep_entry_ms": {"margin": 2.58},
    "ms_per_step": {"k1": 0.3246, "k1_repack": 0.5836, "auto": 0.33,
                    "auto_repack": 0.36},
    "host_us_per_step": {"auto": 30.0},
    "allocations_per_step": {"k1": 0, "auto": 0},
    # K5 marching along x (written before its first run; PERF.md §6):
    # no slower than K6 (0.1340 ms), about 1.4x its bound at 514x514x128;
    # the partial sum within 5 us of the kernel alone
    "k5_ms": {"514x514x128": 0.11, "258x258x128": 0.030},
    "k5_with_partial_sum_over_ms_us": 5.0,
    # K7 marching along x as K5 does (written before its first run;
    # PERF.md §6), from the one-thread-per-cell kernel's 0.1700 ms and
    # 0.1836 ms/step: no slower than K6 (0.1327); the 2x2 step
    # host-bound, within its spread
    "k7_ms": {"512x512x128": [0.10, 0.115], "256x256x128": 0.030},
    "legacy_ftcs_planes_ms_per_step": {
        "1x1": 0.13, "2x2": "within the spread of 0.4775 (host-bound)"},
    # K4 marching along x (written before its first timed run; PERF.md §6),
    # from the grid-stride kernel's 0.1831 ms: 1.2-1.45x the 0.0452 ms
    # bound at 257x257x65 -> 512x512x128 float32; each coarser pair no
    # slower than before; K3 within 3 %; the solves' iteration counts and
    # bits unchanged
    "k4_ms": {"512x512x128": [0.055, 0.065]},
    "k3_ms_within": 0.03,
    # K1's hazard bodies through the column entry's hazard instantiation
    # (written before its first timed run; PERF.md §6), from the generic
    # entry's 52.58 ms: the coupled body at 512x512x128 float32, margin
    # mode, has about 2.5x heat3d's taps a cell and 2.5x its bytes, and
    # heat3d's sweep takes 3.9x its schedule bound, so the k = 8 launch
    # takes 3-5.5x its 1.65 ms schedule bound; the k = 1 launch 3-5.5x its
    # 0.2013 ms bound; heat3d's k = 1 and sweep launches unchanged within
    # 1 % (their code is the same)
    "hazard_k8_margin_ms": [5.0, 9.0],
    "hazard_k1_margin_ms": [0.6, 1.1],
    "hazard_make_ms_per_step": [0.65, 1.2],
    "hazard_allocations_per_step": 0,
    # K1's member axis (written before its first timed run; PERF.md §6):
    # HeatConfig() with B = 8 members, margin mode; B members move B times
    # the bytes, so each launch about B times the single one (8 x 0.316 ms;
    # bound 8 x 0.0804 = 0.643 ms, and 8 x 2.59 ms for the k = 8 sweep); a
    # resident make's ms per member-step as the single run's 0.328 ms; the
    # host's µs per member-step at most a quarter of the single run's
    # 158-173 µs per step
    "ensemble_members": 8,
    "ensemble_k1_margin_ms": [2.3, 2.7],
    "ensemble_sweep_margin_ms": [19.0, 22.0],
    "ensemble_ms_per_member_step": {"k1": [0.30, 0.34]},
    "ensemble_host_us_per_member_step": {"k1": 43.0},
    "ensemble_allocations_per_step": {"k1": 0, "auto": 0},
    # sharding on a 2x2 mesh of the one card (written before its first
    # timed run; PERF.md §6): HeatConfig() as four 256x256x128 bricks, one
    # process.  K1 per brick about a quarter of the 512x512x128 launch
    # (0.3141 ms k = 1, 2.59 ms k = 8 sweep; a 256-wide brick's regions
    # are 1.055x its area against 1.028x), so 3.9-4.2x its 0.0201 ms bound;
    # the resident k = 1 step's four launches 0.32 ms of device time plus 16
    # slab copies, host-paced at 250-400 us of Python per step (four
    # launchers, four refreshes of four transfers); the auto (k = 8) step
    # amortizes it 8x; 0 allocations per resident step
    "sharded_mesh": [2, 2],
    "sharded_k1_per_brick_ms": [0.078, 0.086],
    "sharded_sweep_per_brick_ms": [0.64, 0.72],
    "sharded_ms_per_step": {"k1": [0.35, 0.45], "auto": [0.33, 0.36],
                            "k1_repack": [0.60, 0.75],
                            "auto_repack": [0.36, 0.42]},
    "sharded_host_us_per_step": {"k1": [250.0, 400.0], "auto": [30.0, 60.0]},
    "sharded_idle_share": {"k1": [0.05, 0.30], "auto": [0.0, 0.05]},
    "sharded_allocations_per_step": {"k1": 0, "auto": 0},
    # the solves on the mesh: each operator application a halo pad and four
    # K1 launches, each dot four sums and a psum; the host paces them:
    # cg 10-25 ms per solve (single: 6.97), pipecg 15-35 (11.64), cg + mg
    # 60-120 (55.69; r gathered and the correction cut back per iteration)
    "sharded_solve_ms": {"cg": [10.0, 25.0], "pipecg": [15.0, 35.0],
                         "cg+mg": [60.0, 120.0]},
    # the exchange/compute overlap (written before its first timed run;
    # PERF.md §6): HeatConfig() with overlap=True, resident, float32.
    # The interior in region mode reads and writes 510² (k = 1) or 496²
    # (k = 8) of the 512² brick, so about that share of the monolithic
    # launch (0.3141 ms, 2.59 ms); each shell a launch-bound few µs; the
    # split step adds four shell launches, their window copies and the
    # slab copies, all paced by the host at k = 1 (about 20 more torch
    # calls and four more launcher calls a brick and field); the auto step
    # spreads that over 8 steps; no allocation per split step.  On one
    # card the slab copies (a few µs) are enqueued before the interior
    # launch, so at most their tail runs beside its start
    "overlap_interior_ms": {"k1": [0.29, 0.33], "k8": [2.3, 2.6]},
    "overlap_shell_ms": {"k1": [0.003, 0.010]},
    "overlap_ms_per_step": {"one_k1": [0.40, 0.65], "one_auto": [0.33, 0.40],
                            "mesh_k1": [1.2, 2.4], "mesh_auto": [0.36, 0.45],
                            "members_k1": [2.7, 3.1]},
    "overlap_host_us_per_step": {"one_k1": [350.0, 650.0],
                                 "one_auto": [45.0, 90.0],
                                 "mesh_k1": [1200.0, 2400.0],
                                 "mesh_auto": [150.0, 300.0],
                                 "members_k1": [350.0, 650.0]},
    "overlap_idle_share": {"one_k1": [0.2, 0.5], "one_auto": [0.0, 0.05],
                           "mesh_k1": [0.6, 0.85], "mesh_auto": [0.0, 0.1]},
    "overlap_allocations_per_step": 0,
    "overlap_slab_copies_concurrent": "at most the copies' tail beside the "
                                      "interior launch's start",
    # numerical health (written before its first run on a card; PERF.md
    # §6): HeatConfig(), 200 steps, check_finite=64, resident.  A probe is
    # one isfinite/all pass (134 MB read, 33.5 MB of flags written and
    # read: about 60 us) every 64 steps (21 ms at k = 1), its verdict read
    # one chunk late, so the card does not idle for it: five probes a
    # 200-step run, about 0.3 ms of device time and one wait at each chunk
    # run's end, so 0.2-1.2 % over the unguarded run at k = 1 on one
    # device; the mesh's k = 1 step is host-paced and hides its probes;
    # host us per step up by the probes' Python (about 100 us a chunk)
    "health_overhead": {"one_k1": [0.002, 0.012], "one_auto": [0.0, 0.015],
                        "mesh_k1": [-0.02, 0.03], "mesh_auto": [0.0, 0.03],
                        "members_k1": [0.0, 0.005]},
    "health_ms_per_step_guarded": {"one_k1": [0.330, 0.338],
                                   "one_auto": [0.328, 0.336],
                                   "mesh_k1": [0.53, 0.60],
                                   "mesh_auto": [0.353, 0.365],
                                   "members_k1": [2.67, 2.72]},
    "health_probes_per_run": 5,
    # the budget's steady state (written before its first run on a card;
    # PERF.md §6): 2048-step runs at k = 1, each read back as its caller
    # would, guarded and unguarded in shuffled turns.  Both runs pay the
    # same start and final wait, so the guarded run adds only its 33
    # probes (about 55 us each, 1.8 ms) and its zeroed spare (0.05 ms) to
    # about 677 ms: 0.2-0.6 %
    "health_budget_overhead": [0.002, 0.006],
    "health_poisoned": {"overflow_step": 100, "fault_step": 128,
                        "good_step": 64},
    # differentiation (written before its first run on a card; PERF.md §6):
    # the adjoint solve is one more Krylov solve on the same kernels, plus
    # the Moat correction's rolls (a few full-field passes, 1-3 ms): cg and
    # pipecg a few ms each way (solve_heat3d's 6.97 and 11.64 ms), cg + mg
    # 35-70 ms each way, bicgstab on the variable-coefficient system 10-60
    # ms; the dot-product test within 1e-5 of <xbar, x>; the inverse
    # problem below 1e-2 relative error in 5-40 s of host-paced 16x16x8
    # solves
    "adjoint_solve_ms": {"cg": [4.0, 15.0], "pipecg": [8.0, 25.0],
                         "bicgstab": [10.0, 60.0], "cg+mg": [35.0, 90.0]},
    "adjoint_inverse_relative_error": 0.01,
    # the differentiable make at k = 1 (padded launches, 0.59 ms a step
    # with the wrap pad), S = 64: the forward about 38 ms; the backward
    # 64 VJPs of the roll interpreter (2.1 ms a step forward, 2-3x that
    # backward) 0.25-0.45 s, the checkpointed one a forward more; peak
    # memory about S x 134 MB = 8.6 GB all-residuals against about
    # (8 + 8) x 134 MB = 2.1 GB checkpointed, plus the VJP's transients
    "adjoint_make_forward_ms": [30.0, 60.0],
    "adjoint_make_backward_ms": [250.0, 600.0],
    "adjoint_make_peak_gb": {"all_residuals": [8.6, 12.0],
                             "checkpointed": [2.1, 5.0]},
    # the simulation service (written before its first run on a card;
    # PERF.md §6): HeatConfig()'s grid, 32 heat3d requests of 200 steps, 4
    # workers, chunks of 8 steps.  Every chunk is 8 resident k = 1 launches
    # (0.33 ms each, as make's) plus one isfinite probe of the 135 MB
    # resident buffer (60-90 us) and one host read; each request also
    # copies its init to the card (pageable, 134 MB, 10-20 ms), enters the
    # layout, and copies its answer back (10-20 ms).  Workers enqueue on
    # one stream, so requests serialize on the card: about 66 ms of steps
    # and 20-40 ms of copies a request, 7-11 requests/s; device ms per
    # served step 0.40-0.55 beside make's 0.33; a request waits behind
    # the 28 others, so p50 latency 1.5-3 s, p99 3-5 s, mean queue wait
    # 1-2.5 s; host us per chunk (enqueue only) 8 x the resident step's
    # 110-170 us; idle share 5-25 % (the probe's wait and each chunk's
    # first launch); 0 allocations per chunk (the spares are held by the
    # request); a checkpoint of the resident env (135 MB) written in
    # 0.15-0.6 s and restored in 0.1-0.4 s; 0 kernels built after warm-up
    "service_requests_per_s": [7.0, 11.0],
    "service_latency_s": {"p50": [1.5, 3.0], "p99": [3.0, 5.0]},
    "service_mean_queue_wait_s": [1.0, 2.5],
    "service_device_ms_per_served_step": [0.40, 0.55],
    "service_host_us_per_chunk": [880.0, 1360.0],
    "service_idle_share": [0.05, 0.25],
    "service_allocations_per_chunk": 0,
    "service_checkpoint_s": {"write": [0.15, 0.6], "restore": [0.1, 0.4]},
    "service_kernels_built_after_warm_up": 0,
    # the measured cost model (written before its first run on a card;
    # PERF.md §6): HeatConfig() 512x512x128 float32, resident.  The fused
    # steps 0.32-0.34 ms/step at every k (heat3d's 0.3293 at k = 1, 0.3281
    # at k = 8), the split 0.6-1.0 ms/step at k = 1 (overlap_make's
    # 0.65-0.96) and 0.36-0.50 at k = 4 (its host cost spread over 4
    # steps); the fit's slope 0.33 ms over 3.36e7 cells, its intercept
    # within noise of zero; the exchange four host-paced slab copies; each
    # shell's overhead from the split step's 430 us of extra host time a
    # step (overlap_make); so
    # the calibrated plan is monolithic, its k whichever wins a <= 3 %
    # trapezoid trade, within 2 % of the fastest fused schedule; the
    # calibration under 5 s
    "cost_model_fused_ms_per_step": [0.32, 0.34],
    "cost_model_split_ms_per_step": {"k1": [0.6, 1.0], "k4": [0.36, 0.50]},
    "cost_model_cell_ns": 0.0098,
    "cost_model_exchange_us": [5.0, 40.0],
    "cost_model_boundary_us_at_least": 50.0,
    "cost_model_intercept_us": "within noise of zero",
    "cost_model_calibrated_split": 0,
    "cost_model_calibrated_over_fastest_fused": [1.0, 1.02],
    "cost_model_calibration_s": [0.0, 5.0],
    # the LM serving path (written before its first run on a card; PERF.md
    # §6): qwen3-0.6b at full width and depth in bfloat16, batch 8,
    # prompt 512, gen 64, eager PyTorch.  A decode step issues about 100
    # small kernels a layer (norms, rotations, casts, the cache's float32
    # copies, three projections, the MLP), about 2800 a token from the host
    # at 5-10 us each, so it is host-bound at 10-30 ms a token against its
    # 0.36 ms bytes bound (1.19 GB of weights at 3.35 TB/s), the card idle
    # 40-80 % of it; the prefill's 3.6e12 FLOP of bfloat16 products (a 3.7
    # ms bound at 989 TFLOP/s) run beside float32 attention (TF32 off) and
    # its 134 MB score tiles, 25-60 ms; 2.5-5 GB at the peak (1.2 GB of
    # weights, 0.53 GB of cache, the prefill's float32 scores)
    "lm_decode_ms_per_token": [10.0, 30.0],
    "lm_decode_tok_per_s": [270.0, 800.0],
    "lm_decode_idle_share": [0.4, 0.8],
    "lm_prefill_ms": [25.0, 60.0],
    "lm_prefill_tok_per_s": [68000.0, 164000.0],
    "lm_peak_gb": [2.5, 5.0],
    "lm_forced_bf16_rel": [0.005, 0.05],
    "lm_bf16_vs_f32_rel_fro": [0.005, 0.05],
    # K1's k = 1 padded row's library call: one F.conv3d of the padded
    # 514x514x128 float32 field, one channel, TF32 off (K6's F.pad +
    # F.conv3d took 6.3992 ms, K3's strided one 0.7586)
    "k1_conv3d_library_ms": [3.0, 7.0],
    # the same call on the 8 padded members (N = 8, about 8 x 6.05 ms) and
    # on one 258x258x128 padded brick of the 2x2 mesh (about a quarter)
    # (written before their first run on a card; PERF.md §6)
    "k1_conv3d_library_members_ms": [40.0, 56.0],
    "k1_conv3d_library_brick_ms": [1.2, 1.9],
    # LM training (written before its first run on a card; PERF.md §6):
    # qwen3-0.6b in bfloat16, remat "dots", 8 microbatches of 1 x 512,
    # eager PyTorch under deterministic algorithms.  A microbatch's forward
    # issues about 100 kernels a layer; its backward recomputes the layer
    # under the selective checkpoint's dispatch mode (a Python call per op)
    # and runs about twice the forward's kernels: 400-700 launches a
    # layer, 11,000-20,000 a microbatch, 90,000-160,000 a step at 10-25 us
    # of host time each (the step at smoke width with 28 layers takes 3.3 s
    # on the CPU, almost all of it dispatch), so the step is host-bound at
    # 1.5-4 s against its 15.4 ms operations bound (3 x 5.1e12 FLOP at 989
    # TFLOP/s), the card idle 80-95 % of it; 1000-2700 tokens/s; a peak of
    # 11-16 GB against the 9.5 GB floor (16 bytes a parameter: bfloat16
    # weights and gradients, float32 m, v and accumulator); the loss from
    # about ln(151936) = 11.9 to 7-11 over the last 5 of 24 steps; the
    # resumed run and "dots" against "none" bitwise; "dots" at 1.5-3x the
    # time of "none" (2.7x on the CPU) and under its activation memory
    "lm_train_step_ms": [1500.0, 4000.0],
    "lm_train_tok_per_s": [1000.0, 2700.0],
    "lm_train_idle_share": [0.8, 0.95],
    "lm_train_dots_over_none_time": [1.5, 3.0],
    "lm_train_peak_gb": [11.0, 16.0],
    "lm_train_loss_first5": [11.0, 12.2],
    "lm_train_loss_last5": [7.0, 11.0],
    # the held-out batch's loss (revised before its first card run): about
    # the first steps' 12.12-12.14 before the run, 0.03-0.2 lower after it
    "lm_train_held_out_fall": [0.03, 0.2],
    "lm_train_resume": "bitwise",
    "lm_train_remat_dots_vs_none": "bitwise",
    # LM training on a 2×2 mesh of the card (written before its first run
    # on a card; PERF.md §6): 16 replica passes of 1 × 512 a step, twice
    # lm_train's 8, each as host-bound as its (3.3-8.1 s for 8), so 6.5-16
    # s a step; idle as lm_train's; the 1×1 step's peak (2-row microbatches)
    # 14-19 GB; the remesh moves 6 GB through pageable host memory both
    # ways.  Revised before the first card run with one set of
    # accumulators for the replicas on the card: the 2×2 peak below the
    # 1×1 step's (1-row passes, the same single float32 accumulator); the
    # bfloat16 loss within 2e-6 and the gradient norm within 2e-5 of the
    # 1×1 step's (bounds LM_MESH_BF16_REL); the step after the remesh the
    # 2×2 run's own, bitwise
    "lm_mesh_step_ms": [6500.0, 16000.0],
    "lm_mesh_tok_per_s": [510.0, 1260.0],
    "lm_mesh_idle_share": [0.8, 0.95],
    "lm_mesh_peak_gb": [9.0, 13.2],
    "lm_mesh_one_device_peak_gb": [14.0, 19.0],
    "lm_mesh_bf16_loss_rel": [0.0, 2e-6],
    "lm_mesh_bf16_grad_norm_rel": [0.0, 2e-5],
    "lm_mesh_after_remesh": "bitwise",
    "lm_mesh_remesh_s": [4.0, 10.0],
    "lm_mesh_smoke_f32_rel": [0.0, 1e-6],
    "lm_mesh_psum_compressed": "bitwise",
    # the dry-run phase (written before its first card run; PERF.md §6):
    # qwen3-0.6b's six records counted in 10-30 s of host time (12 s on
    # an 8-core CPU host without a card), nothing allocated on the card; the
    # lm_train model's state 596 049 920 × 10 B + the step + the batch
    # (5 960 531 972 B) within 512 B a leaf of the card's allocation; the
    # 2×2 heat bricks host-paced: the explicit variants 0.4-0.8 ms a step
    # against a model of 0.026 ms a brick (0.105 ms for four), the
    # Krylov iterations 1-3 ms; at 128×128×512, queued, each launch at
    # the ratio to its bound that it reads at 512×512×128 (bounds about
    # 0.020 ms): K6 0.025-0.04 ms, K7 0.022-0.035 ms, K5 0.022-0.04 ms
    "dryrun_host_s": [10.0, 30.0],
    "dryrun_state_bytes": 5960531972,
    "dryrun_heat_explicit_ms_per_step": [0.4, 0.8],
    "dryrun_heat_implicit_ms_per_iteration": [1.0, 3.0],
    "dryrun_k6_ms": [0.025, 0.04],
    "dryrun_k7_ms": [0.022, 0.035],
    "dryrun_k5_ms": [0.022, 0.04],
}
#: ``F.conv3d`` against K1 on the 8 members' and the bricks' heat3d body:
#: seven terms summed in another order round at most 3 times apart, so
#: within 4 float32 ulps of the field's largest value (the single padded
#: field's call keeps its 1-ulp check)
LIBRARY_ULPS = 4
#: H100 SXM device-memory rate and float32 / float64 (non-tensor) peaks
from repro_torch.core.perfmodel import (  # noqa: E402
    H100_SXM_BF16_DENSE_FLOPS, HBM_BYTES_PER_S, PEAK_FLOPS)
#: the kernel libraries of the main paths (csrc/<stem>.cu)
LIBRARIES = ("fused_stencil", "dual_dot", "transfer", "stencil7")
#: the ``kernels`` row of K1's column entry on a hazard body
HAZARD_ROW = "K1 fused_stencil, column entry, hazard body"
#: members of the ``ensemble_make`` and ``ensemble_solve`` phases
ENSEMBLE_MAKE_MEMBERS = 8
ENSEMBLE_SOLVE_MEMBERS = 4
#: K2 vs the plain version in float64: |K2 − exact| ≤ REL · Σ|aᵢbᵢ|.  The
#: kernel sums 32 terms per thread, then a 256-thread tree, then the block
#: partials: about 50 roundings deep, so 50·u (u = 6e-8 at f32, 1.1e-16 at
#: f64) on the sum of magnitudes, with margin
K2_REL = {"float32": 1e-5, "float64": 1e-13}
#: the implicit tolerance, relative to ‖b‖ (HeatConfig().tol = 1e-6 is an
#: absolute bound that a float32 solve on Kelvin-scale data cannot reach)
SOLVE_REL_TOL = 1e-5
#: the jit roll interpreter vs the fused kernel on Kelvin-scale fields.  The
#: two sum the taps in different orders (recorded vs canonical), so they
#: drift apart by rounding: within 2e-4 over a short run (the bound the
#: reference documents for its backends), and within one float32 ulp of the
#: field's magnitude per step over a long one
JIT_SHORT_STEPS = 16
JIT_SHORT_ATOL = 2e-4
#: a solve on ``backend="pallas"`` vs the same solve on ``"jit"``: the two
#: sum the operator's taps (K1 vs the roll interpreter) and the dots (K2 vs
#: torch) in different orders, so each iteration's update of the solution
#: may round differently; over the same number of iterations they stay
#: within this many float32 ulp of the field's magnitude per iteration
SOLVE_JIT_ULPS = 4
#: K5's dot vs the plain version in float64: |K5 − exact| ≤ REL · Σ|c·Ap|,
#: and each per-tile partial within REL of its tile's Σ|c·Ap| (a serial
#: chain of at most 128 products per thread, a 256-thread tree per block,
#: then torch.sum over the partials: at most about 140 roundings deep,
#: 140·u = 8.4e-6 at f32, so K2's bound holds)
K5_REL = K2_REL
#: the legacy Krylov iterations of each make_sharded_iteration run
LEGACY_ITERS = 20
#: make_sharded_iteration, kernel vs plain and 2×2 vs 1×1: the dots sum in
#: other orders, so each iteration's update may round differently, within
#: this many float32 ulp of the field's magnitude per iteration, and the
#: recurrence scalars (rr, γ, α) within ITER_SCALAR_REL of each other
ITER_ULPS = 4
ITER_SCALAR_REL = 1e-4
#: CG's and pipelined CG's float32 recurrences lose their accuracy once ‖r‖
#: falls below about this share of ‖r₀‖ (16 u), and the iteration harness,
#: unlike the solver, never replaces the residual: from there two dot orders
#: may drift apart without bound (at ``--seed 0`` pipecg's recurrence ‖r‖
#: climbs back from 8e-8·‖r₀‖ at iteration 10 to 4e-6 at 13; the
#: legacy_btcs line records each method's ‖r‖ history and each pair's
#: difference at the last iteration).  So both are compared at the last
#: iteration before ‖r‖ first falls to this floor, where a wrong dot would
#: still show
KRYLOV_FLOOR = 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, repeats: int) -> float:
    """Mean device time of ``fn()`` over ``repeats`` calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def queued_ms(fn, repeats: int) -> float:
    """Device time of ``fn()`` over ``repeats`` calls enqueued behind a
    sleep kernel, so that the host's launch cost does not pace the card (a
    kernel of tens of µs takes about as long as its Python launch path):
    the sleep is doubled until the start event is still pending when the
    last call has been enqueued."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_us_per_call = (time.perf_counter() - t0) * 1e6
    torch.cuda.synchronize()
    cycles = int(4e3 * (2 * repeats * host_us_per_call + 1e3))  # ≥ 2 GHz
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(repeats):
            fn()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / repeats
        cycles *= 2
    raise AssertionError("queued_ms: the card caught up with the host")


def host_us(fn, samples: int = 5) -> float:
    """Host time of one ``fn()`` on an idle card, µs: from the call to its
    return, before the card has finished (what the host spends issuing the
    work while the card runs it); the median of ``samples`` calls after a
    warm-up, the card idle before each."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def body_ops(kernel) -> int:
    """Floating-point operations one sub-step of ``kernel``'s body needs per
    output (x, y) cell, summed over its updates' z windows."""
    total = 0
    for u in kernel.updates:
        groups = {}
        for coeff, taps in u.terms:
            groups.setdefault(coeff, []).append(taps)
        per = 0
        for coeff, prods in groups.items():
            per += sum(len(t) - 1 for t in prods) + len(prods) - 1
            per += coeff != 1.0
        per += max(len(groups) - 1, 0) + (u.const != 0.0 and bool(groups))
        total += per * u.zlen
    return total


def bound_ms(kernel, dtype_name: str) -> tuple:
    """(least ms, "bytes" | "operations") for one launch of ``kernel``: each
    padded input read once and each output written once, against the
    body's operations on the interior cells of k sub-steps; B times that
    for a kernel built for B members."""
    itemsize = 4 if dtype_name == "float32" else 8
    ph = kernel.pad
    nbytes = 0
    for name, nz in zip(kernel.in_names, kernel.nz):
        nbytes += (kernel.bx + 2 * ph) * (kernel.by + 2 * ph) * nz * itemsize
        if name in kernel.written:
            nbytes += kernel.bx * kernel.by * nz * itemsize
    ops = kernel.k * (kernel.nx - 2) * (kernel.ny - 2) * body_ops(kernel)
    t_bytes = kernel.batch * nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = kernel.batch * ops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record_coupled(mod, A0, C0, B0, steps, hazard=True):
    """A small multi-field, off-axis, multi-update body: advection–diffusion
    of A with a variable-coefficient cross term (2-tap products), B reading
    A's new value at dz = ±1, and with ``hazard`` A re-written from its own
    new value at dz = -1 (a hazard: the column entry's hazard
    instantiation serves the body)."""
    wse = mod.WFAInterface()
    A = mod.Field("A", init_data=A0, dtype=A0.dtype)
    C = mod.Field("C", init_data=C0, dtype=C0.dtype)
    B = mod.Field("B", init_data=B0, dtype=B0.dtype)
    with mod.ForLoop("t", steps):
        A[1:-1, 0, 0] = A[1:-1, 0, 0] \
            + 0.05 * (A[2:, 0, 0] + A[:-2, 0, 0] + A[1:-1, 1, 0]
                      + A[1:-1, -1, 0] + A[1:-1, 0, 1] + A[1:-1, 0, -1]
                      - 6.0 * A[1:-1, 0, 0]) \
            - 0.1 * (A[1:-1, 0, 0] - A[1:-1, -1, 0]) \
            + C[1:-1, 0, 0] * (A[1:-1, 1, 1] + A[1:-1, -1, -1]
                               - 2.0 * A[1:-1, 0, 0])
        B[1:-1, 0, 0] = 0.5 * B[1:-1, 0, 0] + 0.25 * (A[2:, 0, 0]
                                                     + A[:-2, 0, 0]) + 0.125
        if hazard:
            A[2:-1, 0, 0] = A[2:-1, 0, 0] - 0.01 * A[1:-2, 0, 0]
    return wse, A, B


def record_wide(mod, P0, Q0, R0, steps):
    """Edge cases: halo 2, fields of different nz in one body, a 2-tap
    product across them, a constant-only update, and a halo-free field."""
    wse = mod.WFAInterface()
    P = mod.Field("P", init_data=P0, dtype=P0.dtype)
    Q = mod.Field("Q", init_data=Q0, dtype=Q0.dtype)
    R = mod.Field("R", init_data=R0, dtype=R0.dtype)
    with mod.ForLoop("t", steps):
        P[1:-1, 0, 0] = 0.3 * P[1:-1, 0, 0] + 0.2 * (
            P[1:-1, 2, 0] + P[1:-1, -2, 1]) + Q[:, 0, 0] * Q[:, 1, -2]
        Q[2:5, 0, 0] = 0.0 * Q[2:5, 0, 0] + 1.5
        R[1:-1, 0, 0] = 0.5 * R[2:, 0, 0] + 0.5 * R[:-2, 0, 0]
    return wse


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_libraries(LIBRARIES)
    ptxas = {stem: [ln.strip() for ln in build.build_log.get(stem, "").splitlines()
                    if "Used" in ln or "spill" in ln] for stem in LIBRARIES}
    emit({"phase": "build", "libraries": list(LIBRARIES),
          "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {s: build.build_seconds[s] for s in LIBRARIES},
          "ptxas": ptxas})


def _build_kernel(program_ops, shapes, dtypes, k, device, margin=0, batch=1,
                  region=None, brick=None, wrap=True):
    from repro_torch.compiler.codegen import _field_specs
    from repro_torch.compiler.ir import lower_group
    from repro_torch.kernels.fused import build_fused_call

    group = lower_group(program_ops)
    specs, (nx, ny) = _field_specs(group, shapes, dtypes)
    bx, by = brick or (nx, ny)
    kernel, _ = build_fused_call(group.updates, specs, group.halo, bx, by, nx,
                                 ny, time_tile=k, wrap=wrap, device=device,
                                 margin=margin, batch=batch, region=region)
    return kernel


def _padded_inputs(kernel, env, device):
    import torch

    from repro_torch.compiler.codegen import _wrap_pad

    return [_wrap_pad(torch.tensor(env[n], device=device), kernel.pad)
            if kernel.pad else torch.tensor(env[n], device=device)
            for n in kernel.in_names]


def route_counts():
    """``(k1_launches, sweep_launches, sweep_substeps, hazard_launches)`` of
    K1 so far."""
    from repro_torch.kernels.fused import launch_fused

    return (launch_fused.k1_launches, launch_fused.sweep_launches,
            launch_fused.sweep_substeps, launch_fused.hazard_launches)


def launch_via_entry(kernel, inputs, out=None, coords=(0, 0)):
    """``launch_fused`` that fails unless the launch went through the route
    ``fused_entry`` names — one ``k1_launches`` for the k = 1 route, one
    ``sweep_launches`` and k ``sweep_substeps`` for the sweep — and counted
    one ``hazard_launches`` exactly for a hazard body."""
    from repro_torch.kernels.fused import fused_entry, launch_fused

    before = route_counts()
    got = launch_fused(kernel, inputs, coords, out=out)
    entry = fused_entry(kernel)
    want = {"k1": (1, 0, 0), "sweep": (0, 1, kernel.k)}[entry] + (
        int(kernel.hazard),)
    moved = tuple(a - b for a, b in zip(route_counts(), before))
    if moved != want:
        raise AssertionError(f"k = {kernel.k} hazard={kernel.hazard}: route "
                             f"counts (k1, sweep, sub-steps, hazard) moved by "
                             f"{moved}, expected {want} for {entry!r}")
    return got


def compare_kernel(kernel, padded):
    """K1 vs fused_step_ref on the same card inputs: max |diff| (must be 0)."""
    import torch

    from repro_torch.kernels.fused import fused_step_ref

    got = launch_via_entry(kernel, padded)
    want = fused_step_ref(kernel, padded)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError("K1 produced non-finite values")
        err = max(err, (g.double() - w.double()).abs().max().item())
        if not torch.equal(g, w):
            raise AssertionError(f"K1 differs from fused_step_ref (max {err})")
    return err


def _resident_inputs(kernel, env, device):
    """The margin-mode inputs of ``kernel``: each field entered into a
    resident buffer of margin ``kernel.margin`` and refreshed to depth
    ``k·h``, as the engine's resident step does."""
    import torch

    from repro_torch.engine.layout import HaloLayout, wrap_refresh

    lay = HaloLayout(pad=kernel.margin, shapes={})
    return [wrap_refresh(lay.enter({n: torch.tensor(env[n], device=device)})[n],
                         kernel.margin, kernel.pad) for n in kernel.in_names]


def margin_outputs(kernel, inputs, fill: float = -7.0):
    """One output buffer per written field at the resident extent, every
    cell ``fill``."""
    import torch

    return [torch.full_like(inputs[kernel.in_names.index(n)], fill)
            for n in kernel.written]


def compare_margin(kernel, inputs, padded_out):
    """K1's margin mode vs fused_step_ref's on the same card inputs, into
    output buffers filled alike: the whole buffers bitwise (so the margins
    stay untouched), and the interiors bitwise against the padded mode's
    outputs ``padded_out``.  Returns max |diff| (must be 0)."""
    import torch

    from repro_torch.kernels.fused import fused_step_ref

    before = [t.clone() for t in inputs]
    got = launch_via_entry(kernel, inputs, out=margin_outputs(kernel, inputs))
    want = fused_step_ref(kernel, inputs, out=margin_outputs(kernel, inputs))
    torch.cuda.synchronize()
    M = kernel.margin
    err = 0.0
    for g, w, p in zip(got, want, padded_out):
        if not torch.isfinite(g).all():
            raise AssertionError("K1 margin mode produced non-finite values")
        err = max(err, (g.double() - w.double()).abs().max().item())
        if not torch.equal(g, w):
            raise AssertionError(f"K1 margin mode differs from fused_step_ref "
                                 f"(max {err})")
        if not torch.equal(g[M:-M, M:-M], p):
            raise AssertionError("K1 margin mode differs from the padded mode")
    if not all(torch.equal(t, b) for t, b in zip(inputs, before)):
        raise AssertionError("K1 margin mode wrote one of its inputs")
    return err


def compare_region(ops, shapes, dtypes, k, dev, env, padded_out=None,
                   members=1, mesh=None):
    """K1's region mode on the card over the interior of ``split_regions``
    (margin M = k·h, the engine's), and each shell's padded launch on its
    ``strip_window`` of the same buffers, each bitwise against its plain
    version (whole output buffers, so no cell outside the region moves),
    through the route its tile names, the interior counted once in
    ``region_launches``; with ``padded_out`` (the monolithic padded launch
    on the same fields) the five outputs also equal its cells.  ``env``
    holds ``(B, X, Y, Z)`` stacks for ``members > 1``.

    With ``mesh`` (a brick mesh of the card) the kernels are the sharded
    split step's — the brick's extent, ``wrap=False`` — every brick's
    launches take its global origin plus the region's, the slabs come from
    ``exchange_slabs``, and the five outputs of each brick are held against
    the cells of the monolithic margin-mode launch on that brick.

    Returns (max |diff|, the single-device launches to time:
    ``{"interior": (kernel, ins, out), "shells": [(kernel, windows,
    coords), …]}``)."""
    import torch

    from repro_torch.compiler.ir import lower_group, split_regions
    from repro_torch.core.halo import exchange_slabs
    from repro_torch.engine.layout import strip_window, wrap_slabs
    from repro_torch.kernels.fused import fused_step_ref, launch_fused

    group = lower_group(ops)
    nx, ny = next(iter(shapes.values()))[:2]
    wrap = mesh is None
    bx, by = (nx, ny) if wrap else (nx // mesh.dims[0], ny // mesh.dims[1])
    split = split_regions(group, k, (bx, by))
    M = k * group.halo
    kern = _build_kernel(ops, shapes, dtypes, k, dev, margin=M, batch=members,
                         region=split.interior, brick=(bx, by), wrap=wrap)
    ph = kern.pad
    if wrap:
        bricks = [(_resident_inputs(kern, env, dev), (0, 0))]
        slabs = [[wrap_slabs(t, M, ph) for t in bricks[0][0]]]
        monolithic = [padded_out]
    else:
        ins, coords = _brick_inputs(kern, env, mesh)
        bricks = list(zip(ins, coords))
        slabs = list(zip(*[exchange_slabs([b[f] for b in ins], M, ph, mesh)
                           for f in range(len(kern.in_names))]))
        whole = _build_kernel(ops, shapes, dtypes, k, dev, margin=M,
                              brick=(bx, by), wrap=False)
        monolithic = [[o[..., M:-M, M:-M, :] for o in launch_fused(
            whole, xs, c, out=margin_outputs(whole, xs))] for xs, c in bricks]
    shells = [_build_kernel(ops, shapes, dtypes, k, dev, batch=members,
                            brick=(s.rx, s.ry), wrap=wrap)
              for s in split.shells]
    r = split.interior
    err, timed = 0.0, None
    for (ins, (cx, cy)), sl, mono in zip(bricks, slabs, monolithic):
        before = launch_fused.region_launches
        got = launch_via_entry(kern, ins, out=margin_outputs(kern, ins),
                               coords=(cx + r.x0, cy + r.y0))
        if launch_fused.region_launches - before != 1:
            raise AssertionError("the interior launch was not counted as a "
                                 "region launch")
        want = fused_step_ref(kern, ins, (cx + r.x0, cy + r.y0),
                              out=margin_outputs(kern, ins))
        torch.cuda.synchronize()
        pieces = [(r, [g[..., M + r.x0:M + r.x0 + r.rx,
                         M + r.y0:M + r.y0 + r.ry, :] for g in got])]
        for g, w in zip(got, want):
            err = max(err, (g.double() - w.double()).abs().max().item())
            if not torch.isfinite(pieces[0][1][0]).all():
                raise AssertionError("K1's region mode produced non-finite "
                                     "values")
            if not torch.equal(g, w):
                raise AssertionError(f"K1's region mode at {(cx, cy)} differs "
                                     f"from its plain version (max {err})")
        del want
        launches = []
        for s, shell in zip(split.shells, shells):
            wins = [strip_window(t, slab, M, ph, s, bx, by)
                    for t, slab in zip(ins, sl)]
            at = (cx + s.x0, cy + s.y0)
            sg = launch_via_entry(shell, wins, coords=at)
            sw = fused_step_ref(shell, wins, at)
            torch.cuda.synchronize()
            for g, w in zip(sg, sw):
                err = max(err, (g.double() - w.double()).abs().max().item())
                if not torch.equal(g, w):
                    raise AssertionError(f"K1's shell launch {s} at "
                                         f"{(cx, cy)} differs from its plain "
                                         f"version (max {err})")
            pieces.append((s, sg))
            launches.append((shell, wins, at))
        if mono is not None:
            for reg, outs in pieces:
                for g, p in zip(outs, mono):
                    if not torch.equal(g, p[..., reg.x0:reg.x0 + reg.rx,
                                            reg.y0:reg.y0 + reg.ry, :]):
                        raise AssertionError(
                            f"the split launch's region {reg} at {(cx, cy)} "
                            "differs from the monolithic launch")
        if timed is None:
            timed = {"interior": (kern, ins, got), "shells": launches}
    return err, timed


def small_body_cases():
    """K1 vs its plain version on small bodies that reach every branch of
    the kernel, and ``make`` on the card vs ``make`` on the CPU with a
    remainder launch."""
    import numpy as np

    import repro_torch as rt
    from repro_torch.configs.heat3d import HeatConfig, record_heat
    from repro_torch.engine import RunOptions
    from repro_torch.kernels.fused import fused_entry, launch_fused

    cases = []
    rng = np.random.default_rng(0)
    shape = (37, 29, 11)   # ragged against every tile size
    for dtype in (np.float32, np.float64):
        A0 = rng.uniform(0.0, 1.0, shape).astype(dtype)
        C0 = rng.uniform(0.0, 0.05, shape).astype(dtype)
        B0 = rng.uniform(0.0, 1.0, shape).astype(dtype)
        env = {"A": A0, "C": C0, "B": B0}
        wide = {"P": rng.uniform(0.0, 1.0, (20, 23, 9)).astype(dtype),
                "Q": rng.uniform(0.0, 0.1, (20, 23, 7)).astype(dtype),
                "R": rng.uniform(0.0, 1.0, (20, 23, 6)).astype(dtype)}
        # the column entry's edge shapes: nz = 200 > BZ, and a coarse
        # multigrid level's 3×3×2 (empty z window: only the copy-through)
        heat = {shape: rng.uniform(300.0, 500.0, shape).astype(dtype)
                for shape in ((9, 7, 200), (3, 3, 2))}

        def record_heat_on(T0):
            nx, ny, nz = T0.shape
            return record_heat(HeatConfig(nx=nx, ny=ny, nz=nz,
                                          dtype=np.dtype(dtype).name), 4,
                               init=T0)[0]

        #: (body, fields, recorder, time tiles)
        bodies = (
            ("coupled_advdiff", env,
             lambda: record_coupled(rt, A0, C0, B0, 4)[0], (1, 2)),
            ("wide_halo2_mixed_nz", wide,
             lambda: record_wide(rt, wide["P"], wide["Q"], wide["R"], 4),
             (1, 2)),
            ("two_update_dz", env,
             lambda: record_coupled(rt, A0, C0, B0, 4, hazard=False)[0],
             (1, 2)),
            ("heat_nz200", {"T_n": heat[9, 7, 200]},
             lambda: record_heat_on(heat[9, 7, 200]), (1, 2)),
            ("heat_3x3x2", {"T_n": heat[3, 3, 2]},
             lambda: record_heat_on(heat[3, 3, 2]), (1, 2)))
        for body, body_env, record, tiles in bodies:
            wse = record()
            prog = wse.program
            wse.__exit__()
            shapes = {n: f.shape for n, f in prog.fields.items()}
            dtypes = {n: f.dtype for n, f in prog.fields.items()}
            for k in tiles:
                kern = _build_kernel(prog.ops, shapes, dtypes, k, "cuda")
                padded = _padded_inputs(kern, body_env, "cuda")
                err = compare_kernel(kern, padded)
                case = {"body": body, "shape": list(shapes[kern.in_names[0]]),
                        "dtype": np.dtype(dtype).name, "k": k,
                        "halo": kern.halo, "hazard": kern.hazard,
                        "entry": fused_entry(kern)}
                cases.append(dict(case, max_abs_err=err))
                padded_out = launch_fused(kern, padded)
                for M in (kern.pad, kern.pad + 1):
                    kern_m = _build_kernel(prog.ops, shapes, dtypes, k, "cuda",
                                           margin=M)
                    err = compare_margin(
                        kern_m, _resident_inputs(kern_m, body_env, "cuda"),
                        padded_out)
                    cases.append(dict(case, mode="margin", margin=M,
                                      max_abs_err=err))
        # through make (the resident layout), on the card and on the CPU: 5
        # steps at k=2 = 2 tiled launches + 1 remainder, all in margin mode
        outs = {}
        for device in ("cuda", "cpu"):
            wse, A, B = record_coupled(rt, A0, C0, B0, 5)
            before = (launch_fused.launches, launch_fused.margin_launches)
            outs[device] = wse.make(answer=A, options=RunOptions(
                backend="pallas", time_tile=2, device=device))
            launched = (launch_fused.launches - before[0],
                        launch_fused.margin_launches - before[1])
            if device == "cuda" and launched != (3, 3):
                raise AssertionError(f"expected 2 tiled + 1 remainder launch in "
                                     f"margin mode, got {launched}")
        if not np.array_equal(outs["cuda"], outs["cpu"]):
            raise AssertionError("make on the card differs from make on the CPU")
        cases.append({"body": "coupled_advdiff", "path": "make", "steps": 5,
                      "time_tile": 2, "dtype": np.dtype(dtype).name,
                      "devices": ["cuda", "cpu"],
                      "max_abs_err": float(np.abs(
                          outs["cuda"].astype(np.float64) - outs["cpu"]).max())})
    return cases


def phase_kernel_vs_ref(steps_heat: int, seed: int):
    import numpy as np
    import torch

    import repro_torch as rt
    from repro_torch.compiler.ir import auto_tile, lower_group
    from repro_torch.configs.heat3d import HeatConfig, make_field, record_heat
    from repro_torch.kernels.fused import fused_entry, launch_fused

    dev = torch.device("cuda")
    start = (launch_fused.launches, *route_counts())
    cases = []
    cfg = HeatConfig()
    heat = {}
    region_err = 0.0
    for dtype in ("float32", "float64"):
        c = HeatConfig(dtype=dtype)
        wse, T = record_heat(c, steps_heat)
        ops = wse.program.ops
        shapes = {"T_n": T.shape}
        dtypes = {"T_n": T.dtype}
        wse.__exit__()
        k_auto = auto_tile(lower_group(ops), (c.nx, c.ny), steps_heat)
        env = {"T_n": make_field(c)}
        for k in sorted({1, k_auto}):
            kern = _build_kernel(ops, shapes, dtypes, k, dev)
            padded = _padded_inputs(kern, env, dev)
            err = compare_kernel(kern, padded)
            cases.append({"body": "heat3d", "shape": [c.nx, c.ny, c.nz],
                          "dtype": dtype, "k": k, "entry": fused_entry(kern),
                          "max_abs_err": err})
            if dtype == cfg.dtype and k == 1:
                heat = {"kernel": kern, "padded": padded, "err": err}
            padded_out = launch_fused(kern, padded)
            del padded
            for M in (kern.pad, kern.pad + 1):
                kern_m = _build_kernel(ops, shapes, dtypes, k, dev, margin=M)
                ins = _resident_inputs(kern_m, env, dev)
                err = compare_margin(kern_m, ins, padded_out)
                cases.append({"body": "heat3d", "mode": "margin", "margin": M,
                              "shape": [c.nx, c.ny, c.nz], "dtype": dtype,
                              "k": k, "entry": fused_entry(kern_m),
                              "max_abs_err": err})
                if dtype == cfg.dtype and M == kern.pad:
                    # the main path's resident launches: the k = 1 route at
                    # k = 1, the sweep at the auto tile
                    heat["margin" if k == 1 else "sweep"] = {
                        "kernel": kern_m, "inputs": ins, "err": err}
            # the overlap's split launch at the same tile: the interior in
            # region mode and the four shells, each against its plain
            # version and against the monolithic launch's cells
            err, handles = compare_region(ops, shapes, dtypes, k, dev, env,
                                          padded_out)
            cases.append({"body": "heat3d", "mode": "region (interior) + "
                          "4 shells", "shape": [c.nx, c.ny, c.nz],
                          "dtype": dtype, "k": k, "max_abs_err": err})
            region_err = max(region_err, err)
            if dtype == cfg.dtype:
                heat.setdefault("region", {})[k] = handles
            del padded_out, handles
            # and with members, each a seeded heat3d field
            B = ENSEMBLE_MAKE_MEMBERS
            err, _ = compare_region(ops, shapes, dtypes, k, dev,
                                    {"T_n": heat_members(c, B, seed)},
                                    members=B)
            cases.append({"body": "heat3d", "mode": "region (interior) + "
                          "4 shells", "members": B, "shape": [c.nx, c.ny, c.nz],
                          "dtype": dtype, "k": k, "max_abs_err": err})
            region_err = max(region_err, err)
    # the hazard body at full width, k = 1 and its auto tile, through the
    # column entry's hazard instantiation; the float32 margin-mode kernels
    # are the hazard row's, timed in hazard_make
    shape = (cfg.nx, cfg.ny, cfg.nz)
    heat["hazard"] = {}
    for dtype in ("float32", "float64"):
        rng = np.random.default_rng(seed)
        env = {"A": rng.random(shape, dtype=np.float32),
               "C": np.float32(0.05) * rng.random(shape, dtype=np.float32),
               "B": rng.random(shape, dtype=np.float32)}
        env = {n: a.astype(dtype) for n, a in env.items()}
        wse = record_coupled(rt, env["A"], env["C"], env["B"], steps_heat)[0]
        prog = wse.program
        wse.__exit__()
        shapes = {n: f.shape for n, f in prog.fields.items()}
        dtypes = {n: f.dtype for n, f in prog.fields.items()}
        k_auto = auto_tile(lower_group(prog.ops), (cfg.nx, cfg.ny), steps_heat)
        for k in (1, k_auto):
            kern = _build_kernel(prog.ops, shapes, dtypes, k, dev)
            if not kern.hazard:
                raise AssertionError("the coupled body has no hazard")
            padded = _padded_inputs(kern, env, dev)
            err = compare_kernel(kern, padded)
            case = {"body": "coupled_advdiff_hazard", "shape": list(shape),
                    "dtype": dtype, "k": k, "entry": fused_entry(kern)}
            cases.append(dict(case, max_abs_err=err))
            padded_out = launch_fused(kern, padded)
            del padded
            kern_m = _build_kernel(prog.ops, shapes, dtypes, k, dev,
                                   margin=kern.pad)
            ins = _resident_inputs(kern_m, env, dev)
            err = compare_margin(kern_m, ins, padded_out)
            cases.append(dict(case, mode="margin", margin=kern.pad,
                              max_abs_err=err))
            err, _ = compare_region(prog.ops, shapes, dtypes, k, dev, env,
                                    padded_out)
            cases.append(dict(case, mode="region (interior) + 4 shells",
                              max_abs_err=err))
            region_err = max(region_err, err)
            del padded_out
            if dtype == cfg.dtype:
                heat["hazard"][k] = {"kernel": kern_m, "inputs": ins,
                                     "err": err}
            del ins
    cases += small_body_cases()
    moved = [a - b for a, b in zip((launch_fused.launches, *route_counts()),
                                   start)]
    emit({"phase": "kernel_vs_ref", "tolerance": "bitwise", "cases": cases,
          "launches_by_route": {"k1": moved[1], "sweep": moved[2],
                                "sweep_substeps": moved[3],
                                "hazard": moved[4]}})
    heat["region_err"] = region_err
    return heat


def allocations_per_step(record, steps: int, time_tile, members=None,
                         overlap=False) -> dict:
    """Device allocations per step of the resident loop at ``time_tile`` of
    the program ``record(n)`` records for ``n`` steps (``(wse, answer)``),
    on its fields' init data or on ``members`` (name -> ``(B, X, Y, Z)``
    stack, a batched plan):
    the growth of ``allocation.all.allocated`` over a ``2·steps`` run less
    that over a ``steps`` run, divided by ``steps`` (what a run allocates
    once — the layout's enter and exit, the ping-pong spares — cancels; a
    kernel's first launch, which allocates the sweep's scratch, falls in
    the warm-up run)."""
    import torch

    from repro_torch.convert import env_from_numpy
    from repro_torch.engine import RunOptions, plan, single_runner

    grown = {}
    for n in (steps, 2 * steps):
        wse, _ = record(n)
        prog = wse.program
        batch = next(iter(members.values())).shape[0] if members else 1
        p = plan(prog, RunOptions(backend="pallas", time_tile=time_tile,
                                  batch=batch, overlap=overlap))
        wse.__exit__()
        run = single_runner(p)
        env = env_from_numpy(members or {name: f.init_data for name, f
                                         in prog.fields.items()}, "cuda")
        run(env)
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        run(env)
        torch.cuda.synchronize()
        grown[n] = torch.cuda.memory_stats()["allocation.all.allocated"] - a0
    per_step = (grown[2 * steps] - grown[steps]) / steps
    return {"steps": [steps, 2 * steps], "time_tile": time_tile,
            "allocations_per_run": [grown[steps], grown[2 * steps]],
            "allocations_per_step": per_step}


def sweep_bound_ms(kernel, dtype_name: str) -> tuple:
    """(least ms, "bytes" | "operations") of the sweep's own schedule for
    one launch of ``kernel``: every sub-step reads its region's h-deep
    window of each input once and writes its region of each written field
    once, against the same operations as :func:`bound_ms` (B times that for
    B members)."""
    from repro_torch.kernels.fused import sweep_geoms

    itemsize = 4 if dtype_name == "float32" else 8
    h = kernel.halo
    nbytes = 0
    for g in sweep_geoms(kernel):
        for name, nz in zip(kernel.in_names, kernel.nz):
            nbytes += (g.bx + 2 * h) * (g.by + 2 * h) * nz * itemsize
            if name in kernel.written:
                nbytes += g.bx * g.by * nz * itemsize
    ops = kernel.k * (kernel.nx - 2) * (kernel.ny - 2) * body_ops(kernel)
    t_bytes = kernel.batch * nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = kernel.batch * ops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_conv_library(kernel, padded, omega: float, coords=(0, 0),
                    margin: bool = False, ulps: int = 1):
    """The library call beside a K1 k = 1 launch of the heat3d body: one
    ``F.conv3d`` of the padded field (x and y wrapped by one cell, z not)
    with the 7-point 3×3×3 weight, 1 − 6ω at the centre and ω at each face
    (TF32 off); a ``(B, …)`` stack of padded members as B inputs of the one
    call; with ``margin``, a brick's margin-mode buffer (M = 1, its halo
    from the exchange) at the brick's ``coords``.  It computes the body on
    every cell the body updates (x, y and z interior; K1 keeps the
    others).  Returns (ms, max |diff| from K1's output on the cells one in
    from the field's or brick's x and y edges and off the z ends, one
    float32 ulp of the field's largest value); fails beyond ``ulps`` of
    them (another summation order of the seven terms)."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.fused import launch_fused

    P = padded[0]
    W = seven_point_weight(1.0 - 6.0 * omega, omega, P)

    def lib():
        y = F.conv3d(P.reshape(-1, 1, *P.shape[-3:]), W)
        return y.reshape(*P.shape[:-3], *y.shape[-3:])

    got = lib()[..., 1:-1, 1:-1, :]
    if margin:
        if kernel.margin != 1:
            raise ValueError(f"margin {kernel.margin}: the library call "
                             "reads a brick with one cell of halo")
        want = launch_fused(kernel, padded, coords, out=margin_outputs(
            kernel, padded))[0][..., 2:-2, 2:-2, 1:-1]
    else:
        want = launch_fused(kernel, padded)[0][..., 1:-1, 1:-1, 1:-1]
    err = float((got.double() - want.double()).abs().max())
    ulp = float(np.spacing(np.float32(want.abs().max().item())))
    if err > ulps * ulp:
        raise AssertionError(f"F.conv3d vs K1 on the heat3d body: {err} > "
                             f"{ulps} float32 ulp of {ulp}")
    return cuda_time_ms(lib, repeats=20), err, ulp


def phase_heat3d(steps: int, heat):
    import numpy as np

    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig, record_heat
    from repro_torch.convert import env_from_numpy
    from repro_torch.engine import RunOptions, plan, reset_stats, single_runner, stats
    from repro_torch.kernels.fused import fused_step_ref, launch_fused

    cfg = HeatConfig()
    #: the main path's four runs: (time_tile, resident)
    modes = {"k1": (1, True), "auto": (None, True),
             "k1_repack": (1, False), "auto_repack": (None, False)}
    outs, runs = {}, []
    # --- the main path: counters to 0 just before, read just after -------
    compiler.reset_stats()
    compiler.clear_cache()
    reset_stats()
    reset_counts()
    for tag, (tt, resident) in modes.items():
        wse, T = record_heat(cfg, steps)
        stats.max_time_tile = 1     # so it reads this run's tile
        before = (read_counts(), stats.launches, stats.repacks)
        outs[tag] = wse.make(answer=T, options=RunOptions(
            backend="pallas", time_tile=tt, resident=resident))
        after = read_counts()
        runs.append({"run": tag, "resident": resident,
                     "time_tile": stats.max_time_tile,
                     "k1_launches": after["K1"] - before[0]["K1"],
                     "k1_margin_launches": after["K1m"] - before[0]["K1m"],
                     "k1_entry_launches": after["K1k1"] - before[0]["K1k1"],
                     "sweep_launches": after["K1sw"] - before[0]["K1sw"],
                     "sweep_substeps": after["K1sub"] - before[0]["K1sub"],
                     "engine_launches": stats.launches - before[1],
                     "repacks": stats.repacks - before[2]})
    counts = read_counts()
    fallbacks = compiler.stats.fallbacks
    engine_launches = stats.launches
    # -----------------------------------------------------------------------
    wse, T = record_heat(cfg, steps)
    outs["jit"] = wse.make(answer=T, options=RunOptions(backend="jit"))
    short = {}
    for backend in ("pallas", "jit"):
        wse, T = record_heat(cfg, min(steps, JIT_SHORT_STEPS))
        short[backend] = wse.make(answer=T, options=RunOptions(
            backend=backend, time_tile=1))
    if fallbacks != 0:
        raise AssertionError(f"{fallbacks} interpreter fallbacks on the main path")
    if counts["K1"] == 0 or counts["K1"] != engine_launches:
        raise AssertionError(f"K1 launches {counts['K1']} != engine launches "
                             f"{engine_launches}")
    for r in runs:
        want = r["engine_launches"] if r["resident"] else 0
        if r["k1_launches"] != r["engine_launches"] or r["k1_margin_launches"] != want:
            raise AssertionError(f"{r['run']}: K1 launches by mode {r} do not "
                                 "match the engine's")
        if r["repacks"] != (2 if r["resident"] else r["engine_launches"]):
            raise AssertionError(f"{r['run']}: {r['repacks']} repacks")
        if r["time_tile"] == 1 and r["k1_entry_launches"] != r["k1_launches"]:
            raise AssertionError(f"{r['run']}: {r['k1_entry_launches']} of "
                                 f"{r['k1_launches']} k = 1 launches went "
                                 "through the k = 1 entry")
        if r["time_tile"] > 1 and (r["sweep_launches"] != r["k1_launches"]
                                   or r["sweep_substeps"] != steps):
            raise AssertionError(f"{r['run']}: {r['sweep_launches']} of "
                                 f"{r['k1_launches']} launches went through "
                                 f"the sweep, {r['sweep_substeps']} sub-steps "
                                 f"for {steps} steps")
    for tag, out in outs.items():
        if out.shape != (cfg.nx, cfg.ny, cfg.nz) or not np.isfinite(out).all():
            raise AssertionError(f"{tag}: bad shape {out.shape} or non-finite")
    diffs = {}
    for a, b in (("k1", "auto"), ("k1", "k1_repack"), ("auto", "auto_repack")):
        diffs[f"{a}_vs_{b}"] = float(np.abs(outs[a].astype(np.float64)
                                            - outs[b]).max())
        if not np.array_equal(outs[a], outs[b]):
            raise AssertionError(f"{a} and {b} disagree "
                                 f"(max {diffs[f'{a}_vs_{b}']})")
    short_err = float(np.abs(short["pallas"].astype(np.float64)
                             - short["jit"]).max())
    if short_err > JIT_SHORT_ATOL:
        raise AssertionError(f"pallas vs jit over {JIT_SHORT_STEPS} steps: "
                             f"{short_err} > {JIT_SHORT_ATOL}")
    jit_err = float(np.abs(outs["k1"].astype(np.float64) - outs["jit"]).max())
    jit_atol = steps * float(np.spacing(np.abs(outs["jit"]).max()))
    if jit_err > jit_atol:
        raise AssertionError(f"pallas vs jit over {steps} steps: {jit_err} > "
                             f"{jit_atol} (1 ulp per step)")
    allocs = {tag: allocations_per_step(lambda n: record_heat(cfg, n), steps,
                                        tt)
              for tag, tt in (("k1", 1), ("auto", None))}
    for tag, a in allocs.items():
        if a["allocations_per_step"] != 0:
            raise AssertionError(f"the resident {tag} loop allocates: {a}")

    # --- timing: whole runs on device tensors, CUDA events --------------
    timing = {}
    for tag, opts in [(tag, RunOptions(backend="pallas", time_tile=tt,
                                       resident=resident))
                      for tag, (tt, resident) in modes.items()] + [
                          ("jit", RunOptions(backend="jit"))]:
        wse, T = record_heat(cfg, steps)
        p = plan(wse.program, opts)
        wse.__exit__()
        run = single_runner(p)
        env = env_from_numpy({"T_n": T.init_data}, "cuda")
        ms = cuda_time_ms(lambda: run(env), repeats=3)
        timing[tag] = {"ms_per_step": ms / steps,
                       "time_tile": p.segments[0].time_tile,
                       "margin": p.layout.pad,
                       "host_us_per_step": host_us(lambda: run(env)) / steps,
                       **device_breakdown(lambda: run(env))}
    kern, padded = heat["kernel"], heat["padded"]
    k1_ms = cuda_time_ms(lambda: launch_fused(kern, padded), repeats=20)
    ks, sins = heat["sweep"]["kernel"], heat["sweep"]["inputs"]
    sout = margin_outputs(ks, sins)
    ks_ms = cuda_time_ms(lambda: launch_fused(ks, sins, out=sout), repeats=20)
    ks_plain_ms = cuda_time_ms(lambda: fused_step_ref(ks, sins, out=sout),
                               repeats=2)
    bs_ms, bs_by = bound_ms(ks, cfg.dtype)
    bs_sched_ms, bs_sched_by = sweep_bound_ms(ks, cfg.dtype)
    measured = {tag: {"ms_per_step": t["ms_per_step"],
                      "device_idle_share_unprofiled":
                          t["device_idle_share_unprofiled"],
                      "host_us_per_step": t["host_us_per_step"]}
                for tag, t in timing.items()}
    plain_ms = cuda_time_ms(lambda: fused_step_ref(kern, padded), repeats=5)
    lib_ms, lib_err, lib_ulp = k1_conv_library(kern, padded, cfg.omega)
    b_ms, b_by = bound_ms(kern, cfg.dtype)
    km, ins = heat["margin"]["kernel"], heat["margin"]["inputs"]
    out = margin_outputs(km, ins)
    km_ms = cuda_time_ms(lambda: launch_fused(km, ins, out=out), repeats=20)
    km_plain_ms = cuda_time_ms(lambda: fused_step_ref(km, ins, out=out),
                               repeats=5)
    bm_ms, bm_by = bound_ms(km, cfg.dtype)
    # the launcher's host time per call, the card idle before each
    launch_host = {
        "k1_padded": host_us(lambda: launch_fused(kern, padded), samples=50),
        "k1_margin": host_us(lambda: launch_fused(km, ins, out=out),
                             samples=50),
        "sweep": host_us(lambda: launch_fused(ks, sins, out=sout),
                         samples=50)}
    emit({"phase": "heat3d", "card": card_line(),
          "shape": [cfg.nx, cfg.ny, cfg.nz],
          "dtype": cfg.dtype, "steps": steps, "runs": runs,
          "fallbacks": fallbacks, "launches": counts,
          "engine_launches": engine_launches,
          "max_abs_err": diffs,
          "pallas_vs_jit": {"steps": steps, "max_abs_err": jit_err,
                            "atol": jit_atol},
          "pallas_vs_jit_short": {"steps": min(steps, JIT_SHORT_STEPS),
                                  "max_abs_err": short_err,
                                  "atol": JIT_SHORT_ATOL},
          "resident_allocations": allocs,
          "timing": timing, "launch_host_us": launch_host,
          "bound_ms_per_step_k1": b_ms, "bound_by": b_by,
          "k1_kernel_ms": k1_ms, "k1_plain_ms": plain_ms,
          "k1_library_ms": lib_ms,
          "k1_library_vs_k1": {"max_abs_err": lib_err, "ulp": lib_ulp},
          "k1_margin_kernel_ms": km_ms, "k1_margin_plain_ms": km_plain_ms,
          "k1_margin_bound_ms": bm_ms,
          "sweep_k": ks.k, "sweep_margin_kernel_ms": ks_ms,
          "sweep_margin_plain_ms": ks_plain_ms,
          "sweep_margin_bound_ms": bs_ms,
          "sweep_schedule_bound_ms": bs_sched_ms,
          "sweep_schedule_bound_by": bs_sched_by})
    emit({"phase": "heat3d_predicted_vs_measured", "card": card_line(),
          "predicted": PREDICTED, "measured": measured,
          "k1_entry_ms": {"padded": k1_ms, "margin": km_ms},
          "sweep_entry_ms": {"margin": ks_ms},
          "allocations_per_step": {tag: a["allocations_per_step"]
                                   for tag, a in allocs.items()}})
    by_mode = {"padded": 0, "margin": 0}
    for r in runs:
        by_mode["margin" if r["resident"] else "padded"] += r["k1_entry_launches"]
    return {"k1_padded": {"launches": by_mode["padded"], "err": heat["err"],
                          "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": lib_ms},
            "k1_margin": {"launches": by_mode["margin"],
                          "err": heat["margin"]["err"], "ms": km_ms,
                          "plain_ms": km_plain_ms, "bound_ms": bm_ms,
                          "bound_by": bm_by},
            "sweep": {"launches": counts["K1sw"],
                      "err": heat["sweep"]["err"], "ms": ks_ms,
                      "plain_ms": ks_plain_ms, "bound_ms": bs_ms,
                      "bound_by": bs_by}}


def phase_hazard_make(steps: int, seed: int, heat):
    """The hazard body through ``make`` at 512×512×128 float32 and the auto
    tile, and the hazard kernel's times (``kernel_vs_ref`` built and held
    its float32 margin-mode kernels at k = 1 and the auto tile)."""
    import numpy as np

    import repro_torch as rt
    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.convert import env_from_numpy
    from repro_torch.engine import RunOptions, plan, single_runner
    from repro_torch.kernels.fused import fused_step_ref, launch_fused

    cfg = HeatConfig()
    shape = (cfg.nx, cfg.ny, cfg.nz)
    rng = np.random.default_rng(seed)
    A0 = rng.random(shape, dtype=np.float32)
    C0 = np.float32(0.05) * rng.random(shape, dtype=np.float32)
    B0 = rng.random(shape, dtype=np.float32)

    def record(n):
        return record_coupled(rt, A0, C0, B0, n)[:2]

    outs = {}
    # --- the main path: counters to 0 just before, read just after -------
    compiler.reset_stats()
    reset_counts()
    for tag, resident in (("auto", True), ("auto_repack", False)):
        wse, A = record(steps)
        outs[tag] = wse.make(answer=A, options=RunOptions(
            backend="pallas", time_tile=None, resident=resident))
    counts = read_counts()
    fallbacks = compiler.stats.fallbacks
    # -----------------------------------------------------------------------
    if fallbacks != 0:
        raise AssertionError(f"{fallbacks} interpreter fallbacks on the "
                             "hazard make path")
    if (counts["K1"] == 0 or counts["K1sw"] != counts["K1"]
            or counts["K1hz"] != counts["K1"]
            or counts["K1sub"] != 2 * steps):
        raise AssertionError(f"hazard make: K1 launches {counts['K1']}, "
                             f"sweeps {counts['K1sw']}, hazard "
                             f"{counts['K1hz']}, sub-steps {counts['K1sub']} "
                             f"for 2 × {steps} steps")
    wse, A = record(steps)
    outs["jit"] = wse.make(answer=A, options=RunOptions(backend="jit"))
    short = {}
    for backend in ("pallas", "jit"):
        wse, A = record(min(steps, JIT_SHORT_STEPS))
        short[backend] = wse.make(answer=A, options=RunOptions(
            backend=backend))
    for tag, out in outs.items():
        if out.shape != shape or not np.isfinite(out).all():
            raise AssertionError(f"hazard make {tag}: bad shape {out.shape} "
                                 "or non-finite")
    if not np.array_equal(outs["auto"], outs["auto_repack"]):
        raise AssertionError("hazard make: resident and repacking runs "
                             "disagree")
    short_err = float(np.abs(short["pallas"].astype(np.float64)
                             - short["jit"]).max())
    if short_err > JIT_SHORT_ATOL:
        raise AssertionError(f"hazard make, pallas vs jit over "
                             f"{JIT_SHORT_STEPS} steps: {short_err} > "
                             f"{JIT_SHORT_ATOL}")
    jit_err = float(np.abs(outs["auto"].astype(np.float64)
                           - outs["jit"]).max())
    jit_atol = steps * float(np.spacing(np.abs(outs["jit"]).max()))
    if jit_err > jit_atol:
        raise AssertionError(f"hazard make, pallas vs jit over {steps} steps: "
                             f"{jit_err} > {jit_atol} (1 ulp per step)")
    allocs = allocations_per_step(record, steps, None)
    if allocs["allocations_per_step"] != 0:
        raise AssertionError(f"the resident hazard loop allocates: {allocs}")
    wse, A = record(steps)
    prog = wse.program
    p = plan(prog, RunOptions(backend="pallas", time_tile=None))
    wse.__exit__()
    run = single_runner(p)
    env = env_from_numpy({"A": A0, "C": C0, "B": B0}, "cuda")
    timing = {"ms_per_step": cuda_time_ms(lambda: run(env), repeats=3) / steps,
              "time_tile": p.segments[0].time_tile, "margin": p.layout.pad,
              "host_us_per_step": host_us(lambda: run(env)) / steps,
              **device_breakdown(lambda: run(env))}
    del env, run
    hz = heat.pop("hazard")
    k_auto = max(hz)
    times = {}
    for k in sorted(hz):
        kern, ins = hz[k]["kernel"], hz[k]["inputs"]
        out = margin_outputs(kern, ins)
        b_ms, b_by = bound_ms(kern, cfg.dtype)
        times[k] = {"ms": cuda_time_ms(lambda: launch_fused(kern, ins, out=out),
                                       repeats=20),
                    "plain_ms": cuda_time_ms(
                        lambda: fused_step_ref(kern, ins, out=out), repeats=2),
                    "bound_ms": b_ms, "bound_by": b_by, "err": hz[k]["err"]}
        if k > 1:
            times[k]["sweep_schedule_bound_ms"] = sweep_bound_ms(kern,
                                                                 cfg.dtype)[0]
        del kern, ins, out
    emit({"phase": "hazard_make", "card": card_line(),
          "body": "coupled_advdiff_hazard", "shape": list(shape),
          "dtype": cfg.dtype, "steps": steps, "launches": counts,
          "fallbacks": fallbacks,
          "pallas_vs_jit": {"steps": steps, "max_abs_err": jit_err,
                            "atol": jit_atol},
          "pallas_vs_jit_short": {"steps": min(steps, JIT_SHORT_STEPS),
                                  "max_abs_err": short_err,
                                  "atol": JIT_SHORT_ATOL},
          "resident_allocations": allocs, "timing": timing,
          "margin_launch": {str(k): t for k, t in times.items()},
          "predicted": {k: PREDICTED[k] for k in (
              "card", "hazard_k8_margin_ms", "hazard_k1_margin_ms",
              "hazard_make_ms_per_step", "hazard_allocations_per_step")}})
    row = dict(times[k_auto], launches=counts["K1hz"], k=k_auto)
    if 1 in times:
        row.update({f"k1_{key}": times[1][key]
                    for key in ("ms", "plain_ms", "bound_ms", "err")})
    return row


# ---------------------------------------------------------------------------
# slice 11: ensembles (K1's member axis, masked batched Krylov)
# ---------------------------------------------------------------------------

def heat_members(cfg, B: int, seed: int):
    """``B`` heat3d initial fields from ``seed``: ``make_field(cfg)`` with
    its interior moved by up to ±50 K, as a ``(B, X, Y, Z)`` stack."""
    import numpy as np

    from repro_torch.configs.heat3d import make_field

    rng = np.random.default_rng(seed)
    stack = np.broadcast_to(make_field(cfg), (B, cfg.nx, cfg.ny, cfg.nz)).copy()
    for b in range(B):
        stack[b, 1:-1, 1:-1, 1:-1] += rng.uniform(
            -50.0, 50.0, (cfg.nx - 2, cfg.ny - 2, cfg.nz - 2)).astype(
                stack.dtype)
    return stack


def compare_batched(kernel, single, inputs, margin_mode):
    """K1 built for B members on ``(B, …)`` card stacks against its plain
    version (whole outputs, margins included) and against B launches of
    ``single`` (the same body built for one member): max |diff| (must be
    0)."""
    import torch

    from repro_torch.kernels.fused import fused_step_ref, launch_fused

    def outs(xs):
        return margin_outputs(kernel, xs) if margin_mode else None

    got = launch_via_entry(kernel, inputs, out=outs(inputs))
    want = fused_step_ref(kernel, inputs, out=outs(inputs))
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError("batched K1 produced non-finite values")
        err = max(err, (g.double() - w.double()).abs().max().item())
        if not torch.equal(g, w):
            raise AssertionError(f"batched K1 differs from fused_step_ref "
                                 f"(max {err})")
    del want
    for b in range(kernel.batch):
        xs = [t[b] for t in inputs]
        one = launch_fused(single, xs, out=outs(xs))
        for g, w in zip(got, one):
            if not torch.equal(g[b], w):
                raise AssertionError(f"member {b} of the batched launch "
                                     "differs from its single launch")
    return err


def phase_ensemble_make(steps: int, seed: int, heat):
    """``HeatConfig()`` with ``ENSEMBLE_MAKE_MEMBERS`` members from ``seed``
    through ``Ensemble.make`` at k = 1 and the auto tile, resident and
    repacking; K1's batched launches against their plain version and the
    single launches; times beside ``PREDICTED``."""
    import numpy as np
    import torch

    import repro_torch as rt
    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig, record_heat
    from repro_torch.convert import env_from_numpy
    from repro_torch.engine import RunOptions, plan, single_runner, stats
    from repro_torch.kernels.fused import fused_step_ref, launch_fused

    cfg = HeatConfig()
    B = ENSEMBLE_MAKE_MEMBERS
    members = heat_members(cfg, B, seed)
    wse, T = record_heat(cfg, steps, init=members[0])
    ens = rt.Ensemble(wse.program, T, overrides={"T_n": members})
    modes = {"k1": (1, True), "auto": (None, True),
             "k1_repack": (1, False), "auto_repack": (None, False)}
    outs, runs = {}, []
    # --- the main path: counters to 0 just before, read just after -------
    compiler.reset_stats()
    reset_counts()
    for tag, (tt, resident) in modes.items():
        stats.max_time_tile = 1
        before = (read_counts(), stats.launches, stats.ensemble_members)
        outs[tag] = ens.make(options=RunOptions(
            backend="pallas", time_tile=tt, resident=resident))
        after = read_counts()
        runs.append({"run": tag, "resident": resident,
                     "time_tile": stats.max_time_tile,
                     "k1_launches": after["K1"] - before[0]["K1"],
                     "batch_launches": after["K1b"] - before[0]["K1b"],
                     "k1_entry_launches": after["K1k1"] - before[0]["K1k1"],
                     "sweep_launches": after["K1sw"] - before[0]["K1sw"],
                     "margin_launches": after["K1m"] - before[0]["K1m"],
                     "engine_launches": stats.launches - before[1],
                     "members": stats.ensemble_members - before[2]})
    counts = read_counts()
    fallbacks = compiler.stats.fallbacks
    # -----------------------------------------------------------------------
    if fallbacks:
        raise AssertionError(f"{fallbacks} interpreter fallbacks on the "
                             "ensemble make path")
    for r in runs:
        n = r["engine_launches"]
        if (n == 0 or r["k1_launches"] != n or r["batch_launches"] != n
                or r["members"] != B
                or r["margin_launches"] != (n if r["resident"] else 0)):
            raise AssertionError(f"ensemble {r['run']}: K1 launches {r} do "
                                 "not match the engine's")
        route = "k1_entry_launches" if r["time_tile"] == 1 else "sweep_launches"
        if r[route] != n:
            raise AssertionError(f"ensemble {r['run']}: {r[route]} of {n} "
                                 f"launches through {route}")
    for tag, out in outs.items():
        if out.shape != members.shape or not np.isfinite(out).all():
            raise AssertionError(f"ensemble {tag}: bad shape {out.shape} or "
                                 "non-finite")
        if not np.array_equal(out, outs["k1"]):
            raise AssertionError(f"ensemble {tag} and k1 disagree")
    for b in range(B):
        wse, T = record_heat(cfg, steps, init=members[b])
        single = wse.make(answer=T, options=RunOptions(backend="pallas",
                                                       time_tile=1))
        if not np.array_equal(outs["k1"][b], single):
            raise AssertionError(f"ensemble member {b} differs from its "
                                 "single make")
    del outs, single
    allocs = {tag: allocations_per_step(lambda n: record_heat(cfg, n), steps,
                                        tt, members={"T_n": members})
              for tag, tt in (("k1", 1), ("auto", None))}
    for tag, a in allocs.items():
        if a["allocations_per_step"] != 0:
            raise AssertionError(f"the resident ensemble {tag} loop "
                                 f"allocates: {a}")

    # --- timing: whole runs on device stacks, CUDA events ---------------
    timing = {}
    for tag, (tt, resident) in modes.items():
        wse, T = record_heat(cfg, steps)
        p = plan(wse.program, RunOptions(backend="pallas", time_tile=tt,
                                         resident=resident, batch=B))
        wse.__exit__()
        run = single_runner(p)
        env = env_from_numpy({"T_n": members}, "cuda")
        ms = cuda_time_ms(lambda: run(env), repeats=2)
        host = host_us(lambda: run(env), samples=3)
        timing[tag] = {"ms_per_step": ms / steps,
                       "ms_per_member_step": ms / steps / B,
                       "time_tile": p.segments[0].time_tile,
                       "host_us_per_member_step": host / steps / B,
                       **device_breakdown(lambda: run(env))}
        del env, run
    # --- K1's batched launches at the main path's shapes ----------------
    wse, T = record_heat(cfg, steps)
    ops, shapes, dtypes = wse.program.ops, {"T_n": T.shape}, {"T_n": T.dtype}
    wse.__exit__()
    dev = torch.device("cuda")
    env = {"T_n": members}
    rows, cases = {}, []
    for tag, k in (("k1", 1), ("sweep", heat["sweep"]["kernel"].k)):
        for margin_mode in (True, False):
            single = _build_kernel(ops, shapes, dtypes, k, dev,
                                   margin=k if margin_mode else 0)
            kern = _build_kernel(ops, shapes, dtypes, k, dev,
                                 margin=k if margin_mode else 0, batch=B)
            ins = (_resident_inputs(kern, env, dev) if margin_mode
                   else _padded_inputs(kern, env, dev))
            err = compare_batched(kern, single, ins, margin_mode)
            cases.append({"route": tag, "k": k, "members": B,
                          "mode": "margin" if margin_mode else "padded",
                          "max_abs_err": err})
            if tag == "k1" and not margin_mode:
                # the library call on the B padded members in one call;
                # cuDNN picks another algorithm at N = 8, whose sum of the
                # seven terms rounds up to 2 ulps from K1's (first card run)
                lib_ms, lib_err, lib_ulp = k1_conv_library(
                    kern, ins, cfg.omega, ulps=LIBRARY_ULPS)
                rows[tag].update(library_ms=lib_ms, library_vs_k1={
                    "max_abs_err": lib_err, "ulp": lib_ulp})
            if margin_mode:
                out = margin_outputs(kern, ins)
                b_ms, b_by = bound_ms(kern, cfg.dtype)
                rows[tag] = {
                    "ms": cuda_time_ms(lambda: launch_fused(kern, ins, out=out),
                                       repeats=10),
                    "plain_ms": cuda_time_ms(
                        lambda: fused_step_ref(kern, ins, out=out), repeats=1),
                    "bound_ms": b_ms, "bound_by": b_by, "err": err, "k": k,
                    "single_ms": cuda_time_ms(
                        lambda: launch_fused(single, [t[0] for t in ins],
                                             out=[o[0] for o in out]),
                        repeats=10)}
                if k > 1:
                    rows[tag]["sweep_schedule_bound_ms"] = sweep_bound_ms(
                        kern, cfg.dtype)[0]
                del out
            del ins
    measured = {"k1_margin_ms": rows["k1"]["ms"],
                "sweep_margin_ms": rows["sweep"]["ms"],
                "k1_conv3d_library_members_ms": rows["k1"]["library_ms"],
                "ms_per_member_step": {t: v["ms_per_member_step"]
                                       for t, v in timing.items()},
                "host_us_per_member_step": {t: v["host_us_per_member_step"]
                                            for t, v in timing.items()},
                "allocations_per_step": {t: a["allocations_per_step"]
                                         for t, a in allocs.items()}}
    emit({"phase": "ensemble_make", "card": card_line(),
          "shape": [cfg.nx, cfg.ny, cfg.nz], "dtype": cfg.dtype,
          "members": B, "steps": steps, "seed": seed, "runs": runs,
          "fallbacks": fallbacks, "launches": counts,
          "kernel_cases": cases, "resident_allocations": allocs,
          "timing": timing, "launch": rows,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("ensemble")
                        or k == "k1_conv3d_library_members_ms"},
          "measured": measured})
    by_route = {"k1": sum(r["batch_launches"] for r in runs
                          if r["time_tile"] == 1),
                "sweep": sum(r["batch_launches"] for r in runs
                             if r["time_tile"] > 1)}
    return {tag: dict(rows[tag], launches=by_route[tag],
                      err=max(c["max_abs_err"] for c in cases
                              if c["route"] == tag))
            for tag in rows}


def varcoef_relative_residual(x, T0, C, w):
    """‖b − A x‖ / ‖b‖ of ``record_varcoef_btcs``'s system, in float64 by
    plain slicing on the card: A = I + ωC·(6I − S) on the written cells
    (x, y interior, z interior), identity elsewhere; b = T0."""
    import torch

    x = torch.as_tensor(x, device="cuda").double()
    b = torch.as_tensor(T0, device="cuda").double()
    C = torch.as_tensor(C, device="cuda").double()[1:-1, 1:-1, 1:-1]
    Ax = x.clone()
    xi = x[1:-1, 1:-1, 1:-1]
    Ax[1:-1, 1:-1, 1:-1] = xi + w * C * (6.0 * xi - neighbours(x))
    return float(torch.linalg.vector_norm(b - Ax) / torch.linalg.vector_norm(b))


def phase_ensemble_solve(seed: int):
    """BTCS at ``HeatConfig()`` width with ``ENSEMBLE_SOLVE_MEMBERS``
    members through ``solve(ensemble, …)``: cg and pipecg from per-member
    states (guesses) from ``seed``, bicgstab with per-member diffusivities;
    every member CONVERGED, its float64 residual within
    ``SOLVE_REL_TOL``, within 10·tol of its own single solve."""
    import numpy as np

    import repro_torch as rt
    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig, make_field
    from repro_torch.engine import RunOptions, stats
    from repro_torch.solver import btcs_program, record_varcoef_btcs

    cfg = HeatConfig()
    B = ENSEMBLE_SOLVE_MEMBERS
    shape = (cfg.nx, cfg.ny, cfg.nz)
    states = heat_members(cfg, B, seed + 1)
    T0 = make_field(cfg)
    coefs = np.stack([np.full(shape, 0.2 * (b + 1) ** 2, np.float32)
                      for b in range(B)])
    psi = 1.0 / (1.0 + 6.0 * cfg.omega)
    norms = []
    for b in range(B):
        rhs = states[b].astype(np.float64)
        rhs[1:-1, 1:-1, 1:-1] *= psi
        norms.append(float(np.linalg.norm(rhs)))
    norms.append(float(np.linalg.norm(T0.astype(np.float64))))
    # half the residual bound, so the float64 check has room for the
    # float32 recurrence's drift from the true residual
    tol = 0.5 * SOLVE_REL_TOL * min(norms)
    opts = RunOptions(backend="pallas")
    cases, total = [], dict.fromkeys(read_counts(), 0)
    for method in ("cg", "pipecg", "bicgstab"):
        if method == "bicgstab":
            wse, T, C = record_varcoef_btcs(T0, coefs[0], cfg.omega)
            wse.__exit__()
            ens = rt.Ensemble(wse.program, T, overrides={C.name: coefs})
        else:
            ens = rt.Ensemble(btcs_program(shape, cfg.omega, init_data=T0),
                              "T", overrides={"T": states})
        # --- the main path: counters to 0 just before, read just after ---
        compiler.reset_stats()
        reset_counts()
        t0 = time.perf_counter()
        x, info = rt.solve(ens, method=method, tol=tol, maxiter=cfg.maxiter,
                           options=opts, return_info=True)
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        fallbacks = compiler.stats.fallbacks
        member_iterations = list(stats.member_iterations)
        # -------------------------------------------------------------------
        for key in total:
            total[key] += counts[key]
        outcomes = [str(o) for o in info.outcomes[0]]
        rel, diff = [], []
        for b in range(B):
            if method == "bicgstab":
                rel.append(varcoef_relative_residual(x[b], T0, coefs[b],
                                                     cfg.omega))
                wse, T, _ = record_varcoef_btcs(T0, coefs[b], cfg.omega)
                single = wse.solve(T, method=method, tol=tol,
                                   maxiter=cfg.maxiter, options=opts)
            else:
                rel.append(btcs_relative_residual(x[b], states[b], cfg.omega))
                single = rt.solve(btcs_program(shape, cfg.omega,
                                               init_data=states[b]), "T",
                                  method=method, tol=tol, maxiter=cfg.maxiter,
                                  options=opts)
            diff.append(float(np.abs(x[b].astype(np.float64) - single).max()))
        case = {"method": method, "members": B, "outcomes": outcomes,
                "iterations": info.iterations[0].tolist(),
                "member_iterations": member_iterations,
                "residual_reported": info.residual[0].tolist(),
                "independent_f64_relative_residual": rel,
                "max_abs_diff_from_single_solve": diff,
                "launches": counts, "fallbacks": fallbacks,
                "ms_per_solve_host_clock": wall_ms}
        cases.append(case)
        if x.shape != (B,) + shape or not np.isfinite(x).all():
            raise AssertionError(f"ensemble {method}: bad shape or non-finite")
        if outcomes != ["CONVERGED"] * B:
            raise AssertionError(f"ensemble {method}: outcomes {outcomes}")
        if max(rel) > SOLVE_REL_TOL:
            raise AssertionError(f"ensemble {method}: independent residuals "
                                 f"{rel} > {SOLVE_REL_TOL}")
        if max(diff) > 10 * tol:
            raise AssertionError(f"ensemble {method}: members {diff} from "
                                 f"their single solves > {10 * tol}")
        if fallbacks or counts["K1b"] == 0 or counts["K1b"] != counts["K1"]:
            raise AssertionError(f"ensemble {method}: K1 launches {counts}, "
                                 f"{fallbacks} fallbacks")
    emit({"phase": "ensemble_solve", "shape": list(shape), "dtype": cfg.dtype,
          "members": B, "seed": seed, "tol": tol,
          "tol_relative": 0.5 * SOLVE_REL_TOL, "cases": cases,
          "launches": total})
    return total


# ---------------------------------------------------------------------------
# slice 2: K2, K3, K4 and the implicit solves
# ---------------------------------------------------------------------------

def kernel_counters():
    """The launch counter of every kernel wrapper, by kernel."""
    from repro_torch.kernels.dotprod import launch_dual_dot
    from repro_torch.kernels.fused import launch_fused
    from repro_torch.kernels.transfer import launch_prolong, launch_restrict

    from repro_torch.kernels.spmv import launch_spmv_dot
    from repro_torch.kernels.stencil7 import launch_stencil7, launch_stencil_planes

    return {"K1": launch_fused, "K2": launch_dual_dot, "K3": launch_restrict,
            "K4": launch_prolong, "K5": launch_spmv_dot, "K6": launch_stencil7,
            "K7": launch_stencil_planes}


def reset_counts() -> None:
    from repro_torch.kernels.fused import launch_fused
    from repro_torch.kernels.transfer import launch_prolong, launch_restrict

    for fn in kernel_counters().values():
        fn.launches = 0
    launch_restrict.by_level.clear()
    launch_prolong.by_level.clear()
    launch_fused.margin_launches = 0
    launch_fused.k1_launches = 0
    launch_fused.sweep_launches = 0
    launch_fused.sweep_substeps = 0
    launch_fused.hazard_launches = 0
    launch_fused.batch_launches = 0
    launch_fused.brick_launches = 0
    launch_fused.region_launches = 0


def level_counts() -> dict:
    """K3's and K4's launches by level pair, keyed by the fine shape
    ``"NXxNYxNZ"``."""
    from repro_torch.kernels.transfer import launch_prolong, launch_restrict

    return {k: {"x".join(map(str, shape)): n for shape, n in fn.by_level.items()}
            for k, fn in (("K3", launch_restrict), ("K4", launch_prolong))}


def add_levels(total: dict, levels: dict) -> dict:
    """``total`` (K3/K4 launches by level pair) plus ``levels``."""
    for k, by in levels.items():
        for pair, n in by.items():
            total.setdefault(k, {})[pair] = total.get(k, {}).get(pair, 0) + n
    return total


def read_counts() -> dict:
    """Launches by kernel; ``K1m`` is K1's margin-mode share of ``K1``,
    ``K1k1`` the k = 1 route's share, ``K1sw`` the sweep's share,
    ``K1sub`` the sweep's sub-steps, ``K1hz`` the hazard bodies' share,
    ``K1b`` the share of kernels built for more than one member, ``K1br``
    the share of kernels built for a mesh's bricks and ``K1rg`` the share
    of region kernels (the overlap's interior launches)."""
    from repro_torch.kernels.fused import launch_fused

    counts = {k: fn.launches for k, fn in kernel_counters().items()}
    counts["K1m"] = launch_fused.margin_launches
    counts["K1k1"] = launch_fused.k1_launches
    counts["K1sw"] = launch_fused.sweep_launches
    counts["K1sub"] = launch_fused.sweep_substeps
    counts["K1hz"] = launch_fused.hazard_launches
    counts["K1b"] = launch_fused.batch_launches
    counts["K1br"] = launch_fused.brick_launches
    counts["K1rg"] = launch_fused.region_launches
    return counts


def phase_dual_dot_vs_ref(seed: int):
    import torch

    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.dotprod import dual_dot_ref, launch_dual_dot

    cfg = HeatConfig()
    shape = (cfg.nx, cfg.ny, cfg.nz)
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases, main = [], {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        a, b, c, d = (torch.randn(shape, device="cuda", generator=g, dtype=dtype)
                      for _ in range(4))
        # pipelined CG passes (r, r, w, r) and PCG (r, z, r, r): two distinct
        # operands, the main path's case
        for label, ops4 in (("distinct", (a, b, c, d)), ("aliased_rrwr", (a, a, b, a))):
            got = ops.dual_dot(*ops4)
            again = ops.dual_dot(*ops4)
            exact = dual_dot_ref(*(t.double() for t in ops4))
            scale = torch.stack([(ops4[0].double() * ops4[1]).abs().sum(),
                                 (ops4[2].double() * ops4[3]).abs().sum()])
            err = (got.double() - exact).abs()
            ratio = float((err / scale).max())
            if not torch.equal(got, again):
                raise AssertionError(f"K2 is not deterministic ({name}, {label})")
            if not bool(torch.isfinite(got).all()) or ratio > K2_REL[name]:
                raise AssertionError(f"K2 {name} {label}: |err|/Σ|ab| = {ratio} > "
                                     f"{K2_REL[name]}")
            cases.append({"dtype": name, "operands": label,
                          "max_abs_err": float(err.max()),
                          "err_over_sum_abs": ratio, "bound": K2_REL[name]})
            if dtype == torch.float32 and label == "aliased_rrwr":
                main = {"ops": ops4, "err": float(err.max())}
    a, _, b, _ = main["ops"]
    ops4 = main["ops"]
    ms = cuda_time_ms(lambda: launch_dual_dot(*ops4), repeats=50)
    wrapper_ms = cuda_time_ms(lambda: ops.dual_dot(*ops4), repeats=50)
    plain_ms = cuda_time_ms(lambda: dual_dot_ref(*ops4), repeats=20)
    lib_ms = cuda_time_ms(lambda: (torch.dot(a.view(-1), a.view(-1)),
                                   torch.dot(b.view(-1), a.view(-1))), repeats=50)
    n = a.numel()
    blocks = -(-n // 8192)
    nbytes = 2 * n * 4 + blocks * 2 * 4       # two distinct operands + partials
    b_ms, b_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                     (4 * n / PEAK_FLOPS["float32"] * 1e3, "operations"))
    emit({"phase": "dual_dot_vs_ref", "shape": list(shape),
          "tolerance": "|K2 - dual_dot_ref(f64)| <= rel * sum|a_i b_i|",
          "cases": cases, "timed": "float32, (r, r, w, r)",
          "k2_ms": ms, "k2_with_partial_sum_ms": wrapper_ms, "plain_ms": plain_ms,
          "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
          "bound_bytes": nbytes, "distinct_operands": 2})
    return {"err": main["err"], "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def hierarchy_shapes(shape):
    """The fine shapes of every level pair of ``shape``'s hierarchy."""
    from repro_torch.compiler.ir import coarsen_shape, coarsenable

    out = []
    while coarsenable(shape):
        out.append(tuple(shape))
        shape = coarsen_shape(shape)
    return out


def transfer_ops(fine, coarse):
    """Operations of the plain separable transfers for one level pair:
    restriction 4 per x/y/z-pass output, prolongation 2 per odd (averaged)
    pass output."""
    m = [n // 2 - 1 for n in fine]
    (nx, ny, nz), (cx, cy, cz) = fine, coarse
    r_ops = 4 * (m[0] * ny * nz + m[0] * m[1] * nz + m[0] * m[1] * m[2])
    p_ops = 2 * ((m[0] + 1) * cy * cz + nx * (m[1] + 1) * cz + nx * ny * (m[2] + 1))
    return r_ops, p_ops


def phase_transfer_vs_ref(seed: int):
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.compiler.ir import coarsen_shape
    from repro_torch.kernels.transfer import (launch_prolong, launch_restrict,
                                              prolong_ref, restrict_ref)

    cfg = HeatConfig()
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    pairs, by_pair = [], {"K3": {}, "K4": {}}
    for dtype in (torch.float32, torch.float64):
        for fine in hierarchy_shapes((cfg.nx, cfg.ny, cfg.nz)):
            coarse = coarsen_shape(fine)
            f = torch.randn(fine, device="cuda", generator=g, dtype=dtype)
            c = torch.randn(coarse, device="cuda", generator=g, dtype=dtype)
            errs = []
            for kern, plain in ((launch_restrict(f), restrict_ref(f)),
                                (launch_prolong(c, fine), prolong_ref(c, fine))):
                torch.cuda.synchronize()
                errs.append(float((kern.double() - plain.double()).abs().max()))
                if not torch.equal(kern, plain):
                    raise AssertionError(f"K3/K4 differ from the plain version at "
                                         f"{fine} {dtype} (max {errs[-1]})")
            pairs.append({"fine": list(fine), "coarse": list(coarse),
                          "dtype": str(dtype).removeprefix("torch."),
                          "k3_max_abs_err": errs[0], "k4_max_abs_err": errs[1]})
            if dtype == torch.float32:
                # every level pair's time, queued (the coarse pairs take
                # microseconds, less than their Python launch path)
                nbytes = 4 * (f.numel() + c.numel())
                key = "x".join(map(str, fine))
                by_pair["K3"][key] = {"ms": queued_ms(lambda: launch_restrict(f), 50),
                                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
                by_pair["K4"][key] = {
                    "ms": queued_ms(lambda: launch_prolong(c, fine), 50),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    # time at the finest pair, float32 (the main path's)
    fine = (cfg.nx, cfg.ny, cfg.nz)
    coarse = coarsen_shape(fine)
    f = torch.randn(fine, device="cuda", generator=g)
    c = torch.randn(coarse, device="cuda", generator=g)
    w = torch.tensor([0.25, 0.5, 0.25], device="cuda")
    W = (w[:, None, None] * w[None, :, None] * w[None, None, :])[None, None]
    v = torch.tensor([0.5, 1.0, 0.5], device="cuda")
    V = (v[:, None, None] * v[None, :, None] * v[None, None, :])[None, None]
    f5 = f[None, None, 1:, 1:, 1:].contiguous()
    c5 = c[None, None].contiguous()
    lib_r = lambda: F.conv3d(f5, W, stride=2)                    # noqa: E731
    lib_p = lambda: F.conv_transpose3d(c5, V, stride=2)          # noqa: E731
    # the library calls compute the same interiors (up to association)
    lib_r_err = float((lib_r()[0, 0] - restrict_ref(f)[1:-1, 1:-1, 1:-1]).abs().max())
    n = fine
    lib_p_err = float((lib_p()[0, 0, 2:n[0], 2:n[1], 2:n[2]]
                       - prolong_ref(c, fine)[1:-1, 1:-1, 1:-1]).abs().max())
    r_ops, p_ops = transfer_ops(fine, coarse)
    cells_f = fine[0] * fine[1] * fine[2]
    cells_c = coarse[0] * coarse[1] * coarse[2]
    rows = {}
    for key, kern, plain, lib, ops_n in (
            ("K3", lambda: launch_restrict(f), lambda: restrict_ref(f), lib_r, r_ops),
            ("K4", lambda: launch_prolong(c, fine), lambda: prolong_ref(c, fine),
             lib_p, p_ops)):
        nbytes = 4 * (cells_f + cells_c)
        b_ms, b_by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                         (ops_n / PEAK_FLOPS["float32"] * 1e3, "operations"))
        rows[key] = {"ms": cuda_time_ms(kern, repeats=50),
                     "plain_ms": cuda_time_ms(plain, repeats=10),
                     "library_ms": cuda_time_ms(lib, repeats=20),
                     "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
                     "err": max(p[f"{key.lower()}_max_abs_err"] for p in pairs),
                     "ms_by_level_pair": by_pair[key]}
    emit({"phase": "transfer_vs_ref", "tolerance": "bitwise", "pairs": pairs,
          "timed": {"fine": list(fine), "coarse": list(coarse), "dtype": "float32"},
          "K3": {k: v for k, v in rows["K3"].items() if k != "err"},
          "K4": {k: v for k, v in rows["K4"].items() if k != "err"},
          "predicted": {k: PREDICTED[k] for k in ("card", "k4_ms", "k3_ms_within")},
          "library_vs_plain_max_abs_err": {"conv3d": lib_r_err,
                                           "conv_transpose3d": lib_p_err}})
    return rows


def btcs_relative_residual(x, T0, w):
    """‖b − A x‖ / ‖b‖ of the BTCS system, in float64 by plain slicing on the
    card: A = I − ωψ·S on the interior, identity on the Moat rows; b = ψ·T0
    on the interior, T0 on the Moat."""
    import torch

    psi = 1.0 / (1.0 + 6.0 * w)
    x = torch.as_tensor(x, device="cuda").double()
    b = torch.as_tensor(T0, device="cuda").double().clone()
    b[1:-1, 1:-1, 1:-1] *= psi
    Ax = x.clone()
    Ax[1:-1, 1:-1, 1:-1] = x[1:-1, 1:-1, 1:-1] - w * psi * neighbours(x)
    return float(torch.linalg.vector_norm(b - Ax) / torch.linalg.vector_norm(b))


def poisson_relative_residual(x, F):
    """‖b − A x‖ / ‖b‖ of the Poisson system, in float64 by plain slicing on
    the card: A = 6I − S on the interior, identity on the (zero) Moat rows;
    b = F on the interior."""
    import torch

    x = torch.as_tensor(x, device="cuda").double()
    F = torch.as_tensor(F, device="cuda").double()
    b = torch.zeros_like(x)
    b[1:-1, 1:-1, 1:-1] = F[1:-1, 1:-1, 1:-1]
    Ax = x.clone()
    Ax[1:-1, 1:-1, 1:-1] = 6.0 * x[1:-1, 1:-1, 1:-1] - neighbours(x)
    return float(torch.linalg.vector_norm(b - Ax) / torch.linalg.vector_norm(b))


def neighbours(x):
    """Sum of the six face neighbours over the interior."""
    c = (slice(1, -1),) * 3
    total = 0
    for ax in range(3):
        lo = list(c)
        hi = list(c)
        lo[ax] = slice(0, -2)
        hi[ax] = slice(2, None)
        total = total + x[tuple(lo)] + x[tuple(hi)]
    return total


def time_solve(step, x0, iterations):
    """ms per solve and per iteration of ``step(x0)`` on device tensors,
    after a warm-up solve, and its device breakdown."""
    ms = cuda_time_ms(lambda: step(x0), repeats=3)
    return {"ms_per_solve": ms, "ms_per_iteration": ms / max(iterations, 1),
            **device_breakdown(lambda: step(x0), top=6)}


def run_solve_path(record, method, precondition, tol, maxiter):
    """One solve through the user's entry point, with the launch counters
    set to 0 just before and read just after."""
    from repro_torch import compiler
    from repro_torch.engine import RunOptions, reset_stats, stats

    compiler.reset_stats()
    reset_stats()
    reset_counts()
    wse, T = record()
    x, info = wse.solve(T, method=method, precondition=precondition, tol=tol,
                        maxiter=maxiter, options=RunOptions(backend="pallas"),
                        return_info=True)
    counts = read_counts()
    counts["by_level"] = level_counts()
    return x, info, counts, {"fallbacks": compiler.stats.fallbacks,
                             "kernels_built": compiler.stats.kernels_built,
                             "mg_level_log": [[list(shape), f, r] for shape, f, r
                                              in stats.mg_level_log]}


def phase_solve_heat3d():
    import numpy as np
    import torch

    from repro_torch.configs.heat3d import HeatConfig, make_field, record_implicit
    from repro_torch.engine import RunOptions
    from repro_torch.solver import make_solver

    cfg = HeatConfig()
    T0 = make_field(cfg)
    b = T0.astype(np.float64)
    b[1:-1, 1:-1, 1:-1] *= 1.0 / (1.0 + 6.0 * cfg.omega)
    norm_b = float(np.linalg.norm(b))
    tol = SOLVE_REL_TOL * norm_b
    x0 = torch.tensor(T0, device="cuda")
    runs, total = [], dict.fromkeys(read_counts(), 0)
    levels = {}
    for method, pc in (("cg", None), ("pipecg", None), ("cg", "mg")):
        x, info, counts, comp = run_solve_path(
            lambda: record_implicit(cfg), method, pc, tol, cfg.maxiter)
        outcome = str(info.outcomes[0])
        iters = int(info.iterations[0])
        rel = btcs_relative_residual(x, T0, cfg.omega)
        wse, T = record_implicit(cfg)
        x_jit, info_jit = wse.solve(T, method=method, precondition=pc, tol=tol,
                                    maxiter=cfg.maxiter,
                                    options=RunOptions(backend="jit"),
                                    return_info=True)
        jit_iters = int(info_jit.iterations[0])
        jit_err = float(np.abs(x.astype(np.float64) - x_jit).max())
        jit_atol = SOLVE_JIT_ULPS * max(iters, 1) * float(
            np.spacing(np.abs(x_jit).max().astype(x_jit.dtype)))
        wse, T = record_implicit(cfg)
        prog = wse.program
        wse.__exit__()
        step = make_solver(prog, "T", method=method, precondition=pc,
                           backend="pallas", tol=tol, maxiter=cfg.maxiter)
        timing = time_solve(step, x0, iters)
        need = {"K1", "K1k1"} | ({"K2"} if method == "pipecg" or pc else set()) \
            | ({"K3", "K4"} if pc else set())
        runs.append({"method": method, "precondition": pc, "outcome": outcome,
                     "iterations": iters, "residual_reported": float(info.residual[0]),
                     "independent_f64_relative_residual": rel,
                     "jit_iterations": jit_iters,
                     "pallas_vs_jit_max_abs_err": jit_err,
                     "pallas_vs_jit_atol": jit_atol, "launches": counts,
                     "fallbacks": comp["fallbacks"], **timing})
        if outcome != "CONVERGED":
            raise AssertionError(f"solve {method}/{pc} ended {outcome}")
        if not np.isfinite(x).all() or x.shape != T0.shape:
            raise AssertionError(f"solve {method}/{pc}: bad shape or non-finite")
        if rel > SOLVE_REL_TOL:
            raise AssertionError(f"solve {method}/{pc}: independent residual "
                                 f"{rel} > {SOLVE_REL_TOL}")
        if jit_iters != iters:
            raise AssertionError(f"solve {method}/{pc}: {iters} iterations, "
                                 f"{jit_iters} with backend='jit'")
        if jit_err > jit_atol:
            raise AssertionError(f"solve {method}/{pc}: pallas vs jit {jit_err}"
                                 f" > {jit_atol} ({SOLVE_JIT_ULPS} ulp of the "
                                 "field per iteration)")
        if comp["fallbacks"]:
            raise AssertionError(f"solve {method}/{pc}: interpreter fallbacks")
        missing = [k for k in sorted(need) if counts[k] == 0]
        if missing:
            raise AssertionError(f"solve {method}/{pc}: {missing} never launched")
        for k in total:
            total[k] += counts[k]
        add_levels(levels, counts["by_level"])
    total["by_level"] = levels
    emit({"phase": "solve_heat3d", "shape": [cfg.nx, cfg.ny, cfg.nz],
          "dtype": cfg.dtype, "norm_b": norm_b, "tol": tol,
          "tol_relative": SOLVE_REL_TOL, "runs": runs, "launches": total})
    return total


def phase_mg_poisson(seed: int):
    import numpy as np
    import torch

    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.solver import make_solver, poisson_program, record_poisson

    cfg = HeatConfig()
    shape = (cfg.nx, cfg.ny, cfg.nz)
    rng = np.random.default_rng(seed)
    F = np.zeros(shape, np.float32)
    F[1:-1, 1:-1, 1:-1] = rng.normal(
        size=tuple(n - 2 for n in shape)).astype(np.float32)
    F /= np.linalg.norm(F)
    tol = SOLVE_REL_TOL
    x0 = torch.zeros(shape, device="cuda")
    runs, total = [], dict.fromkeys(read_counts(), 0)
    levels = {}
    for method, pc, maxiter in (("mg", None, 60), ("cg", "mg", 200)):
        x, info, counts, comp = run_solve_path(
            lambda: record_poisson(F), method, pc, tol, maxiter)
        outcome = str(info.outcomes[0])
        iters = int(info.iterations[0])
        rel = poisson_relative_residual(x, F)
        step = make_solver(poisson_program(shape, rhs=F), "T", method=method,
                           precondition=pc, backend="pallas", tol=tol,
                           maxiter=maxiter)
        timing = time_solve(step, x0, iters)
        runs.append({"method": method, "precondition": pc, "outcome": outcome,
                     "iterations": iters, "residual_reported": float(info.residual[0]),
                     "independent_f64_relative_residual": rel, "launches": counts,
                     "fallbacks": comp["fallbacks"], **timing,
                     "mg_level_log": comp["mg_level_log"]})
        if outcome != "CONVERGED" or not np.isfinite(x).all():
            raise AssertionError(f"poisson {method}/{pc} ended {outcome}")
        if rel > tol:
            raise AssertionError(f"poisson {method}/{pc}: independent residual "
                                 f"{rel} > {tol}")
        if comp["fallbacks"]:
            raise AssertionError(f"poisson {method}/{pc}: interpreter fallbacks")
        need = {"K1", "K1k1", "K3", "K4"} | ({"K2"} if pc else set())
        missing = [k for k in sorted(need) if counts[k] == 0]
        if missing:
            raise AssertionError(f"poisson {method}/{pc}: {missing} never launched")
        for k in total:
            total[k] += counts[k]
        add_levels(levels, counts["by_level"])
    total["by_level"] = levels
    emit({"phase": "mg_poisson", "shape": list(shape), "seed": seed,
          "rhs": "unit-norm standard normal interior", "tol_relative": tol,
          "runs": runs, "launches": total})
    return total


# ---------------------------------------------------------------------------
# slice 3: K5, K6, K7 and the legacy brick drivers
# ---------------------------------------------------------------------------

#: brick extents of the reference's kernel tests (tests/test_kernels.py)
LEGACY_TEST_SHAPES = ((3, 7, 9), (6, 10, 5), (7, 130, 12))
#: K5/K6 bricks: the 1×1 and 2×2 meshes' bricks of 512×512×128, then the
#: reference's test shapes
LEGACY_BRICKS = ((512, 512, 128), (256, 256, 128)) + LEGACY_TEST_SHAPES
#: K5's extra brick: ragged in x, y and z, with Z > 128 (two z chunks)
K5_EXTRA_BRICKS = ((70, 37, 130),)
#: the make_sharded_ftcs variants, in the reference's order of precedence
FTCS_VARIANTS = (("baseline", {}), ("overlap", {"overlap": True}),
                 ("halo_depth4", {"halo_depth": 4}),
                 ("kernel", {"use_kernel": True}),
                 ("planes", {"use_kernel": "planes"}))


def roofline(nbytes: float, ops: float, dtype_name: str) -> tuple:
    """(least ms, "bytes" | "operations") for moving ``nbytes`` and doing
    ``ops`` floating-point operations of ``dtype_name``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seven_point_weight(c_diag: float, c_off: float, like):
    """The 3×3×3 ``conv3d`` weight of ``c_diag·c + c_off·Σ6``."""
    import torch

    W = torch.zeros((1, 1, 3, 3, 3), dtype=like.dtype, device=like.device)
    W[0, 0, 1, 1, 1] = c_diag
    for d in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        W[(0, 0) + d] = c_off
    return W


def stencil_conv(P, W):
    """The library counterpart of K6: z edge-replicated by ``F.pad``, then
    one ``F.conv3d`` over the padded brick."""
    import torch.nn.functional as F

    return F.conv3d(F.pad(P[None, None], (1, 1, 0, 0, 0, 0), mode="replicate"),
                    W)[0, 0]


def spmv_conv(P, W):
    """The library counterpart of K5: :func:`stencil_conv` and
    ``torch.dot``."""
    import torch

    av = stencil_conv(P, W)
    return av, torch.dot(P[1:-1, 1:-1].reshape(-1), av.reshape(-1))


def phase_legacy_kernels_vs_ref(seed: int):
    import torch

    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.spmv import (launch_spmv_dot, spmv_dot_ref,
                                          spmv_dot_tiles_ref, spmv_launch_shape,
                                          tile_sums)
    from repro_torch.kernels.stencil7 import (affine_stencil_ref, k7_launch_shape,
                                              launch_stencil7,
                                              launch_stencil_planes,
                                              stencil_planes_ref)

    cfg = HeatConfig()
    w = cfg.omega
    a, wpsi = 1.0 - 6.0 * w, w / (1.0 + 6.0 * w)
    g = torch.Generator(device="cuda").manual_seed(seed + 2)

    def rnd(shape, dtype):
        return torch.randn(shape, device="cuda", generator=g, dtype=dtype)

    def check_k7(brick, mesh_shape, coords, dtype):
        """K7 on a random brick and planes at ``coords`` of ``mesh_shape``,
        bitwise against stencil_planes_ref and on a second run; returns
        the case's record and its arguments."""
        bx, by, nz = brick
        T = rnd(brick, dtype)
        planes = [rnd(s, dtype) for s in ((1, by, nz), (1, by, nz),
                                          (bx, 1, nz), (bx, 1, nz))]
        args = (T, *planes, coords, a, w, mesh_shape[0] * bx, mesh_shape[1] * by)
        got, again = launch_stencil_planes(*args), launch_stencil_planes(*args)
        want = stencil_planes_ref(*args)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        name = str(dtype).removeprefix("torch.")
        if not torch.equal(got, want):
            raise AssertionError(f"K7 differs from stencil_planes_ref on brick "
                                 f"{coords} of {mesh_shape}, {brick} {name} "
                                 f"(max {err})")
        if not torch.equal(got, again):
            raise AssertionError(f"K7 is not deterministic at {brick} {name}")
        return {"mesh": list(mesh_shape), "coords": list(coords),
                "brick": list(brick), "dtype": name, "max_abs_err": err}, args

    k6, k5, k7, main = [], [], [], {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        for bx, by, nz in LEGACY_BRICKS + K5_EXTRA_BRICKS:
            P = rnd((bx + 2, by + 2, nz), dtype)
            if (bx, by, nz) in LEGACY_BRICKS:
                got, want = launch_stencil7(P, a, w), affine_stencil_ref(P, a, w)
                torch.cuda.synchronize()
                err6 = float((got.double() - want.double()).abs().max())
                if not torch.equal(got, want):
                    raise AssertionError(f"K6 differs from affine_stencil_ref at "
                                         f"{(bx, by, nz)} {name} (max {err6})")
                k6.append({"brick": [bx, by, nz], "dtype": name, "max_abs_err": err6})
            av, parts = launch_spmv_dot(P, 1.0, -wpsi)
            av2, parts2 = launch_spmv_dot(P, 1.0, -wpsi)
            want_av, plain_dot = spmv_dot_ref(P, 1.0, -wpsi)
            torch.cuda.synchronize()
            prod = P[1:-1, 1:-1].double() * want_av.double()
            dot, dot2 = torch.sum(parts), torch.sum(parts2)
            dot_err = abs(float(dot) - float(prod.sum()))
            ratio = dot_err / float(prod.abs().sum())
            if not torch.equal(av, want_av):
                raise AssertionError(f"K5's Ap differs from spmv_dot_ref at "
                                     f"{(bx, by, nz)} {name}")
            if not (torch.equal(av, av2) and torch.equal(parts, parts2)):
                raise AssertionError(f"K5 is not deterministic at {(bx, by, nz)} {name}")
            if not bool(torch.isfinite(dot)) or ratio > K5_REL[name]:
                raise AssertionError(f"K5 dot {name} {(bx, by, nz)}: |err|/Σ|c·Ap| "
                                     f"= {ratio} > {K5_REL[name]}")
            # each tile's partial against its float64 plain version, within
            # K5_REL of the tile's Σ|c·Ap|
            shape = spmv_launch_shape(bx, by, nz)
            exact = spmv_dot_tiles_ref(P, 1.0, -wpsi, dtype=torch.float64)
            tile_ratio = float(((parts.double() - exact).abs()
                                / tile_sums(prod.abs(), shape)).max())
            if parts.numel() != shape.partials or not tile_ratio <= K5_REL[name]:
                raise AssertionError(f"K5 partials {name} {(bx, by, nz)}: "
                                     f"{parts.numel()} of {shape.partials}, max "
                                     f"|err|/Σ|c·Ap| per tile {tile_ratio} > "
                                     f"{K5_REL[name]}")
            k5.append({"brick": [bx, by, nz], "dtype": name, "ap_max_abs_err": 0.0,
                       "dot_abs_err": dot_err, "dot_err_over_sum_abs": ratio,
                       "plain_dot_abs_err": abs(float(plain_dot) - float(prod.sum())),
                       "partials": parts.numel(), "xc": shape.xc,
                       "tile_err_over_tile_sum_abs_max": tile_ratio,
                       "bound": K5_REL[name]})
            if dtype == torch.float32 and (bx, by) == (cfg.nx, cfg.ny):
                main.update(P=P, k5_err=dot_err)
            if dtype == torch.float32 and (bx, by) == (cfg.nx // 2, cfg.ny // 2):
                main["P_small"] = P
        for mesh_shape in ((1, 1), (2, 2)):
            brick = (cfg.nx // mesh_shape[0], cfg.ny // mesh_shape[1], cfg.nz)
            for coords in itertools.product(range(mesh_shape[0]),
                                            range(mesh_shape[1])):
                case, args = check_k7(brick, mesh_shape, coords, dtype)
                k7.append(case)
                if dtype == torch.float32 and coords == (0, 0):
                    main["planes" if mesh_shape == (1, 1) else "planes_small"] = args
        # the middle brick of a 3×3 mesh reads all four planes
        for brick in LEGACY_TEST_SHAPES + K5_EXTRA_BRICKS:
            k7.append(check_k7(brick, (3, 3), (1, 1), dtype)[0])

    # time at the main path's float32 shapes
    P, args = main["P"], main["planes"]
    cells = cfg.nx * cfg.ny * cfg.nz
    interior = (cfg.nx - 2) * (cfg.ny - 2) * (cfg.nz - 2)
    blocks = launch_spmv_dot(P, 1.0, -wpsi)[1].numel()
    W6, W5 = seven_point_weight(a, w, P), seven_point_weight(1.0, -wpsi, P)
    lib6_err = float((stencil_conv(P, W6) - affine_stencil_ref(P, a, w)).abs().max())
    rows = {}
    for key, kern, plain, lib, nbytes, ops_n in (
            ("K6", lambda: launch_stencil7(P, a, w), lambda: affine_stencil_ref(P, a, w),
             lambda: stencil_conv(P, W6), 4 * (P.numel() + cells), 8 * cells),
            ("K5", lambda: launch_spmv_dot(P, 1.0, -wpsi),
             lambda: spmv_dot_ref(P, 1.0, -wpsi), lambda: spmv_conv(P, W5),
             4 * (P.numel() + cells + blocks), 10 * cells),
            ("K7", lambda: launch_stencil_planes(*args), lambda: stencil_planes_ref(*args),
             None, 4 * (2 * cells + 2 * (cfg.ny + cfg.nx) * cfg.nz), 8 * interior)):
        b_ms, b_by = roofline(nbytes, ops_n, "float32")
        rows[key] = {"ms": cuda_time_ms(kern, repeats=50),
                     "plain_ms": cuda_time_ms(plain, repeats=10),
                     "library_ms": cuda_time_ms(lib, repeats=10) if lib else None,
                     "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes}
    rows["K5"]["with_partial_sum_ms"] = cuda_time_ms(
        lambda: ops.spmv_hex_dot(P, 1.0, -wpsi), repeats=50)
    rows["K5"]["partials"] = blocks
    rows["K5"]["queued_ms"] = queued_ms(lambda: launch_spmv_dot(P, 1.0, -wpsi),
                                        repeats=50)
    # K5 on the 2×2 mesh's brick, which carries most of legacy_btcs's launches
    Ps = main["P_small"]
    small_blocks = launch_spmv_dot(Ps, 1.0, -wpsi)[1].numel()
    small_cells = Ps[1:-1, 1:-1].numel()
    small_bytes = 4 * (Ps.numel() + small_cells + small_blocks)
    sb_ms, sb_by = roofline(small_bytes, 10 * small_cells, "float32")
    rows["K5"]["small_brick"] = {
        "padded": list(Ps.shape), "partials": small_blocks,
        "timed": "queued behind a sleep kernel (queued_ms)",
        "ms": queued_ms(lambda: launch_spmv_dot(Ps, 1.0, -wpsi), repeats=200),
        "with_partial_sum_ms": queued_ms(lambda: ops.spmv_hex_dot(Ps, 1.0, -wpsi),
                                         repeats=200),
        "host_paced_ms": cuda_time_ms(lambda: launch_spmv_dot(Ps, 1.0, -wpsi),
                                      repeats=200),
        "plain_ms": cuda_time_ms(lambda: spmv_dot_ref(Ps, 1.0, -wpsi), repeats=10),
        "library_ms": cuda_time_ms(lambda: spmv_conv(Ps, W5), repeats=10),
        "bound_ms": sb_ms, "bound_by": sb_by, "bound_bytes": small_bytes}
    # K7 queued on both meshes' bricks, with its launch shape
    for key, targs in (("queued", args), ("small_brick", main["planes_small"])):
        T = targs[0]
        s7 = k7_launch_shape(*T.shape)
        n7 = T.numel()
        k7_bytes = 4 * (2 * n7 + 2 * (T.shape[0] + T.shape[1]) * T.shape[2])
        k7_ms, k7_by = roofline(k7_bytes, 8 * n7, "float32")
        timed = {"brick": list(T.shape), "grid": list(s7.grid), "block": list(s7.block),
                 "xc": s7.xc, "timed": "queued behind a sleep kernel (queued_ms)",
                 "ms": queued_ms(lambda: launch_stencil_planes(*targs), repeats=200),
                 "bound_ms": k7_ms, "bound_by": k7_by, "bound_bytes": k7_bytes}
        if key == "queued":
            rows["K7"]["queued"] = timed
        else:
            rows["K7"]["small_brick"] = dict(
                timed, host_paced_ms=cuda_time_ms(
                    lambda: launch_stencil_planes(*targs), repeats=200),
                plain_ms=cuda_time_ms(lambda: stencil_planes_ref(*targs), repeats=10),
                library_ms=None)
    rows["K6"]["err"] = max(c["max_abs_err"] for c in k6)
    rows["K7"]["err"] = max(c["max_abs_err"] for c in k7)
    rows["K5"]["err"] = main["k5_err"]
    emit({"phase": "legacy_kernels_vs_ref",
          "tolerance": {"K6": "bitwise", "K7": "bitwise", "K5 Ap": "bitwise",
                        "K5 dot": "|K5 - exact(f64)| <= rel * sum|c*Ap|"},
          "K6_cases": k6, "K7_cases": k7, "K5_cases": k5,
          "timed": {"padded": list(P.shape), "brick": list(args[0].shape),
                    "dtype": "float32"},
          "library": {"K6": "F.pad(z, replicate) + F.conv3d, TF32 off",
                      "K5": "the same + torch.dot",
                      "K7": None},
          "library_vs_plain_max_abs_err": {"K6": lib6_err},
          "predicted": {k: PREDICTED[k] for k in ("card", "k5_ms",
                                                  "k5_with_partial_sum_over_ms_us",
                                                  "k7_ms")},
          **{k: {kk: vv for kk, vv in v.items() if kk != "err"} for k, v in rows.items()}})
    return rows


def phase_legacy_ftcs(steps: int, seed: int):
    import numpy as np
    import torch

    from repro_torch.configs.heat3d import HeatConfig, make_field
    from repro_torch.core.explicit import ftcs_solve, make_sharded_ftcs
    from repro_torch.core.mesh import make_mesh

    cfg = HeatConfig()
    shape, w = (cfg.nx, cfg.ny, cfg.nz), cfg.omega
    meshes = {"1x1": make_mesh((1, 1), ("data", "model")),
              "2x2": make_mesh((2, 2), ("data", "model"))}

    def run_variants(mesh, T, n):
        outs, per = {}, {}
        for name, kw in FTCS_VARIANTS:
            k = kw.get("halo_depth", 1)
            if n % k:
                raise ValueError(f"{n} steps do not divide into halo depth {k}")
            step, sharding = make_sharded_ftcs(mesh, shape, w, steps_per_call=n // k,
                                               **kw)
            x = sharding.shard(T)
            before = read_counts()
            out = step(x).gather()
            torch.cuda.synchronize()
            per[name] = {kk: v - before[kk] for kk, v in read_counts().items()}
            if not torch.isfinite(out).all() or tuple(out.shape) != shape:
                raise AssertionError(f"legacy_ftcs {name}: bad shape or non-finite")
            outs[name] = out
        bricks = mesh.size
        for name, d in per.items():
            want6 = n * bricks if name == "kernel" else 0
            want7 = n * bricks if name == "planes" else 0
            if (d["K6"], d["K7"]) != (want6, want7):
                raise AssertionError(f"legacy_ftcs {name} on {mesh.dims}: K6/K7 "
                                     f"launches {(d['K6'], d['K7'])}, expected "
                                     f"{(want6, want7)}")
        base = outs["baseline"]
        for name, out in outs.items():
            if not torch.equal(out, base):
                err = float((out.double() - base.double()).abs().max())
                raise AssertionError(f"legacy_ftcs: {name} differs from the baseline "
                                     f"on {mesh.dims} (max {err})")
        return outs, per

    # --- the main path: counters to 0 just before, read just after -------
    T0 = torch.tensor(make_field(cfg), device="cuda")
    reset_counts()
    heat, heat_counts = run_variants(meshes["1x1"], T0, steps)
    main_counts = read_counts()
    # -----------------------------------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    R0 = 300.0 + 200.0 * torch.rand(shape, device="cuda", generator=g)
    rand_steps = 20
    rand = {m: run_variants(mesh, R0, rand_steps)[0]["baseline"]
            for m, mesh in meshes.items()}
    if not torch.equal(rand["2x2"], rand["1x1"]):
        raise AssertionError("legacy_ftcs: the 2×2 mesh differs from the 1×1 mesh")
    solved = ftcs_solve(T0, w, steps)
    solve_err = float((solved.double() - heat["baseline"].double()).abs().max())
    solve_atol = steps * float(np.spacing(np.float32(heat["baseline"].abs().max().item())))
    if not torch.isfinite(solved).all() or solve_err > solve_atol:
        raise AssertionError(f"ftcs_solve vs make_sharded_ftcs: {solve_err} > "
                             f"{solve_atol} (1 ulp per step)")

    # --- timing: 20-step calls on device bricks, CUDA events -------------
    timing = {}
    n = 20
    for m, mesh in meshes.items():
        for name, kw in FTCS_VARIANTS:
            step, sharding = make_sharded_ftcs(
                mesh, shape, w, steps_per_call=n // kw.get("halo_depth", 1), **kw)
            x = sharding.shard(T0)
            timing[f"{m} {name}"] = {
                "ms_per_step": cuda_time_ms(lambda: step(x), repeats=3) / n,
                **device_breakdown(lambda: step(x))}
    timing["ftcs_solve"] = {
        "ms_per_step": cuda_time_ms(lambda: ftcs_solve(T0, w, n), repeats=3) / n,
        **device_breakdown(lambda: ftcs_solve(T0, w, n))}
    emit({"phase": "legacy_ftcs", "shape": list(shape), "dtype": cfg.dtype,
          "steps": steps, "variants": [v[0] for v in FTCS_VARIANTS],
          "launches": heat_counts, "main_path_launches": main_counts,
          "variants_bitwise": True,
          "random_field": {"seed": seed, "steps": rand_steps,
                           "meshes": list(meshes), "bitwise": True},
          "ftcs_solve_vs_sharded": {"max_abs_err": solve_err, "atol": solve_atol},
          "timing": timing,
          "predicted": {k: PREDICTED[k] for k in ("card",
                                                  "legacy_ftcs_planes_ms_per_step")}})
    return main_counts


def initial_iteration_state(method: str, x0, w: float):
    """A seeded state of ``make_sharded_iteration``, computed in float64
    from ``x0`` and rounded to float32: the start of the method on
    ``A x = b`` with ``b = rhs(x0)``."""
    import torch

    psi = 1.0 / (1.0 + 6.0 * w)
    x = x0.double()
    b = x.clone()
    b[1:-1, 1:-1, 1:-1] *= psi

    def A(v):
        out = v.clone()
        out[1:-1, 1:-1, 1:-1] = v[1:-1, 1:-1, 1:-1] - w * psi * neighbours(v)
        return out

    r = b - A(x)
    f32 = lambda *vs: tuple(torch.as_tensor(v, device="cuda").float() for v in vs)  # noqa: E731
    if method == "cg":
        return f32(x, r, r, (r * r).sum())
    if method == "pipecg":
        z = torch.zeros_like(x)
        return f32(x, r, A(r), z, z, z, 1e30, 1.0)
    lmin, lmax = 1.0 - 6.0 * w * psi, 1.0 + 6.0 * w * psi
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    d = r / theta
    return f32(x + d, r, d, delta / theta)


def phase_legacy_btcs(seed: int):
    import numpy as np
    import torch

    from repro_torch.configs.heat3d import HeatConfig, make_field
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.implicit import btcs_solve, make_sharded_iteration
    from repro_torch.core.mesh import BrickArray, make_mesh

    cfg = HeatConfig()
    shape, w = (cfg.nx, cfg.ny, cfg.nz), cfg.omega
    meshes = {"1x1": make_mesh((1, 1), ("data", "model")),
              "2x2": make_mesh((2, 2), ("data", "model"))}
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    x0 = 300.0 + 200.0 * torch.rand(shape, device="cuda", generator=g,
                                    dtype=torch.float64)
    ulp = float(np.spacing(np.float32(x0.abs().max().item())))
    methods = ("cg", "pipecg", "chebyshev")
    states = {m: initial_iteration_state(m, x0, w) for m in methods}
    del x0
    iters = LEGACY_ITERS
    # where each method's runs are compared: CG and pipelined CG at the last
    # iteration before the recurrence residual ‖rᵢ‖ (state entry 1) of the
    # plain 1×1 run first falls to KRYLOV_FLOOR·‖r₀‖; chebyshev at the last
    check_at, history = {"chebyshev": iters}, {}
    for method in ("cg", "pipecg"):
        step, specs = make_sharded_iteration(meshes["1x1"], shape, w, method=method)
        s = state_from_numpy(states[method], specs[0].sharding)
        norms = [float(torch.linalg.vector_norm(s[1].gather().double()))]
        for _ in range(iters):
            s = step(s)
            norms.append(float(torch.linalg.vector_norm(s[1].gather().double())))
        history[method] = [v / norms[0] for v in norms]
        below = [i for i, h in enumerate(history[method]) if h <= KRYLOV_FLOOR]
        check_at[method] = below[0] - 1 if below else iters
        if check_at[method] < 1:
            raise AssertionError(f"legacy_btcs {method}: no iteration above the floor")
    runs, results, steps, last_x = [], {}, {}, {}
    # --- the main path: counters to 0 just before, read just after -------
    reset_counts()
    for method in methods:
        for m, mesh in meshes.items():
            for use_kernel in (False, True):
                step, specs = make_sharded_iteration(mesh, shape, w, method=method,
                                                     use_kernel=use_kernel)
                s = state_from_numpy(states[method], specs[0].sharding)
                before = read_counts()
                for i in range(iters):
                    s = step(s)
                    if i + 1 == check_at[method]:
                        out = tuple(v.gather() if isinstance(v, BrickArray) else v
                                    for v in s)
                torch.cuda.synchronize()
                d = {k: v - before[k] for k, v in read_counts().items()}
                final = [v.gather() if isinstance(v, BrickArray) else v for v in s]
                if not all(bool(torch.isfinite(v).all()) for v in (*out, *final)):
                    raise AssertionError(f"legacy_btcs {method} {m} kernel={use_kernel}: "
                                         "non-finite state")
                last_x[method, m, use_kernel] = final[0]
                del final
                want5 = iters * mesh.size if use_kernel else 0
                want2 = want5 if method == "pipecg" else 0
                if (d["K5"], d["K2"]) != (want5, want2):
                    raise AssertionError(f"legacy_btcs {method} {m} kernel={use_kernel}: "
                                         f"K5/K2 launches {(d['K5'], d['K2'])}, "
                                         f"expected {(want5, want2)}")
                results[method, m, use_kernel] = out
                steps[method, m, use_kernel] = (step, specs)
                runs.append({"method": method, "mesh": m, "use_kernel": use_kernel,
                             "launches": {k: d[k] for k in ("K2", "K5")}})
    main_counts = read_counts()
    # -----------------------------------------------------------------------
    k5_by_mesh = {m: sum(r["launches"]["K5"] for r in runs if r["mesh"] == m)
                  for m in meshes}
    checks = []
    for method in methods:
        n = check_at[method]
        atol = ITER_ULPS * n * ulp
        pairs = [((method, "1x1", True), (method, "1x1", False)),
                 ((method, "2x2", False), (method, "1x1", False)),
                 ((method, "2x2", True), (method, "1x1", True))]
        for got_key, want_key in pairs:
            got, want = results[got_key], results[want_key]
            vec_err = max(float((g_.double() - w_.double()).abs().max())
                          for g_, w_ in zip(got, want) if g_.ndim)
            scal = [abs(float(g_) / float(w_) - 1.0) if float(w_) else 0.0
                    for g_, w_ in zip(got, want) if not g_.ndim]
            bitwise = all(torch.equal(g_.to(w_.device), w_) for g_, w_ in zip(got, want))
            last_err = float((last_x[got_key].double()
                              - last_x[want_key].double()).abs().max())
            checks.append({"got": list(got_key), "want": list(want_key),
                           "at_iteration": n, "vectors_max_abs_err": vec_err,
                           "atol": atol, "scalars_rel_diff": scal,
                           "scalars_rel_bound": ITER_SCALAR_REL, "bitwise": bitwise,
                           f"x_max_abs_err_at_iteration_{iters}": last_err})
            if method == "chebyshev" and not bitwise:
                raise AssertionError(f"legacy_btcs chebyshev {got_key} vs {want_key}: "
                                     f"not bitwise (max {vec_err})")
            if vec_err > atol:
                raise AssertionError(f"legacy_btcs {got_key} vs {want_key}: {vec_err} > "
                                     f"{atol} ({ITER_ULPS} ulp of the field per "
                                     "iteration)")
            if max(scal, default=0.0) > ITER_SCALAR_REL:
                raise AssertionError(f"legacy_btcs {got_key} vs {want_key}: recurrence "
                                     f"scalars differ by {scal} > {ITER_SCALAR_REL} "
                                     "relative")
    timing = {}
    for (method, m, use_kernel), (step, specs) in steps.items():
        s = state_from_numpy(states[method], specs[0].sharding)
        key = f"{method} kernel={use_kernel}" + ("" if m == "1x1" else f" mesh={m}")
        timing[key] = {
            "ms_per_iteration": cuda_time_ms(lambda: step(s), repeats=20),
            **device_breakdown(lambda: step(s))}
    # one legacy BTCS time step with cg, on one device
    T0 = make_field(cfg)
    b = T0.astype(np.float64)
    b[1:-1, 1:-1, 1:-1] *= 1.0 / (1.0 + 6.0 * w)
    tol = SOLVE_REL_TOL * float(np.linalg.norm(b))
    T0c = torch.tensor(T0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T1, (its, res) = btcs_solve(T0c, w, 1, method="cg", tol=tol, maxiter=cfg.maxiter)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    rel = btcs_relative_residual(T1, T0, w)
    if not torch.isfinite(T1).all() or tuple(T1.shape) != shape or rel > SOLVE_REL_TOL:
        raise AssertionError(f"btcs_solve cg: independent residual {rel} > "
                             f"{SOLVE_REL_TOL} or a bad result")
    emit({"phase": "legacy_btcs", "shape": list(shape), "dtype": "float32",
          "iterations": iters, "seed": seed, "compared_at": check_at,
          "residual_history_over_r0": history, "krylov_floor": KRYLOV_FLOOR,
          "runs": runs, "checks": checks,
          "main_path_launches": main_counts, "k5_launches_by_mesh": k5_by_mesh,
          "timing": timing,
          "btcs_solve": {"method": "cg", "tol": tol, "iterations": int(its[0]),
                         "residual_reported": float(res[0]),
                         "independent_f64_relative_residual": rel,
                         "ms_host_clock": solve_ms}})
    return main_counts, k5_by_mesh


# ---------------------------------------------------------------------------
# slice 12: sharded bricks on a 2×2 mesh of the one card
# ---------------------------------------------------------------------------

#: the mesh of the sharded phases: four bricks, all on the one card
SHARD_MESH = (2, 2)
#: a sharded solve vs the single-device one: the same operator arithmetic
#: per cell (K1 per brick), the dots summed per brick then added in brick
#: order, so the iterates differ by rounding only (tests/test_solver_api.py
#: and tests/test_multigrid.py's bounds)
SHARD_SOLVE_ATOL = {"cg": 2e-4, "pipecg": 2e-4, "cg+mg": 1e-4}


def sharded_allocations_per_step(record, steps: int, time_tile, mesh,
                                 overlap=False) -> dict:
    """:func:`allocations_per_step` of the resident sharded loop on
    ``mesh``: the growth of ``allocation.all.allocated`` over a
    ``2·steps`` run less that over a ``steps`` run, divided by ``steps``."""
    import torch

    from repro_torch.core.mesh import NamedSharding
    from repro_torch.engine import RunOptions, plan, sharded_runner

    grown = {}
    for n in (steps, 2 * steps):
        wse, _ = record(n)
        prog = wse.program
        p = plan(prog, RunOptions(backend="pallas", time_tile=time_tile,
                                  mesh=mesh, overlap=overlap))
        wse.__exit__()
        run = sharded_runner(p)
        sh = NamedSharding(mesh)
        env = {name: list(sh.shard(f.init_data).bricks)
               for name, f in prog.fields.items()}
        run(env)
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
        run(env)
        torch.cuda.synchronize()
        grown[n] = torch.cuda.memory_stats()["allocation.all.allocated"] - a0
    return {"steps": [steps, 2 * steps], "time_tile": time_tile,
            "allocations_per_run": [grown[steps], grown[2 * steps]],
            "allocations_per_step": (grown[2 * steps] - grown[steps]) / steps}


def _brick_kernel(ops, shapes, dtypes, k, mesh, margin):
    """K1 for the bricks of ``mesh`` as the sharded step builds it: the
    brick extent, the global extent for the Moat, ``wrap=False``."""
    import torch

    from repro_torch.compiler.codegen import _field_specs
    from repro_torch.compiler.ir import lower_group
    from repro_torch.kernels.fused import build_fused_call

    group = lower_group(ops)
    specs, (nx, ny) = _field_specs(group, shapes, dtypes)
    mx, my = mesh.dims
    kernel, _ = build_fused_call(group.updates, specs, group.halo, nx // mx,
                                 ny // my, nx, ny, time_tile=k, wrap=False,
                                 device=torch.device("cuda"), margin=margin)
    return kernel


def _brick_inputs(kernel, env, mesh):
    """Per brick of ``mesh`` (x-major): the margin-mode inputs the resident
    sharded step gives ``kernel`` — every field cut into bricks, entered to
    margin ``kernel.margin`` and refreshed to depth ``k·h`` by the halo
    exchange; and the brick's global origin."""
    import torch

    from repro_torch.core.halo import halo_refresh
    from repro_torch.core.mesh import NamedSharding
    from repro_torch.engine.layout import HaloLayout

    lay = HaloLayout(pad=kernel.margin, shapes={})
    sh = NamedSharding(mesh)
    fields = []
    for n in kernel.in_names:
        bricks = [lay.enter({n: t})[n] for t in sh.shard(torch.tensor(
            env[n], device="cuda")).bricks]
        fields.append(halo_refresh(bricks, kernel.margin, kernel.pad, mesh))
    coords = [(cx * kernel.bx, cy * kernel.by)
              for cx, cy in map(mesh.coords, range(mesh.size))]
    return [list(ins) for ins in zip(*fields)], coords


def brick_bound_ms(kernel, dtype_name: str, schedule: bool = False) -> tuple:
    """(least ms, "bytes" | "operations") of one launch of ``kernel`` on a
    brick: its window of each input read once and its brick of each output
    written once (with ``schedule``, the sweep's own schedule: each
    sub-step's region window read and region written, as
    :func:`sweep_bound_ms`), against the body's operations on the brick's
    cells for k sub-steps; a region kernel's region in place of the brick,
    B times that for B members."""
    from repro_torch.kernels.fused import sweep_geoms

    itemsize = 4 if dtype_name == "float32" else 8
    ph = kernel.pad
    bx, by = kernel.span        # a region kernel's region
    regions = ([(g.bx, g.by, kernel.halo) for g in sweep_geoms(kernel)]
               if schedule else [(bx, by, ph)])
    nbytes = 0
    for rx, ry, h in regions:
        for name, nz in zip(kernel.in_names, kernel.nz):
            nbytes += (rx + 2 * h) * (ry + 2 * h) * nz * itemsize
            if name in kernel.written:
                nbytes += rx * ry * nz * itemsize
    ops = kernel.k * bx * by * body_ops(kernel)
    t_bytes = kernel.batch * nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = kernel.batch * ops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_sharded_make(steps: int, heat):
    """``HeatConfig()`` on a 2×2 mesh of the card through ``make(mesh=…)``:
    bitwise the single-device runs, K1 on every brick against its plain
    version, times beside ``PREDICTED``."""
    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig, record_heat
    from repro_torch.core.mesh import NamedSharding, make_mesh
    from repro_torch.engine import (RunOptions, plan, reset_stats,
                                    sharded_runner, stats)
    from repro_torch.kernels.fused import fused_step_ref, launch_fused

    cfg = HeatConfig()
    mesh = make_mesh(SHARD_MESH)
    n_bricks = mesh.size
    modes = {"k1": (1, True), "auto": (None, True),
             "k1_repack": (1, False), "auto_repack": (None, False)}
    outs, runs = {}, []
    # --- the main path: counters to 0 just before, read just after -------
    compiler.reset_stats()
    compiler.clear_cache()
    reset_stats()
    reset_counts()
    for tag, (tt, resident) in modes.items():
        wse, T = record_heat(cfg, steps)
        stats.max_time_tile = 1
        before = (read_counts(), stats.launches, stats.repacks)
        outs[tag] = wse.make(answer=T, options=RunOptions(
            backend="pallas", time_tile=tt, resident=resident, mesh=mesh))
        after = read_counts()
        runs.append({"run": tag, "resident": resident,
                     "time_tile": stats.max_time_tile,
                     "k1_launches": after["K1"] - before[0]["K1"],
                     "k1_margin_launches": after["K1m"] - before[0]["K1m"],
                     "k1_entry_launches": after["K1k1"] - before[0]["K1k1"],
                     "sweep_launches": after["K1sw"] - before[0]["K1sw"],
                     "sweep_substeps": after["K1sub"] - before[0]["K1sub"],
                     "brick_launches": after["K1br"] - before[0]["K1br"],
                     "engine_launches": stats.launches - before[1],
                     "repacks": stats.repacks - before[2]})
    counts = read_counts()
    fallbacks = compiler.stats.fallbacks
    # -----------------------------------------------------------------------
    if fallbacks:
        raise AssertionError(f"{fallbacks} interpreter fallbacks on the "
                             "sharded make path")
    for r in runs:
        n = r["engine_launches"]
        if (n == 0 or r["k1_launches"] != n_bricks * n
                or r["brick_launches"] != r["k1_launches"]):
            raise AssertionError(f"sharded {r['run']}: K1 launches {r} are "
                                 f"not {n_bricks} × the engine's")
        if r["k1_margin_launches"] != (r["k1_launches"] if r["resident"]
                                       else 0):
            raise AssertionError(f"sharded {r['run']}: margin launches {r}")
        if r["repacks"] != (2 if r["resident"] else n):
            raise AssertionError(f"sharded {r['run']}: {r['repacks']} repacks")
        route = "k1_entry_launches" if r["time_tile"] == 1 else "sweep_launches"
        if r[route] != r["k1_launches"]:
            raise AssertionError(f"sharded {r['run']}: {r[route]} of "
                                 f"{r['k1_launches']} launches through {route}")
        if r["time_tile"] > 1 and r["sweep_substeps"] != n_bricks * steps:
            raise AssertionError(f"sharded {r['run']}: {r['sweep_substeps']} "
                                 f"sub-steps for {steps} steps")
    wse, T = record_heat(cfg, steps)
    single = wse.make(answer=T, options=RunOptions(backend="pallas",
                                                   time_tile=1))
    diffs = {}
    for tag, out in outs.items():
        if out.shape != (cfg.nx, cfg.ny, cfg.nz) or not np.isfinite(out).all():
            raise AssertionError(f"sharded {tag}: bad shape or non-finite")
        diffs[tag] = float(np.abs(out.astype(np.float64) - single).max())
        if not np.array_equal(out, single):
            raise AssertionError(f"sharded {tag} differs from the single-device"
                                 f" make (max {diffs[tag]})")
    short = {}
    for backend, m in (("shard_map", mesh), ("jit", None)):
        wse, T = record_heat(cfg, min(steps, JIT_SHORT_STEPS))
        short[backend] = wse.make(answer=T, options=RunOptions(
            backend=backend, mesh=m))
    short_err = float(np.abs(short["shard_map"].astype(np.float64)
                             - short["jit"]).max())
    if short_err > JIT_SHORT_ATOL:
        raise AssertionError(f"shard_map vs jit over {JIT_SHORT_STEPS} steps: "
                             f"{short_err} > {JIT_SHORT_ATOL}")
    del outs, single, short
    allocs = {tag: sharded_allocations_per_step(
        lambda n: record_heat(cfg, n), steps, tt, mesh)
        for tag, tt in (("k1", 1), ("auto", None))}
    for tag, a in allocs.items():
        if a["allocations_per_step"] != 0:
            raise AssertionError(f"the resident sharded {tag} loop "
                                 f"allocates: {a}")

    # --- timing: whole runs on device bricks, CUDA events ---------------
    timing = {}
    sh = NamedSharding(mesh)
    for tag, (tt, resident) in modes.items():
        wse, T = record_heat(cfg, steps)
        p = plan(wse.program, RunOptions(backend="pallas", time_tile=tt,
                                         resident=resident, mesh=mesh))
        wse.__exit__()
        run = sharded_runner(p)
        env = {"T_n": list(sh.shard(T.init_data).bricks)}
        ms = cuda_time_ms(lambda: run(env), repeats=3)
        timing[tag] = {"ms_per_step": ms / steps,
                       "time_tile": p.segments[0].time_tile,
                       "margin": p.layout.pad,
                       "host_us_per_step": host_us(lambda: run(env)) / steps,
                       **device_breakdown(lambda: run(env))}
        del env, run

    # --- K1 on the bricks at the main path's shapes ---------------------
    wse, T = record_heat(cfg, steps)
    ops = wse.program.ops
    wse.__exit__()
    k_auto = timing["auto"]["time_tile"]
    rows, cases = {}, []
    for dtype in ("float32", "float64"):
        env = {"T_n": T.init_data.astype(dtype)}
        for tag, k in (("k1", 1), ("sweep", k_auto)):
            kern = _brick_kernel(ops, {"T_n": T.shape}, {"T_n": dtype}, k,
                                 mesh, margin=k)
            ins, coords = _brick_inputs(kern, env, mesh)
            err = 0.0
            for b, (xs, c) in enumerate(zip(ins, coords)):
                got = launch_via_entry(kern, xs, margin_outputs(kern, xs),
                                       coords=c)
                want = fused_step_ref(kern, xs, c, out=margin_outputs(kern, xs))
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    err = max(err, (g.double() - w.double()).abs().max().item())
                    if not torch.equal(g, w):
                        raise AssertionError(f"K1 on brick {b} ({tag}, "
                                             f"{dtype}) differs from its plain "
                                             f"version (max {err})")
            cases.append({"route": tag, "k": k, "dtype": dtype,
                          "bricks": len(ins), "max_abs_err": err})
            if dtype == "float32":
                out = [margin_outputs(kern, xs) for xs in ins]

                def all_bricks(call):
                    for xs, c, o in zip(ins, coords, out):
                        call(kern, xs, c, out=o)

                b_ms, b_by = brick_bound_ms(kern, dtype)
                rows[tag] = {
                    "ms": queued_ms(lambda: all_bricks(launch_fused),
                                    repeats=10) / n_bricks,
                    "plain_ms": cuda_time_ms(
                        lambda: fused_step_ref(kern, ins[0], coords[0],
                                               out=out[0]), repeats=2),
                    "bound_ms": b_ms, "bound_by": b_by, "k": k,
                    "brick": [kern.bx, kern.by, T.shape[2]]}
                if k > 1:
                    rows[tag]["sweep_schedule_bound_ms"] = brick_bound_ms(
                        kern, dtype, schedule=True)[0]
                else:
                    # the library call on one padded brick (its halo from
                    # the exchange), the first brick's
                    lib_ms, lib_err, lib_ulp = k1_conv_library(
                        kern, ins[0], cfg.omega, coords[0], margin=True,
                        ulps=LIBRARY_ULPS)
                    rows[tag].update(library_ms=lib_ms, library_vs_k1={
                        "max_abs_err": lib_err, "ulp": lib_ulp})
                del out
            del ins
            # the sharded split launch at the same tile: the interior in
            # region mode and the four shells on every brick (wrap=False, at
            # the brick's global origin), each against its plain version and
            # the monolithic launch's cells
            err, _ = compare_region(ops, {"T_n": T.shape}, {"T_n": dtype}, k,
                                    "cuda", env, mesh=mesh)
            cases.append({"route": "region (interior) + 4 shells", "k": k,
                          "dtype": dtype, "bricks": n_bricks,
                          "max_abs_err": err})
    for tag in rows:
        rows[tag]["err"] = max(c["max_abs_err"] for c in cases
                               if c["route"] == tag)
    measured = {"k1_per_brick_ms": rows["k1"]["ms"],
                "sweep_per_brick_ms": rows["sweep"]["ms"],
                "k1_conv3d_library_brick_ms": rows["k1"]["library_ms"],
                "ms_per_step": {t: v["ms_per_step"] for t, v in timing.items()},
                "host_us_per_step": {t: v["host_us_per_step"]
                                     for t, v in timing.items()},
                "idle_share_unprofiled": {
                    t: v["device_idle_share_unprofiled"]
                    for t, v in timing.items()},
                "allocations_per_step": {t: a["allocations_per_step"]
                                         for t, a in allocs.items()}}
    emit({"phase": "sharded_make", "card": card_line(),
          "mesh": list(SHARD_MESH), "bricks_on": [str(d) for d in mesh.devices],
          "shape": [cfg.nx, cfg.ny, cfg.nz], "dtype": cfg.dtype,
          "steps": steps, "runs": runs, "fallbacks": fallbacks,
          "launches": counts, "max_abs_err_vs_single": diffs,
          "shard_map_vs_jit_short": {"steps": min(steps, JIT_SHORT_STEPS),
                                     "max_abs_err": short_err,
                                     "atol": JIT_SHORT_ATOL},
          "resident_allocations": allocs, "kernel_cases": cases,
          "timing": timing, "launch": rows,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("sharded")
                        or k == "k1_conv3d_library_brick_ms"},
          "measured": measured})
    by_mode = {"k1": {"margin": 0, "padded": 0},
               "sweep": {"margin": 0, "padded": 0}}
    for r in runs:
        by_mode["k1" if r["time_tile"] == 1 else "sweep"][
            "margin" if r["resident"] else "padded"] += r["k1_launches"]
    return {tag: dict(rows[tag], launches_by_mode=by_mode[tag])
            for tag in rows}


def phase_sharded_solve():
    """BTCS 512×512×128 on a 2×2 mesh of the card with cg, pipecg and cg +
    mg, against the single-device solves."""
    import numpy as np
    import torch

    from repro_torch.configs.heat3d import HeatConfig, make_field, record_implicit
    from repro_torch.core.mesh import make_mesh
    from repro_torch.engine import RunOptions
    from repro_torch.solver import make_sharded_solver

    cfg = HeatConfig()
    mesh = make_mesh(SHARD_MESH)
    T0 = make_field(cfg)
    b = T0.astype(np.float64)
    b[1:-1, 1:-1, 1:-1] *= 1.0 / (1.0 + 6.0 * cfg.omega)
    norm_b = float(np.linalg.norm(b))
    tol = SOLVE_REL_TOL * norm_b
    x0 = torch.tensor(T0, device="cuda")
    runs, total = [], dict.fromkeys(read_counts(), 0)
    levels = {}
    for method, pc in (("cg", None), ("pipecg", None), ("cg", "mg")):
        key = method + ("+mg" if pc else "")
        wse, T = record_implicit(cfg)
        x1, info1 = wse.solve(T, method=method, precondition=pc, tol=tol,
                              maxiter=cfg.maxiter,
                              options=RunOptions(backend="pallas"),
                              return_info=True)
        # --- the main path: counters to 0 just before, read just after ---
        reset_counts()
        wse, T = record_implicit(cfg)
        x, info = wse.solve(T, method=method, precondition=pc, tol=tol,
                            maxiter=cfg.maxiter,
                            options=RunOptions(backend="pallas", mesh=mesh),
                            return_info=True)
        counts = read_counts()
        counts["by_level"] = level_counts()
        # ------------------------------------------------------------------
        outcome = str(info.outcomes[0])
        iters, iters1 = int(info.iterations[0]), int(info1.iterations[0])
        rel = btcs_relative_residual(x, T0, cfg.omega)
        err = float(np.abs(x.astype(np.float64) - x1).max())
        wse, T = record_implicit(cfg)
        prog = wse.program
        wse.__exit__()
        step, _ = make_sharded_solver(prog, "T", mesh, method=method,
                                      precondition=pc, backend="pallas",
                                      tol=tol, maxiter=cfg.maxiter)
        timing = time_solve(step, x0, iters)
        need = {"K1", "K1k1", "K1br"} | (
            {"K2"} if method == "pipecg" or pc else set()) | (
            {"K3", "K4"} if pc else set())
        runs.append({"method": method, "precondition": pc, "outcome": outcome,
                     "iterations": iters, "single_iterations": iters1,
                     "residual_reported": float(info.residual[0]),
                     "independent_f64_relative_residual": rel,
                     "vs_single_max_abs_err": err,
                     "vs_single_atol": SHARD_SOLVE_ATOL[key],
                     "launches": counts, **timing})
        if outcome != "CONVERGED":
            raise AssertionError(f"sharded solve {key} ended {outcome}")
        if not np.isfinite(x).all() or x.shape != T0.shape:
            raise AssertionError(f"sharded solve {key}: bad shape or "
                                 "non-finite")
        if rel > SOLVE_REL_TOL:
            raise AssertionError(f"sharded solve {key}: independent residual "
                                 f"{rel} > {SOLVE_REL_TOL}")
        if err > SHARD_SOLVE_ATOL[key]:
            raise AssertionError(f"sharded solve {key}: {err} from the "
                                 f"single-device solve > "
                                 f"{SHARD_SOLVE_ATOL[key]}")
        if pc and abs(iters - iters1) > 1:
            raise AssertionError(f"sharded solve {key}: {iters} iterations, "
                                 f"{iters1} on one device")
        # the operator on the bricks; cg + mg adds the gathered hierarchy's
        # single-device launches (every one through the k = 1 entry)
        if (counts["K1k1"] != counts["K1"] or counts["K1br"] == 0
                or counts["K1br"] % mesh.size
                or (pc is None and counts["K1br"] != counts["K1"])):
            raise AssertionError(f"sharded solve {key}: K1 launches {counts}")
        missing = [k for k in sorted(need) if counts[k] == 0]
        if missing:
            raise AssertionError(f"sharded solve {key}: {missing} never "
                                 "launched")
        for k in total:
            total[k] += counts[k]
        add_levels(levels, counts["by_level"])
    total["by_level"] = levels
    emit({"phase": "sharded_solve", "card": card_line(),
          "mesh": list(SHARD_MESH), "shape": [cfg.nx, cfg.ny, cfg.nz],
          "dtype": cfg.dtype, "norm_b": norm_b, "tol": tol,
          "tol_relative": SOLVE_REL_TOL, "runs": runs, "launches": total,
          "predicted": PREDICTED["sharded_solve_ms"],
          "measured_ms_per_solve": {
              r["method"] + ("+mg" if r["precondition"] else ""):
              r["ms_per_solve"] for r in runs}})
    return total


# ---------------------------------------------------------------------------
# slice 13: the exchange/compute overlap
# ---------------------------------------------------------------------------

def stream_overlap(fn) -> dict:
    """Whether the copies of one ``fn()`` that ran on another stream than
    K1's were concurrent with a K1 launch on the card: the profiler's
    device events (chrome trace, each with its stream), the side streams'
    kernels and copies, their device µs, and the µs of them that fall
    inside a K1 launch's interval."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset") and "stream" in e.get("args", {})]
    k1 = [e for e in dev if "fused_column_kernel" in e["name"]]
    if not k1:
        return {"device_events": len(dev), "k1_events": 0, "concurrent": None}
    main = {e["args"]["stream"] for e in k1}
    side = [e for e in dev if e["args"]["stream"] not in main]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in k1)
    inside = 0.0
    for e in side:
        a, b = e["ts"], e["ts"] + e["dur"]
        inside += sum(max(0.0, min(b, hi) - max(a, lo)) for lo, hi in spans)
    return {"device_events": len(dev), "k1_events": len(k1),
            "k1_streams": sorted(main),
            "side_streams": sorted({e["args"]["stream"] for e in side}),
            "side_events": len(side),
            "side_busy_us": sum(e["dur"] for e in side),
            "side_us_inside_k1": inside, "concurrent": inside > 0}


def phase_overlap_make(steps: int, seed: int, heat):
    """``HeatConfig()`` through ``make(overlap=True)`` on one device and on
    the 2×2 mesh at k = 1 and the auto tile, and 8 members at k = 1: each
    run bitwise its ``overlap=False`` run, every launch split (one region
    launch and four shells per brick), ``overlap="auto"`` unsplit; ms and
    host µs per step, idle share and allocations per split step beside the
    monolithic step's, whether the slab copies ran beside the interior
    launch; the interior's and the shells' launch times (queued) beside
    their bounds and ``PREDICTED``."""
    import numpy as np
    import torch

    import repro_torch as rt
    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig, record_heat
    from repro_torch.core.mesh import NamedSharding, make_mesh
    from repro_torch.engine import (RunOptions, plan, reset_stats,
                                    sharded_runner, single_runner, stats)
    from repro_torch.kernels.fused import fused_step_ref, launch_fused

    cfg = HeatConfig()
    mesh = make_mesh(SHARD_MESH)
    B = ENSEMBLE_MAKE_MEMBERS
    members = heat_members(cfg, B, seed)
    #: tag -> (mesh, time_tile, members)
    cells = {"one_k1": (None, 1, None), "one_auto": (None, None, None),
             "mesh_k1": (mesh, 1, None), "mesh_auto": (mesh, None, None),
             "members_k1": (None, 1, members)}

    def make(tag, overlap):
        m, tt, stack = cells[tag]
        opts = RunOptions(backend="pallas", time_tile=tt, mesh=m,
                          overlap=overlap)
        wse, T = record_heat(cfg, steps)
        if stack is None:
            return wse.make(answer=T, options=opts)
        return rt.Ensemble(wse.program, T, overrides={"T_n": stack}).make(
            options=opts)

    # --- the main path: counters to 0 just before, read just after -------
    compiler.reset_stats()
    reset_counts()
    outs, runs = {}, []
    for tag, (m, tt, stack) in cells.items():
        reset_stats()
        before = read_counts()
        outs[tag] = make(tag, True)
        after = read_counts()
        runs.append({"run": tag, "time_tile": stats.max_time_tile,
                     "bricks": m.size if m else 1,
                     "members": 1 if stack is None else len(stack),
                     "engine_launches": stats.launches,
                     "interior_launches": stats.interior_launches,
                     "boundary_launches": stats.boundary_launches,
                     "overlapped_exchanges": stats.overlapped_exchanges,
                     **{k: after[k] - before[k] for k in (
                         "K1", "K1m", "K1k1", "K1sw", "K1sub", "K1b",
                         "K1br", "K1rg")}})
    counts = read_counts()
    fallbacks = compiler.stats.fallbacks
    # -----------------------------------------------------------------------
    if fallbacks:
        raise AssertionError(f"{fallbacks} interpreter fallbacks on the "
                             "overlap path")
    for r in runs:
        n, nb = r["engine_launches"], r["bricks"]
        if (n == 0 or r["interior_launches"] != n
                or r["boundary_launches"] != 4 * n
                or r["overlapped_exchanges"] != n):
            raise AssertionError(f"overlap {r['run']}: the engine's split "
                                 f"counts {r}")
        if r["K1rg"] != nb * n or r["K1"] != 5 * nb * n or r["K1m"] != nb * n:
            raise AssertionError(f"overlap {r['run']}: K1 launches {r} are not "
                                 f"one region + four shells per brick launch")
        route = "K1k1" if r["time_tile"] == 1 else "K1sw"
        if r[route] != r["K1"]:
            raise AssertionError(f"overlap {r['run']}: {r[route]} of {r['K1']} "
                                 f"launches through {route}")
        if r["K1br"] != (r["K1"] if nb > 1 else 0) or r["K1b"] != (
                r["K1"] if r["members"] > 1 else 0):
            raise AssertionError(f"overlap {r['run']}: brick/member launches "
                                 f"{r}")
    diffs, auto_split = {}, {}
    for tag, (m, tt, stack) in cells.items():
        mono = make(tag, False)
        out = outs[tag]
        want_shape = (cfg.nx, cfg.ny, cfg.nz) if stack is None else stack.shape
        if out.shape != want_shape or not np.isfinite(out).all():
            raise AssertionError(f"overlap {tag}: bad shape or non-finite")
        diffs[tag] = float(np.abs(out.astype(np.float64) - mono).max())
        if not np.array_equal(out, mono):
            raise AssertionError(f"overlap {tag} differs from its monolithic "
                                 f"run (max {diffs[tag]})")
        wse, T = record_heat(cfg, steps)
        p = plan(wse.program, RunOptions(
            backend="pallas", time_tile=tt, mesh=m, overlap="auto",
            batch=1 if stack is None else len(stack)))
        wse.__exit__()
        auto_split[tag] = [seg.split for seg in p.segments]
        if any(auto_split[tag]):
            raise AssertionError(f"overlap='auto' split {tag}: {auto_split}")
    del outs, mono, out

    allocs = {}
    for tag, (m, tt, stack) in cells.items():
        if stack is not None:
            continue
        if m is None:
            allocs[tag] = allocations_per_step(
                lambda n: record_heat(cfg, n), steps, tt, overlap=True)
        else:
            allocs[tag] = sharded_allocations_per_step(
                lambda n: record_heat(cfg, n), steps, tt, m, overlap=True)
        if allocs[tag]["allocations_per_step"] != 0:
            raise AssertionError(f"the split {tag} loop allocates: "
                                 f"{allocs[tag]}")

    # --- timing: split and monolithic, whole runs on device tensors ------
    timing, concurrency = {}, {}
    for tag, (m, tt, stack) in cells.items():
        for ov in (True, False):
            wse, T = record_heat(cfg, steps)
            p = plan(wse.program, RunOptions(
                backend="pallas", time_tile=tt, mesh=m, overlap=ov,
                batch=1 if stack is None else len(stack)))
            wse.__exit__()
            init = T.init_data if stack is None else stack
            if m is None:
                run = single_runner(p)
                env = {"T_n": torch.tensor(init, device="cuda")}
            else:
                run = sharded_runner(p)
                env = {"T_n": list(NamedSharding(m).shard(init).bricks)}
            ms = cuda_time_ms(lambda: run(env), repeats=3)
            key = tag + ("" if ov else "_monolithic")
            timing[key] = {"ms_per_step": ms / steps,
                           "time_tile": p.segments[0].time_tile,
                           "split": p.segments[0].split,
                           "host_us_per_step": host_us(lambda: run(env)) / steps,
                           **device_breakdown(lambda: run(env))}
            if ov and stack is None:
                concurrency[tag] = stream_overlap(lambda: run(env))
            del env, run

    # --- the split's launches at the main path's shape, float32 ---------
    rows = {}
    for k, handles in heat["region"].items():
        kern, ins, out = handles["interior"]
        b_ms, b_by = brick_bound_ms(kern, cfg.dtype)
        row = {"k": k, "region": [kern.span[0], kern.span[1], cfg.nz],
               "ms": cuda_time_ms(lambda: launch_fused(kern, ins, out=out),
                                  repeats=20),
               "plain_ms": cuda_time_ms(
                   lambda: fused_step_ref(kern, ins, (kern.origin,) * 2,
                                          out=out), repeats=2),
               "bound_ms": b_ms, "bound_by": b_by}
        if k > 1:
            row["sweep_schedule_bound_ms"] = brick_bound_ms(
                kern, cfg.dtype, schedule=True)[0]
        shells = []
        for sk, wins, coords in handles["shells"]:
            held = launch_fused(sk, wins, coords)
            s_ms, s_by = brick_bound_ms(sk, cfg.dtype)
            shells.append({
                "extent": [sk.bx, sk.by, cfg.nz],
                "ms": queued_ms(lambda: launch_fused(sk, wins, coords,
                                                     out=held), repeats=50),
                "plain_ms": cuda_time_ms(
                    lambda: fused_step_ref(sk, wins, coords, out=held),
                    repeats=5),
                "bound_ms": s_ms, "bound_by": s_by})
        row["shells"] = shells
        rows[k] = row
    k_auto = max(rows)
    measured = {
        "interior_ms": {k: r["ms"] for k, r in rows.items()},
        "shell_ms": {k: [s["ms"] for s in r["shells"]] for k, r in rows.items()},
        "ms_per_step": {t: v["ms_per_step"] for t, v in timing.items()},
        "host_us_per_step": {t: v["host_us_per_step"]
                             for t, v in timing.items()},
        "idle_share_unprofiled": {t: v["device_idle_share_unprofiled"]
                                  for t, v in timing.items()},
        "allocations_per_step": {t: a["allocations_per_step"]
                                 for t, a in allocs.items()},
        "slab_copies_concurrent_with_k1": {t: c["concurrent"]
                                           for t, c in concurrency.items()}}
    emit({"phase": "overlap_make", "card": card_line(),
          "mesh": list(SHARD_MESH), "shape": [cfg.nx, cfg.ny, cfg.nz],
          "dtype": cfg.dtype, "steps": steps, "members": B, "runs": runs,
          "fallbacks": fallbacks, "launches": counts,
          "max_abs_err_vs_monolithic": diffs, "auto_split": auto_split,
          "split_allocations": allocs, "timing": timing,
          "stream_overlap": concurrency, "launch": rows,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("overlap")},
          "measured": measured})
    launches = {"region": {1: 0, k_auto: 0}, "shell": {1: 0, k_auto: 0}}
    for r in runs:
        launches["region"][r["time_tile"]] += r["K1rg"]
        launches["shell"][r["time_tile"]] += r["K1"] - r["K1rg"]
    err = heat["region_err"]
    one, auto = rows[1], rows[k_auto]
    region = {"launches": sum(launches["region"].values()),
              "launches_by_tile": launches["region"], "err": err,
              "ms": one["ms"], "plain_ms": one["plain_ms"],
              "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
              "region": one["region"], "sweep_ms": auto["ms"],
              "sweep_schedule_bound_ms": auto["sweep_schedule_bound_ms"]}
    # the shells' row: the mean of the four k = 1 shells
    sh = one["shells"]
    shell = {"launches": sum(launches["shell"].values()),
             "launches_by_tile": launches["shell"], "err": err,
             "ms": sum(s["ms"] for s in sh) / len(sh),
             "plain_ms": sum(s["plain_ms"] for s in sh) / len(sh),
             "bound_ms": sum(s["bound_ms"] for s in sh) / len(sh),
             "bound_by": sh[0]["bound_by"],
             "extents": [s["extent"] for s in sh]}
    return region, shell


# ---------------------------------------------------------------------------
# slice 14: numerical health and reverse-mode differentiation
# ---------------------------------------------------------------------------

#: the device the health, adjoint and service phases run on (the card)
DEV = "cuda"
#: the explicit sentinel's granule of the ``health_make`` phase
HEALTH_EVERY = 64
#: the guarded run's overhead budget on one device at k = 1
#: (``benchmarks/health_overhead.py``'s documented gate)
HEALTH_BUDGET = 0.02
#: the budget's steady state, as ``benchmarks/health_overhead.py`` defines
#: it: runs of this many steps, guarded and unguarded in shuffled turns
#: for this many rounds, each run read back as its caller would, and the
#: floor (mean of the fastest half) of each side compared
HEALTH_BUDGET_STEPS = 2048
HEALTH_BUDGET_ROUNDS = 8
#: the differentiable make's steps: all-residuals keeps one 134 MB input a
#: launch at k = 1 (64 × 134 MB ≈ 8.6 GB); the 2×2 mesh's run
ADJOINT_MAKE_STEPS = 64
ADJOINT_MESH_STEPS = 16


def chunk_ends(p, every: int):
    """The steps after which a guarded run of plan ``p`` probes (the
    reference's chunking: per segment, full chunks of ``ceil(every / k)``
    launches, then the tail, and the same for the ``n % k`` remainder)."""
    ends, step = [], 0
    for seg in p.segments:
        N, k = (seg.loop.n, seg.time_tile) if seg.loop else (1, 1)
        parts = ((N // k, k), (N % k, 1)) if k > 1 else ((N, 1),)
        for launches, per_launch in parts:
            if launches <= 0:
                continue
            per = min(max(1, -(-every // per_launch)), launches)
            full, tail = divmod(launches, per)
            for size in [per] * full + ([tail] if tail else []):
                step += size * per_launch
                ends.append(step)
    return ends


def expected_probes(p, every: int) -> int:
    """The probes of a guarded run of plan ``p``: the entry's and one at
    each chunk end."""
    return 1 + len(chunk_ends(p, every))


def k1_rows(delta, *, bricks: int = 1, members: int = 1):
    """One run's launches (``read_counts`` deltas) by the ``kernels`` row
    they add to: K1's k = 1 entry (padded or margin mode: a run's launches
    are all of one mode) and sweep, on members or bricks, and K2–K4."""
    if members > 1:
        keys = ("members_k1", "members_sweep")
    elif bricks > 1:
        keys = ("bricks_k1", "bricks_sweep")
    elif delta["K1m"] not in (0, delta["K1"]):
        raise AssertionError(f"a run of both K1 modes: {delta}")
    else:
        keys = ("k1_margin" if delta["K1m"] else "k1_padded", "sweep")
    return {keys[0]: delta["K1k1"], keys[1]: delta["K1sw"],
            **{k: delta[k] for k in ("K2", "K3", "K4")}}


def add_rows(total: dict, rows: dict) -> dict:
    for k, v in rows.items():
        total[k] = total.get(k, 0) + v
    return total


def counts_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def growth_program(cfg, steps, init):
    """The reference tests' growth body ``T ← 4·T`` (tests/test_health.py)
    at ``cfg``'s grid: halo-free, exact, overflowing where ``init`` is
    large."""
    import repro_torch as rt

    wse = rt.WFAInterface()
    T = rt.Field("T", init_data=init)
    with rt.ForLoop("t", steps):
        T[:, 0, 0] = 4.0 * T[:, 0, 0]
    return wse, T


def growth_init(cfg, overflow_step: int):
    """Every cell 1e-37 (finite for 125 steps of ``4·T``), one interior
    cell 3e38 / 4^(overflow_step − 1): it overflows at ``overflow_step``."""
    import numpy as np

    init = np.full((cfg.nx, cfg.ny, cfg.nz), 1.0e-37, np.float32)
    init[cfg.nx // 3, cfg.ny // 2, cfg.nz // 2] = np.float32(
        3.0e38 / 4.0 ** (overflow_step - 1))
    return init


def health_budget(cfg, seed: int) -> dict:
    """The guarded run's steady-state overhead on one device at k = 1, as
    ``benchmarks/health_overhead.py`` measures its 2 % budget:
    ``HEALTH_BUDGET_STEPS``-step runs of ``HeatConfig()``, unguarded and
    guarded (``check_finite=HEALTH_EVERY``) in a shuffled order each round,
    each run timed by CUDA events from an idle card to its read-back (the
    guarded run reads its last verdict; the unguarded one is synchronised),
    and the floor (mean of the fastest half of the rounds) of each side
    compared.  The two runs' results are checked bitwise, and the guarded
    run's probes against the reference's chunking."""
    import random
    import statistics

    import torch

    from repro_torch.configs.heat3d import make_field, record_heat
    from repro_torch.engine import (RunOptions, guarded_runner, plan,
                                    single_runner, stats)

    steps = HEALTH_BUDGET_STEPS
    wse, _ = record_heat(cfg, steps)
    p = plan(wse.program, RunOptions(backend="pallas", time_tile=1,
                                     device=DEV))
    wse.__exit__()
    env = {"T_n": torch.tensor(make_field(cfg), device=DEV)}
    runners = {"unguarded": single_runner(p),
               "guarded": guarded_runner(p, HEALTH_EVERY)}
    probes = stats.health_probes
    outs = {kind: run(env)["T_n"] for kind, run in runners.items()}
    probes = stats.health_probes - probes
    if not torch.equal(outs["guarded"], outs["unguarded"]):
        raise AssertionError("health_budget: the guarded run differs from "
                             "the unguarded run")
    if probes != expected_probes(p, HEALTH_EVERY):
        raise AssertionError(f"health_budget: {probes} probes, expected "
                             f"{expected_probes(p, HEALTH_EVERY)}")
    del outs
    ms = {kind: [] for kind in runners}
    order = list(runners)
    rng = random.Random(seed)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(HEALTH_BUDGET_ROUNDS):
        rng.shuffle(order)
        for kind in order:
            torch.cuda.synchronize()
            start.record()
            runners[kind](env)
            end.record()
            end.synchronize()
            ms[kind].append(start.elapsed_time(end) / steps)
    half = HEALTH_BUDGET_ROUNDS // 2
    floor = {kind: statistics.mean(sorted(v)[:half]) for kind, v in ms.items()}
    return {"steps": steps, "rounds": HEALTH_BUDGET_ROUNDS,
            "probes_per_run": probes, "ms_per_step": ms,
            "floor_ms_per_step": floor,
            "overhead": floor["guarded"] / floor["unguarded"] - 1.0}


def phase_health_make(steps: int, seed: int):
    """``HeatConfig()`` through ``make(check_finite=64)``, resident, at k = 1
    and the auto tile, on one device and the 2×2 mesh, and with 8 members
    at k = 1: each run bitwise its unguarded run, with the reference's
    probe count; guarded and unguarded ms/step (CUDA events), host µs/step
    and idle share; the one-device k = 1 overhead in the steady state
    (:func:`health_budget`) held to ``HEALTH_BUDGET``; then ``T ← 4·T`` with one cell overflowing at step
    100 on one device and on the mesh: ``NumericalFault`` at the
    reference's step, ``last_good`` bitwise the unguarded run at its good
    step; the de-escalated retry from ``time_tile=4``."""
    t_phase = time.perf_counter()
    import warnings

    import numpy as np
    import torch

    import repro_torch as rt
    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig, make_field, record_heat
    from repro_torch.core.mesh import NamedSharding, make_mesh
    from repro_torch.engine import (RunOptions, guarded_runner, plan,
                                    reset_stats, sharded_runner,
                                    single_runner, stats)
    from repro_torch.solver import NumericalFault, RecoveryPolicy

    cfg = HeatConfig()
    N = HEALTH_EVERY
    mesh = make_mesh(SHARD_MESH, device=DEV)
    B = ENSEMBLE_MAKE_MEMBERS
    members = heat_members(cfg, B, seed)
    cells = {"one_k1": (None, 1, None), "one_auto": (None, None, None),
             "mesh_k1": (mesh, 1, None), "mesh_auto": (mesh, None, None),
             "members_k1": (None, 1, members)}

    def options(tag, check):
        m, tt, stack = cells[tag]
        return RunOptions(backend="pallas", time_tile=tt, mesh=m,
                          check_finite=check, device=DEV,
                          batch=1 if stack is None else len(stack))

    def make(tag, check):
        m, tt, stack = cells[tag]
        wse, T = record_heat(cfg, steps)
        opts = options(tag, check)
        if stack is None:
            return wse.make(answer=T, options=opts)
        return rt.Ensemble(wse.program, T, overrides={"T_n": stack}).make(
            options=opts.replace(batch=1))

    def planned(tag, check=0):
        wse, _ = record_heat(cfg, steps)
        p = plan(wse.program, options(tag, check))
        wse.__exit__()
        return p

    # --- the main path: counters to 0 just before, read just after -------
    compiler.reset_stats()
    reset_counts()
    outs, runs, by_row = {}, [], {}
    for tag, (m, tt, stack) in cells.items():
        reset_stats()
        before = read_counts()
        outs[tag] = make(tag, N)
        delta = counts_delta(before, read_counts())
        bricks = m.size if m else 1
        runs.append({"run": tag, "time_tile": stats.max_time_tile,
                     "bricks": bricks,
                     "members": 1 if stack is None else len(stack),
                     "engine_launches": stats.launches,
                     "health_probes": stats.health_probes,
                     "expected_probes": expected_probes(planned(tag), N),
                     "numerical_faults": stats.numerical_faults,
                     "K1": delta["K1"], "K1m": delta["K1m"]})
        add_rows(by_row, k1_rows(delta, bricks=bricks,
                                 members=1 if stack is None else len(stack)))
    counts = read_counts()
    fallbacks = compiler.stats.fallbacks
    # -----------------------------------------------------------------------
    if fallbacks:
        raise AssertionError(f"{fallbacks} interpreter fallbacks on the "
                             "guarded path")
    for r in runs:
        if r["health_probes"] != r["expected_probes"] or r["numerical_faults"]:
            raise AssertionError(f"health_make {r['run']}: probes {r}")
        if (r["K1"] != r["bricks"] * r["engine_launches"] or r["K1"] == 0
                or r["K1m"] != r["K1"]):
            raise AssertionError(f"health_make {r['run']}: K1 launches {r} "
                                 "are not one margin launch per brick launch")
    diffs = {}
    for tag, (m, tt, stack) in cells.items():
        want = make(tag, 0)
        out = outs[tag]
        if out.shape != want.shape or not np.isfinite(out).all():
            raise AssertionError(f"health_make {tag}: bad shape or non-finite")
        diffs[tag] = float(np.abs(out.astype(np.float64) - want).max())
        if not np.array_equal(out, want):
            raise AssertionError(f"guarded {tag} differs from its unguarded "
                                 f"run (max {diffs[tag]})")
    del outs

    # --- timing: guarded and unguarded, whole runs on device tensors -----
    timing = {}
    for tag, (m, tt, stack) in cells.items():
        init = make_field(cfg) if stack is None else stack
        if m is None:
            env = {"T_n": torch.tensor(init, device=DEV)}
        else:
            env = {"T_n": list(NamedSharding(m).shard(init).bricks)}
        p = planned(tag)
        runners = {"guarded": guarded_runner(p, N),
                   "unguarded": single_runner(p) if m is None
                   else sharded_runner(p)}
        ms = {"guarded": [], "unguarded": []}
        for kind in ("unguarded", "guarded", "guarded", "unguarded"):
            ms[kind].append(cuda_time_ms(lambda: runners[kind](env),
                                         repeats=5) / steps)
        row = {"time_tile": p.segments[0].time_tile}
        for kind, run in runners.items():
            row[kind] = {"ms_per_step": ms[kind],
                         "host_us_per_step": host_us(lambda: run(env)) / steps,
                         **device_breakdown(lambda: run(env))}
        g, u = sum(ms["guarded"]) / 2, sum(ms["unguarded"]) / 2
        row["overhead"] = g / u - 1.0
        timing[tag] = row
        del env, runners

    # --- a poisoned run: T <- 4·T, one cell overflowing at step 100 ------
    faults = []
    init = growth_init(cfg, 100)
    for tag, m in (("one", None), ("mesh", mesh)):
        opts = RunOptions(backend="pallas", check_finite=N, mesh=m, device=DEV)
        wse, T = growth_program(cfg, steps, init)
        p = plan(wse.program, opts)
        ends = chunk_ends(p, N)
        want_step = next(e for e in ends if e >= 100)
        want_good = max([e for e in ends if e < 100], default=0)
        reset_stats()
        before = read_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            try:
                wse.make(answer=T, options=opts)
            except NumericalFault as e:
                fault = e
            else:
                raise AssertionError(f"health_make: the poisoned {tag} run "
                                     "did not fault")
            finally:
                wse.__exit__()
        delta = counts_delta(before, read_counts())
        add_rows(by_row, k1_rows(delta, bricks=m.size if m else 1))
        good = int(str(fault).split("last finite probe at step ")[1]
                   .rstrip(")"))
        w2, T2 = growth_program(cfg, good, init)
        want = w2.make(answer=T2, options=opts.replace(check_finite=0))
        same = np.array_equal(fault.last_good["T"], want)
        faults.append({"run": tag, "step": fault.step, "good_step": good,
                       "expected_step": want_step, "expected_good": want_good,
                       "chunk_ends": ends, "outcome": fault.outcome,
                       "numerical_faults": stats.numerical_faults,
                       "last_good_bitwise": same, "launches": delta})
        if (fault.step, good) != (want_step, want_good) or not same:
            raise AssertionError(f"health_make: the poisoned {tag} run "
                                 f"{faults[-1]}")
    # --- the de-escalated retry from time_tile=4 -------------------------
    opts = RunOptions(backend="pallas", check_finite=N, time_tile=4,
                      recovery=RecoveryPolicy(), device=DEV)
    wse, T = growth_program(cfg, steps, init)
    reset_stats()
    before = read_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        try:
            wse.make(answer=T, options=opts)
        except NumericalFault as e:
            retry_step = e.step
        else:
            raise AssertionError("health_make: the retry did not fault")
        finally:
            wse.__exit__()
    delta = counts_delta(before, read_counts())
    add_rows(by_row, k1_rows(delta))
    retry = {"recovery_attempts": stats.recovery_attempts,
             "numerical_faults": stats.numerical_faults, "step": retry_step,
             "launches": delta}
    if (retry["recovery_attempts"], retry["numerical_faults"]) != (1, 2):
        raise AssertionError(f"health_make: the retry {retry}")

    budget = health_budget(cfg, seed)

    measured = {
        "budget_overhead": budget["overhead"],
        "overhead": {t: v["overhead"] for t, v in timing.items()},
        "ms_per_step": {t: {k: sum(v[k]["ms_per_step"]) / 2
                            for k in ("guarded", "unguarded")}
                        for t, v in timing.items()},
        "host_us_per_step": {t: {k: v[k]["host_us_per_step"]
                                 for k in ("guarded", "unguarded")}
                             for t, v in timing.items()},
        "idle_share_unprofiled": {
            t: {k: v[k]["device_idle_share_unprofiled"]
                for k in ("guarded", "unguarded")} for t, v in timing.items()},
        "probes": {r["run"]: r["health_probes"] for r in runs}}
    emit({"phase": "health_make", "card": card_line(),
          "seconds": time.perf_counter() - t_phase,
          "shape": [cfg.nx, cfg.ny, cfg.nz], "dtype": cfg.dtype,
          "steps": steps, "check_finite": N, "members": B,
          "mesh": list(SHARD_MESH), "runs": runs, "fallbacks": fallbacks,
          "launches": counts, "max_abs_err_vs_unguarded": diffs,
          "timing": timing, "budget": HEALTH_BUDGET,
          "budget_run": budget, "faults": faults,
          "retry": retry,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("health")},
          "measured": measured})
    if budget["overhead"] > HEALTH_BUDGET:
        raise AssertionError(f"the guarded k = 1 run costs "
                             f"{budget['overhead']:.2%} > {HEALTH_BUDGET:.0%} "
                             "over the unguarded run in the steady state")
    return by_row


def antisymmetric_program(shape, dtype, F):
    """``A x = x[x+1] − x[x−1]`` (no centre tap): an antisymmetric stencil,
    so ``⟨r, A r⟩ = 0`` for every interior-supported ``r`` — the 90°
    rotation of the reference's BiCGSTAB breakdown test on a grid.  The
    right-hand side is ``F`` (small integers: every dot is exact)."""
    from repro_torch.core.field import Field
    from repro_torch.core.program import scoped_program
    from repro_torch.solver.frontend import Operator, Rhs

    with scoped_program() as prog:
        T = Field("T", shape=shape, dtype=dtype)
        Ff = Field("F", init_data=F, dtype=dtype)
        with Operator():
            T[1:-1, 0, 0] = T[1:-1, 1, 0] - T[1:-1, -1, 0]
        with Rhs():
            T[1:-1, 0, 0] = Ff[1:-1, 0, 0]
    return prog


def phase_health_solve(seed: int):
    """BTCS at ``HeatConfig()`` width, ``tol = 1e-5·‖b‖``: a NaN in the
    right-hand side labels every method ``NAN_RESIDUAL``; a healthy solve
    with ``RecoveryPolicy()`` is bitwise the solve without it and never
    enters the ladder; 4 members with one poisoned leave the other three
    bitwise unperturbed; then the ladder's deterministic constructions at
    the reference tests' sizes on the card — BiCGSTAB's breakdown on a
    rotation (restart, then the float64 rung) and CG's (escalation), and
    the float32 overflow that converges on the float64 rung — each rung
    against its ``RecoveryTrace``."""
    t_phase = time.perf_counter()
    import warnings

    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig, make_field
    from repro_torch.engine import RunOptions, reset_stats, stats
    from repro_torch.solver import (NumericalFault, RecoveryPolicy, health,
                                    krylov, record_btcs)
    from repro_torch.solver.api import solve

    cfg = HeatConfig()
    T0 = make_field(cfg)
    b = T0.astype(np.float64)
    b[1:-1, 1:-1, 1:-1] *= 1.0 / (1.0 + 6.0 * cfg.omega)
    tol = SOLVE_REL_TOL * float(np.linalg.norm(b))
    poisoned = T0.copy()
    poisoned[cfg.nx // 2, cfg.ny // 3, cfg.nz // 2] = np.nan
    opts = RunOptions(backend="pallas", device=DEV)

    # --- the main path: counters to 0 just before, read just after -------
    compiler.reset_stats()
    reset_counts()
    by_row, labeled = {}, []
    for method in ("cg", "pipecg", "bicgstab", "chebyshev", "jacobi"):
        wse, T = record_btcs(poisoned, cfg.omega)
        before = read_counts()
        x, info = solve(wse.program, T, method=method, tol=tol, maxiter=60,
                        return_info=True, options=opts)
        add_rows(by_row, k1_rows(counts_delta(before, read_counts())))
        labeled.append({"method": method, "outcomes": list(info.outcomes),
                        "iterations": info.iterations.tolist(),
                        "finite": bool(np.isfinite(x).all())})
        if list(info.outcomes) != ["NAN_RESIDUAL"] or labeled[-1]["finite"]:
            raise AssertionError(f"health_solve: poisoned {labeled[-1]}")
    healthy = []
    for method in ("cg", "pipecg"):
        xs = []
        for rec in (None, RecoveryPolicy()):
            wse, T = record_btcs(T0, cfg.omega)
            reset_stats()
            before = read_counts()
            x, info = solve(wse.program, T, method=method, tol=tol,
                            maxiter=cfg.maxiter, return_info=True,
                            options=opts.replace(recovery=rec))
            add_rows(by_row, k1_rows(counts_delta(before, read_counts())))
            xs.append(x)
            entered = info.recovery is not None or stats.recovery_attempts
            if list(info.outcomes) != ["CONVERGED"] or entered:
                raise AssertionError(f"health_solve: healthy {method} "
                                     f"{list(info.outcomes)}, ladder {entered}")
        healthy.append({"method": method, "bitwise": np.array_equal(*xs)})
        if not healthy[-1]["bitwise"]:
            raise AssertionError(f"health_solve: {method} with a recovery "
                                 "policy differs from the plain solve")
    B = ENSEMBLE_SOLVE_MEMBERS
    stack = np.broadcast_to(T0, (B,) + T0.shape).copy()
    sick = stack.copy()
    sick[2, cfg.nx // 2, cfg.ny // 3, cfg.nz // 2] = np.nan
    member_x = {}
    for key, st in (("sick", sick), ("healthy", stack)):
        wse, T = record_btcs(T0, cfg.omega)
        before = read_counts()
        member_x[key], info = solve(
            wse.program, T, method="cg", tol=tol, maxiter=cfg.maxiter,
            return_info=True, member_env={"T": st},
            options=opts.replace(batch=B))
        add_rows(by_row, k1_rows(counts_delta(before, read_counts()),
                                 members=B))
        if key == "sick":
            member_outcomes = np.asarray(info.outcomes).ravel().tolist()
    unperturbed = [bool(np.array_equal(member_x["sick"][i],
                                       member_x["healthy"][i]))
                   for i in range(B) if i != 2]
    if (member_outcomes != ["CONVERGED", "CONVERGED", "NAN_RESIDUAL",
                            "CONVERGED"] or not all(unperturbed)):
        raise AssertionError(f"health_solve: members {member_outcomes}, "
                             f"unperturbed {unperturbed}")
    del member_x, stack, sick
    counts = read_counts()
    fallbacks = compiler.stats.fallbacks
    # -----------------------------------------------------------------------
    if fallbacks:
        raise AssertionError(f"{fallbacks} interpreter fallbacks in the "
                             "health solves")

    # --- the ladder's deterministic constructions (reference sizes) ------
    ladder = {}
    A = torch.tensor([[0.0, -1.0], [1.0, 0.0]], device=DEV)
    _, it, _, st = krylov.bicgstab(
        lambda v: A @ v, lambda a, c: torch.sum(a * c), torch.tensor(
            [1.0, 0.0], device=DEV), torch.zeros(2, device=DEV),
        tol=1e-10, maxiter=50)
    ladder["rotation_2x2"] = {"outcome": health.outcome_name(int(st)),
                              "iterations": int(it)}
    if ladder["rotation_2x2"]["outcome"] != "BREAKDOWN" or it > 2:
        raise AssertionError(f"health_solve: {ladder['rotation_2x2']}")
    F = np.random.default_rng(seed).integers(-2, 3, (10, 10, 6)).astype(
        np.float32)
    F[[0, -1]] = 0.0
    F[:, [0, -1]] = 0.0
    expect = {
        # the breakdown's huge α overflows the float32 update to NaN, so
        # the restart from that iterate is NaN at entry; float64 holds the
        # same α and breaks down again
        "bicgstab": (["initial", "restart 1 after BREAKDOWN",
                      "fp64 safe mode after NAN_RESIDUAL"],
                     ["BREAKDOWN", "NAN_RESIDUAL", "BREAKDOWN"]),
        "cg": (["initial", "escalate cg->bicgstab after NAN_RESIDUAL",
                "fp64 safe mode after BREAKDOWN"],
               ["NAN_RESIDUAL", "BREAKDOWN", "NAN_RESIDUAL"])}
    for method, (reasons, outcomes) in expect.items():
        prog = antisymmetric_program(F.shape, np.float32, F)
        reset_stats()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            try:
                solve(prog, "T", method=method, tol=1e-6, maxiter=50,
                      options=opts.replace(recovery=RecoveryPolicy()))
            except NumericalFault as e:
                trace = e.trace
            else:
                raise AssertionError(f"health_solve: the rotation with "
                                     f"{method} did not fault")
        got = {"reasons": [a.reason.split(" (")[0] for a in trace.attempts],
               "methods": [a.method for a in trace.attempts],
               "dtypes": [a.dtype for a in trace.attempts],
               "outcomes": [a.outcome for a in trace.attempts],
               "recovery_attempts": stats.recovery_attempts,
               "numerical_faults": stats.numerical_faults}
        ladder[f"rotation_{method}"] = got
        if (got["reasons"] != reasons or got["outcomes"] != outcomes
                or got["dtypes"][-1] != "float64"
                or got["recovery_attempts"] != len(reasons) - 1
                or got["numerical_faults"] != 1):
            raise AssertionError(f"health_solve: rotation {method} {got}")
    T_over = np.full((10, 10, 6), 5.0e20, np.float32)
    T_over[1:-1, 1:-1, 0] = 3.0e20
    wse, T = record_btcs(T_over, 0.1)
    reset_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        x, info = solve(wse.program, T, method="cg", tol=1e-6, maxiter=200,
                        return_info=True,
                        options=opts.replace(recovery=RecoveryPolicy()))
    tr = info.recovery
    got = {"methods": [a.method for a in tr.attempts],
           "dtypes": [a.dtype for a in tr.attempts],
           "outcomes": [a.outcome for a in tr.attempts],
           "x_dtype": str(x.dtype), "finite": bool(np.isfinite(x).all()),
           "recovery_attempts": stats.recovery_attempts,
           "numerical_faults": stats.numerical_faults}
    ladder["overflow_fp64"] = got
    if (got["methods"] != ["cg", "bicgstab", "cg"]
            or got["dtypes"] != ["float32", "float32", "float64"]
            or got["outcomes"] != ["NAN_RESIDUAL", "NAN_RESIDUAL", "CONVERGED"]
            or not tr.succeeded or got["x_dtype"] != "float32"
            or not got["finite"] or got["recovery_attempts"] != 2
            or got["numerical_faults"] != 0):
        raise AssertionError(f"health_solve: overflow ladder {got}")
    emit({"phase": "health_solve", "seconds": time.perf_counter() - t_phase,
          "shape": [cfg.nx, cfg.ny, cfg.nz],
          "dtype": cfg.dtype, "tol": tol, "tol_relative": SOLVE_REL_TOL,
          "poisoned": labeled, "healthy_with_policy": healthy,
          "members": {"outcomes": member_outcomes,
                      "healthy_members_bitwise": unperturbed},
          "ladder": ladder, "fallbacks": fallbacks, "launches": counts})
    return by_row


def dot64(a, b) -> float:
    """``⟨a, b⟩`` in float64 on the card."""
    import torch

    return float(torch.sum(a.double() * b.double()))


def norm64(a) -> float:
    import torch

    return float(torch.linalg.vector_norm(a.double()))


def event_ms(fn):
    """``(result, ms)`` of one ``fn()`` by CUDA events on the current
    stream (the host waits for the end)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def inverse_diffusivity(n=16, nz=8, steps=3, obs_frac=0.25, iters=150,
                        coarse=4):
    """``examples/inverse_diffusivity.py`` at its own size and float64 on
    the port: recover a diffusivity on a coarse control grid by Adam
    through ``make_differentiable_solver`` (bicgstab); returns the
    relative parameter error and the misfits."""
    import numpy as np
    import torch

    from repro_torch.core.field import Field
    from repro_torch.core.program import scoped_program
    from repro_torch.solver import make_differentiable_solver
    from repro_torch.solver.frontend import Operator

    rng = np.random.default_rng(0)
    shape = (n, n, nz)
    omega = 0.3
    gx, gy = np.meshgrid(np.linspace(-1, 1, coarse),
                         np.linspace(-1, 1, coarse), indexing="ij")
    theta_true = 0.15 + 0.35 * np.exp(-2.0 * (gx ** 2 + gy ** 2))
    T0 = np.zeros(shape)
    T0[1:-1, 1:-1, 1:-1] = 1.0
    T0 += 0.1 * rng.random(shape)
    with scoped_program() as prog:
        T = Field("T", init_data=T0, dtype=np.float64)
        C = Field("kappa", shape=shape, dtype=np.float64)
        with Operator():
            T[1:-1, 0, 0] = T[1:-1, 0, 0] + omega * C[1:-1, 0, 0] * (
                6.0 * T[1:-1, 0, 0]
                - (T[2:, 0, 0] + T[:-2, 0, 0] + T[1:-1, 1, 0]
                   + T[1:-1, -1, 0] + T[1:-1, 0, 1] + T[1:-1, 0, -1]))
    solver = make_differentiable_solver(prog, "T", method="bicgstab",
                                        tol=1e-12, maxiter=400, steps=steps,
                                        device=DEV)

    xs = torch.linspace(0.0, coarse - 1.0, n, dtype=torch.float64,
                        device=DEV)
    i0 = torch.clamp(torch.floor(xs).long(), 0, coarse - 2)
    f = xs - i0

    def upsample(theta):
        fx, fy = f[:, None], f[None, :]
        c = (theta[i0[:, None], i0[None, :]] * (1 - fx) * (1 - fy)
             + theta[i0[:, None] + 1, i0[None, :]] * fx * (1 - fy)
             + theta[i0[:, None], i0[None, :] + 1] * (1 - fx) * fy
             + theta[i0[:, None] + 1, i0[None, :] + 1] * fx * fy)
        return c[:, :, None].expand(shape)

    mask = np.zeros(shape, bool)
    interior = rng.random(shape) < obs_frac
    mask[1:-1, 1:-1, 1:-1] = interior[1:-1, 1:-1, 1:-1]
    obs = torch.tensor(mask, device=DEV)
    truth = torch.tensor(theta_true, device=DEV)
    with torch.no_grad():
        y_obs = solver(T0, {"kappa": upsample(truth)})[obs]
    theta = torch.full((coarse, coarse), 0.25, dtype=torch.float64,
                       device=DEV, requires_grad=True)
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    lr, b1, b2 = 0.02, 0.9, 0.999
    misfits = []
    for i in range(1, iters + 1):
        x = solver(T0, {"kappa": upsample(theta)})
        loss = torch.sum((x[obs] - y_obs) ** 2)
        (g,) = torch.autograd.grad(loss, theta)
        misfits.append(loss.detach().item())
        with torch.no_grad():
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            theta -= lr * (m / (1 - b1 ** i)) / (
                torch.sqrt(v / (1 - b2 ** i)) + 1e-12)
    rel = float(torch.linalg.vector_norm(theta.detach() - truth)
                / torch.linalg.vector_norm(truth))
    return {"shape": list(shape), "steps": steps, "iterations": iters,
            "observed_cells": int(mask.sum()), "relative_error": rel,
            "misfit_first_last": [misfits[0], misfits[-1]]}


#: the adjoint dot-product test's bound, relative to the solve's absolute
#: tolerance: |⟨Aᵀ⁻¹ x̄, b⟩ − ⟨x̄, A⁻¹ b⟩| ≤ ADJOINT_DOT_C · tol · (‖x̄‖ +
#: ‖b‖), the forward and adjoint errors each at most ‖A⁻¹‖·tol with ‖A⁻¹‖
#: ≤ 1.6 for BTCS, and margin for the float32 solves
ADJOINT_DOT_C = 4.0


def phase_adjoint_solve(seed: int):
    """``make_differentiable_solver`` at ``HeatConfig()`` width, tol =
    1e-5·‖b‖: cg, pipecg and cg + mg on BTCS (symmetric: no kernel built
    by the backward), bicgstab on variable-coefficient BTCS (one more K1
    build for the transposed taps); the dot-product test of each adjoint;
    forward and backward ms; then ``examples/inverse_diffusivity.py`` at
    its own size, float64, to a relative parameter error below 1e-2."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig, make_field, record_implicit
    from repro_torch.solver import make_differentiable_solver, operator_fns
    from repro_torch.solver.presets import record_varcoef_btcs

    cfg = HeatConfig()
    T0 = make_field(cfg)
    C0 = np.random.default_rng(seed).uniform(0.5, 1.5, T0.shape).astype(
        np.float32)

    def program(kind):
        wse = (record_implicit(cfg) if kind == "btcs"
               else record_varcoef_btcs(T0, C0, cfg.omega))[0]
        wse.__exit__()
        return wse.program

    # per system: b = Rhs(T0), tol = 1e-5·‖b‖, and x̄ = b plus 10 % noise,
    # so that ⟨x̄, A⁻¹ b⟩ is of the order of ‖b‖²/‖A‖ and the bound below
    # a small share of it
    g = torch.Generator(device=DEV).manual_seed(seed)
    systems = {}
    for kind in ("btcs", "varcoef"):
        _, rhs = operator_fns(program(kind), "T", backend="pallas",
                              device=DEV)
        b = rhs(torch.tensor(T0, device=DEV))
        noise = torch.randn(T0.shape, generator=g, device=DEV)
        norm_b = norm64(b)
        systems[kind] = {"norm_b": norm_b, "tol": SOLVE_REL_TOL * norm_b,
                         "xbar": (b + (0.1 * norm_b / norm64(noise)) * noise)}
        del b, noise

    cases = (("cg", None, "btcs"), ("pipecg", None, "btcs"),
             ("bicgstab", None, "varcoef"), ("cg", "mg", "btcs"))
    # --- the main path: counters to 0 just before, read just after -------
    compiler.reset_stats()
    reset_counts()
    by_row, runs = {}, []
    for method, pc, kind in cases:
        compiler.clear_cache()
        built0 = compiler.stats.kernels_built
        sysm = systems[kind]
        tol, xbar = sysm["tol"], sysm["xbar"]
        s = make_differentiable_solver(program(kind), "T", method=method,
                                       precondition=pc, tol=tol,
                                       maxiter=cfg.maxiter, device=DEV)
        built = compiler.stats.kernels_built - built0
        x0 = torch.tensor(T0, device=DEV, requires_grad=True)
        before = read_counts()
        x, fwd_ms = event_ms(lambda: s(x0))
        mid = read_counts()
        (gx,), bwd_ms = event_ms(lambda: torch.autograd.grad(
            torch.sum(xbar * x), x0))
        after = read_counts()
        built_bwd = compiler.stats.kernels_built - built0 - built
        add_rows(by_row, k1_rows(counts_delta(before, after)))
        lhs = dot64(gx, x0.detach())  # ⟨Rᵀ A⁻ᵀ x̄, x0⟩ = ⟨A⁻ᵀ x̄, b⟩
        rhs = dot64(xbar, x.detach())  # ⟨x̄, A⁻¹ b⟩
        bound = ADJOINT_DOT_C * tol * (norm64(xbar) + sysm["norm_b"])
        run = {"method": method, "precondition": pc, "system": kind,
               "tol": tol, "symmetric_adjoint": s.symmetric_adjoint,
               "kernels_built_at_build": built,
               "kernels_built_by_backward": built_bwd,
               "forward_ms": fwd_ms, "backward_ms": bwd_ms,
               "dot_lhs": lhs, "dot_rhs": rhs, "dot_err": abs(lhs - rhs),
               "dot_bound": bound,
               "forward_launches": counts_delta(before, mid),
               "backward_launches": counts_delta(mid, after)}
        runs.append(run)
        want_sym = kind == "btcs"
        if (s.symmetric_adjoint != want_sym or built_bwd != 0
                or run["dot_err"] > bound or not torch.isfinite(gx).all()):
            raise AssertionError(f"adjoint_solve: {run}")
        if kind == "varcoef" and built != 2:
            raise AssertionError("adjoint_solve: bicgstab built "
                                 f"{built} kernels, not forward + transposed")
        if run["backward_launches"]["K1"] == 0 or (
                method == "pipecg" and run["backward_launches"]["K2"] == 0) or (
                pc == "mg" and run["backward_launches"]["K3"] == 0):
            raise AssertionError(f"adjoint_solve: backward launches {run}")
        del s, x, x0, gx
    counts = read_counts()
    counts["by_level"] = level_counts()
    fallbacks = compiler.stats.fallbacks
    # -----------------------------------------------------------------------
    if fallbacks:
        raise AssertionError(f"{fallbacks} interpreter fallbacks in the "
                             "adjoint solves")
    t0 = time.perf_counter()
    inverse = inverse_diffusivity()
    inverse["seconds"] = time.perf_counter() - t0
    if not inverse["relative_error"] < 1e-2:
        raise AssertionError(f"adjoint_solve: inverse problem {inverse}")
    emit({"phase": "adjoint_solve", "card": card_line(),
          "seconds": time.perf_counter() - t_phase,
          "shape": list(T0.shape), "dtype": cfg.dtype,
          "tol_relative": SOLVE_REL_TOL, "dot_test": "|<A^-T xbar, b> - "
          "<xbar, A^-1 b>| <= 4 tol (|xbar| + |b|)", "runs": runs,
          "inverse_diffusivity": inverse, "fallbacks": fallbacks,
          "launches": counts,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("adjoint")}})
    return by_row, counts["by_level"]


#: the differentiable make's dot-product test: |⟨J v, w⟩ − ⟨v, Jᵀ w⟩| ≤
#: MAKE_DOT_ULPS · S · eps32 · ‖v‖ · ‖w‖ — each of the S steps (a
#: nonnegative average, ‖J‖ ≤ 1) rounds its result within a few ulp,
#: forward (K1) and backward (the roll interpreter's VJP) alike
MAKE_DOT_ULPS = 16


def phase_adjoint_make(seed: int):
    """The differentiable heat3d ``make`` (``differentiable_runner``) at
    ``HeatConfig()`` width, float32, k = 1: its forward bitwise the
    repacking ``make``; the checkpointed gradient of ``sum(T²)`` bitwise
    the all-residuals one; the dot-product test ``⟨J v, w⟩ = ⟨v, Jᵀ w⟩``;
    peak device memory of both ladders; forward and backward ms; then the
    same on the 2×2 mesh at fewer steps (forward bitwise the single
    device, gradient within 2 f32 ulp a step of it)."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig, record_heat
    from repro_torch.core.mesh import make_mesh
    from repro_torch.engine import (RunOptions, differentiable_runner, plan,
                                    run_program)

    from torch.utils.checkpoint import checkpoint

    cfg = HeatConfig()
    mesh = make_mesh(SHARD_MESH, device=DEV)
    eps = float(np.finfo(np.float32).eps)
    # the first checkpoint call imports the rest of torch (about a second):
    # not in any timed run
    checkpoint(torch.sin, torch.ones(1, device=DEV, requires_grad=True),
               use_reentrant=False).sum().backward()

    def runner(S, m, checkpoint):
        wse, T = record_heat(cfg, S)
        wse.__exit__()
        p = plan(wse.program, RunOptions(backend="pallas", time_tile=1,
                                         mesh=m, differentiable=True,
                                         device=DEV))
        return differentiable_runner(p, checkpoint=checkpoint), wse.program, T

    def grad_run(run, x_init, loss_fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        x = torch.tensor(x_init, device=DEV, requires_grad=True)
        out, fwd_ms = event_ms(lambda: run({"T_n": x})["T_n"])
        (gx,), bwd_ms = event_ms(lambda: torch.autograd.grad(loss_fn(out), x))
        peak = torch.cuda.max_memory_allocated() - base
        return out.detach(), gx, fwd_ms, bwd_ms, peak

    # --- the main path: counters to 0 just before, read just after -------
    compiler.reset_stats()
    reset_counts()
    by_row, runs = {}, {}
    for tag, S, m in (("one", ADJOINT_MAKE_STEPS, None),
                      ("mesh", ADJOINT_MESH_STEPS, mesh)):
        got = {}
        for ck in (True, False):
            run, prog, T = runner(S, m, ck)
            before = read_counts()
            out, gx, fwd_ms, bwd_ms, peak = grad_run(
                run, T.init_data, lambda o: torch.sum(o * o))
            delta = counts_delta(before, read_counts())
            add_rows(by_row, k1_rows(delta, bricks=m.size if m else 1))
            got[ck] = {"out": out, "grad": gx, "forward_ms": fwd_ms,
                       "backward_ms": bwd_ms, "peak_bytes": peak,
                       "launches": delta}
        runs[tag] = {"steps": S, "got": got, "prog": prog}
    counts = read_counts()
    fallbacks = compiler.stats.fallbacks
    # -----------------------------------------------------------------------
    if fallbacks:
        raise AssertionError(f"{fallbacks} interpreter fallbacks in the "
                             "differentiable make")
    report = {}
    for tag, r in runs.items():
        S, got = r["steps"], r["got"]
        m = mesh if tag == "mesh" else None
        want = run_program(r["prog"], options=RunOptions(
            backend="pallas", time_tile=1, resident=False, mesh=m,
            device=DEV))["T_n"]
        ck, full = got[True], got[False]
        fwd_bitwise = np.array_equal(ck["out"].cpu().numpy(), want)
        grad_bitwise = torch.equal(ck["grad"], full["grad"])
        row = {"steps": S, "forward_bitwise_repacking_make": fwd_bitwise,
               "checkpointed_grad_bitwise_all_residuals": grad_bitwise,
               **{f"{k}_{name}": g[k] for name, g in (
                   ("checkpointed", ck), ("all_residuals", full))
                  for k in ("forward_ms", "backward_ms", "peak_bytes")},
               "launches": {"checkpointed": ck["launches"],
                            "all_residuals": full["launches"]}}
        if not (fwd_bitwise and grad_bitwise):
            raise AssertionError(f"adjoint_make {tag}: {row}")
        report[tag] = row
    # the mesh's gradient against the single device's at the same steps
    S = ADJOINT_MESH_STEPS
    run1, _, T = runner(S, None, True)
    out1, g1, *_ = grad_run(run1, T.init_data, lambda o: torch.sum(o * o))
    gm = runs["mesh"]["got"][True]
    scale = float(g1.abs().max())
    mesh_err = float((gm["grad"] - g1).abs().max())
    report["mesh"].update(
        forward_bitwise_single_device=torch.equal(gm["out"], out1),
        grad_max_abs_err_vs_single_device=mesh_err,
        grad_bound=2 * S * eps * scale)
    if not report["mesh"]["forward_bitwise_single_device"] or (
            mesh_err > 2 * S * eps * scale):
        raise AssertionError(f"adjoint_make mesh: {report['mesh']}")
    # the dot-product test of the one-device make (a linear map)
    S = ADJOINT_MAKE_STEPS
    run1, _, T = runner(S, None, True)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    v = torch.randn(T.init_data.shape, generator=gen, device=DEV)
    with torch.no_grad():
        jv = run1({"T_n": v})["T_n"]
    w = jv + 0.1 * torch.randn(jv.shape, generator=gen, device=DEV)
    _, jtw, _, _, _ = grad_run(run1, v.cpu().numpy(),
                               lambda o: torch.sum(o * w))
    lhs, rhs = dot64(jv, w), dot64(v, jtw)
    bound = MAKE_DOT_ULPS * S * eps * norm64(v) * norm64(w)
    report["dot_test"] = {"lhs": lhs, "rhs": rhs, "err": abs(lhs - rhs),
                          "bound": bound}
    if abs(lhs - rhs) > bound:
        raise AssertionError(f"adjoint_make: dot test {report['dot_test']}")
    emit({"phase": "adjoint_make", "card": card_line(),
          "seconds": time.perf_counter() - t_phase,
          "shape": [cfg.nx, cfg.ny, cfg.nz], "dtype": cfg.dtype,
          "time_tile": 1, "mesh": list(SHARD_MESH), "runs": report,
          "fallbacks": fallbacks, "launches": counts,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("adjoint_make")}})
    return by_row


#: the ``service`` phase: the throughput stream's requests, workers and
#: steps per request, and the warm manifest's signatures (HeatConfig()'s
#: grid, the reference smoke's offsets)
SERVICE_STREAM = 32
SERVICE_WORKERS = 4
SERVICE_STEPS = 200


def service_rows(delta, *, bricks: int = 1, members: int = 1):
    """One service run's launches by the ``kernels`` row they add to.  On
    one device a service run mixes K1's modes: its step requests launch
    margin mode (resident; k = 1 and, at a time tile, the sweep), its
    solves the padded k = 1 entry; bricks and members are
    :func:`k1_rows`'."""
    if bricks > 1 or members > 1:
        return k1_rows(delta, bricks=bricks, members=members)
    margin_k1 = delta["K1m"] - delta["K1sw"]
    padded_k1 = delta["K1k1"] - margin_k1
    if margin_k1 < 0 or padded_k1 < 0:
        raise AssertionError(f"a padded sweep in a service run: {delta}")
    return {"k1_margin": margin_k1, "k1_padded": padded_k1,
            "sweep": delta["K1sw"],
            **{k: delta[k] for k in ("K2", "K3", "K4")}}


def service_btcs_residual(x, T0):
    """‖b − A x‖ / ‖b‖ of the service's ``btcs_heat`` system in float64 by
    plain slicing on the card: A = I − 0.05·S on the interior, identity on
    the Moat rows; b = 0.625·T0 on the interior, T0 on the Moat."""
    import torch

    x = torch.as_tensor(x, device=DEV).double()
    b = torch.as_tensor(T0, device=DEV).double().clone()
    b[1:-1, 1:-1, 1:-1] *= 0.625
    Ax = x.clone()
    Ax[1:-1, 1:-1, 1:-1] = x[1:-1, 1:-1, 1:-1] - 0.05 * neighbours(x)
    return float(torch.linalg.vector_norm(b - Ax) / torch.linalg.vector_norm(b))


def phase_service(seed: int):
    """The simulation service at ``HeatConfig()``'s 512×512×128 float32
    grid on one card, through its entry points: the port's own ``--smoke``
    in process; heat3d and advdiff step requests (200 steps) and jacobi3d
    at ``time_tile=2`` bitwise their ``make``; restore-and-continue and
    kill-and-restore bitwise the uninterrupted run; 8 micro-batched
    requests bitwise their single ones; the service on the 2×2 mesh
    bitwise the single-device service; cg and pipecg solves and a poisoned
    solve; a 32-request heat3d stream timed (requests/s, latency, queue
    wait, device ms per served step beside ``make``'s, idle share), host µs
    per chunk, allocations per chunk, checkpoint write and restore seconds
    at 134 MB a field, and ``kernels_built`` after warm-up."""
    t_phase = time.perf_counter()
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.core.mesh import make_mesh
    from repro_torch.engine import RunOptions, health, plan, run_program
    from repro_torch.engine import single_runner
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.service import (NumericalFault, PlanSignature,
                                     SimulationService, SolveRequest,
                                     StepRequest, get_workload)
    from repro_torch.service.__main__ import main as service_main

    cfg = HeatConfig()
    shape = (cfg.nx, cfg.ny, cfg.nz)
    rng = np.random.default_rng(seed)
    heat = PlanSignature("heat3d", shape)
    adv = PlanSignature("advdiff", shape)
    jac = PlanSignature("jacobi3d", shape, time_tile=2)
    btcs = PlanSignature("btcs_heat", shape)
    manifest = [heat, adv, jac, btcs]
    inits = {heat: rng.uniform(300.0, 500.0, shape).astype(np.float32),
             adv: rng.uniform(0.0, 1.0, shape).astype(np.float32), jac: None}
    root = tempfile.mkdtemp(prefix="chip-smoke-service-")
    S = SERVICE_STEPS
    report = {}

    def make_of(sig, steps, init=None):
        """``make`` (the engine's ``run_program``) of the signature's
        recorded program, on the card."""
        program, answer = get_workload(sig.workload).record(
            sig.shape, np.dtype(sig.dtype), steps)
        env = {n: f.init_data for n, f in program.fields.items()}
        if init is not None:
            env[answer] = init
        return run_program(program, env, RunOptions(
            backend="pallas", time_tile=sig.time_tile, device=DEV))[answer]

    def serve(svc, req):
        t = svc.submit(req)
        return t.result(timeout=600), t.stats

    def check(name, ok, detail):
        report[name] = detail
        if not ok:
            raise AssertionError(f"service {name}: {detail}")

    # make of each step signature, the reference of the bitwise checks:
    # run before the main path's window, so its launches are not counted
    # as the service's
    wants = {sig: make_of(sig, S, T0) for sig, T0 in inits.items()}
    # --- the main path: counters to 0 just before, read just after -------
    compiler.reset_stats()
    reset_counts()
    by_row = {}
    try:
        # the port's own --smoke gate, at full width
        before = read_counts()
        t0 = time.perf_counter()
        rc = service_main(["--smoke", "--shape", *map(str, shape),
                           "--requests", "16", "--steps", "48",
                           "--workers", str(SERVICE_WORKERS),
                           "--ckpt-root", os.path.join(root, "smoke"),
                           "--device", DEV])
        smoke_s = time.perf_counter() - t0
        add_rows(by_row, service_rows(counts_delta(before, read_counts())))
        check("smoke", rc == 0, {"exit": rc, "seconds": smoke_s})

        svc = SimulationService(workers=SERVICE_WORKERS, manifest=manifest,
                                ckpt_root=root, device=DEV).start()
        try:
            before = read_counts()
            # step requests against make: bitwise
            served = {}
            for sig, T0 in inits.items():
                out, st = serve(svc, StepRequest(sig, steps=S, init=T0))
                want = wants[sig]
                served[sig] = out
                check(f"{sig.workload}_vs_make", np.array_equal(out, want),
                      {"steps": S, "chunks": st.chunks,
                       "launches": st.launches,
                       "max_abs_err": float(np.abs(out - want).max())})
            # restore and continue: a fault at step 100, checkpoints every 50
            req = StepRequest(heat, steps=S, init=inits[heat], ckpt_every=50)
            with FaultInjector(fail_at=[100], match_tag=req.request_id):
                out, st = serve(svc, req)
            check("restore", st.retries >= 1 and st.restores >= 1
                  and np.array_equal(out, served[heat]),
                  {"retries": st.retries, "restores": st.restores,
                   "checkpoints": st.checkpoints,
                   "bitwise": bool(np.array_equal(out, served[heat]))})
            # kill and restore: 80 steps, a new service, resume to 200
            serve(svc, StepRequest(heat, steps=80, init=inits[heat],
                                   ckpt_every=40, ckpt_key="kill"))
        finally:
            svc.stop()
        with SimulationService(workers=1, manifest=[heat], ckpt_root=root,
                               device=DEV) as svc2:
            out, st = serve(svc2, StepRequest(heat, steps=S, ckpt_every=40,
                                              ckpt_key="kill", resume=True))
        check("kill_restore", st.restores == 1 and st.steps == S - 80
              and np.array_equal(out, served[heat]),
              {"restores": st.restores, "steps_rerun": st.steps,
               "bitwise": bool(np.array_equal(out, served[heat]))})
        # solves: cg and pipecg to 1e-5·‖b‖, and a poisoned one
        with SimulationService(workers=1, manifest=[btcs],
                               device=DEV) as svc3:
            T0 = get_workload("btcs_heat").default_init(shape, np.float32)
            b = T0.astype(np.float64)
            b[1:-1, 1:-1, 1:-1] *= 0.625
            tol = SOLVE_REL_TOL * float(np.linalg.norm(b))
            for method in ("cg", "pipecg"):
                x, st = serve(svc3, SolveRequest(btcs, method=method, tol=tol,
                                                 maxiter=200))
                rel = service_btcs_residual(x, T0)
                check(f"solve_{method}", st.outcome == "CONVERGED"
                      and rel <= SOLVE_REL_TOL and np.isfinite(x).all(),
                      {"outcome": st.outcome, "iterations": st.iterations,
                       "tol": tol, "independent_f64_relative_residual": rel})
            t = svc3.submit(SolveRequest(btcs, maxiter=200, init=np.full(
                shape, np.nan, np.float32)))
            try:
                t.result(timeout=600)
                fault = None
            except NumericalFault as e:
                fault = e
            check("poisoned_solve", fault is not None and t.stats.retries == 0
                  and t.stats.outcome == "NAN_RESIDUAL"
                  and len(t.stats.recovery) >= 1,
                  {"raised": type(fault).__name__, "retries": t.stats.retries,
                   "outcome": t.stats.outcome,
                   "recovery": list(t.stats.recovery)})
        add_rows(by_row, service_rows(counts_delta(before, read_counts())))
        # micro-batching: a busy worker, then 8 same-signature requests
        steps_mb = 40
        members = [rng.uniform(300.0, 500.0, shape).astype(np.float32)
                   for _ in range(8)]
        before = read_counts()
        with SimulationService(workers=1, micro_batch=8,
                               manifest=[heat, jac], device=DEV) as svc4:
            blocker = svc4.submit(StepRequest(jac, steps=400))
            while not blocker.stats.started_s:
                time.sleep(0.001)
            tickets = [svc4.submit(StepRequest(heat, steps=steps_mb, init=T))
                       for T in members]
            outs = [t.result(timeout=600) for t in tickets]
            blocker.result(timeout=600)
        delta = counts_delta(before, read_counts())
        # the coalesced members, the blocker's sweeps and the warm-up's
        # single k = 1 launches, all resident (margin mode)
        if not delta["K1"] == delta["K1m"] == delta["K1k1"] + delta["K1sw"]:
            raise AssertionError(f"service micro_batch: launches {delta}")
        add_rows(by_row, {"members_k1": delta["K1b"], "sweep": delta["K1sw"],
                          "k1_margin": delta["K1k1"] - delta["K1b"]})
        before = read_counts()
        with SimulationService(workers=1, manifest=[heat],
                               device=DEV) as svc5:
            singles = [serve(svc5, StepRequest(heat, steps=steps_mb, init=T))[0]
                       for T in members]
        add_rows(by_row, service_rows(counts_delta(before, read_counts())))
        check("micro_batch", all(t.stats.batch == 8 for t in tickets)
              and all(np.array_equal(o, s) for o, s in zip(outs, singles)),
              {"batch": [t.stats.batch for t in tickets],
               "bitwise": [bool(np.array_equal(o, s))
                           for o, s in zip(outs, singles)]})
        # the 2x2 mesh of the card: bitwise the single-device service
        mesh = make_mesh(SHARD_MESH, ("x", "y"), device=DEV)
        before = read_counts()
        with SimulationService(workers=1, mesh=mesh, manifest=[heat, jac],
                               device=DEV) as svc6:
            mesh_out = {sig: serve(svc6, StepRequest(sig, steps=S,
                                                     init=inits[sig]))[0]
                        for sig in (heat, jac)}
        add_rows(by_row, service_rows(counts_delta(before, read_counts()),
                                      bricks=mesh.size))
        check("mesh", all(np.array_equal(mesh_out[s], served[s])
                          for s in mesh_out),
              {"mesh": list(SHARD_MESH),
               "bitwise": {s.workload: bool(np.array_equal(mesh_out[s],
                                                           served[s]))
                           for s in mesh_out}})

        # the throughput stream: 32 heat3d requests, 4 workers, warm
        def stream(svc):
            t0 = time.perf_counter()
            ts = [svc.submit(StepRequest(heat, steps=S))
                  for _ in range(SERVICE_STREAM)]
            for t in ts:
                t.result(timeout=600)
            return time.perf_counter() - t0, ts

        from torch.profiler import ProfilerActivity, profile

        before = read_counts()
        with SimulationService(workers=SERVICE_WORKERS, manifest=manifest,
                               device=DEV) as svc7:
            compiler.reset_stats()  # after the warm-up
            torch.cuda.synchronize()
            wall, ts = stream(svc7)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall_prof, _ = stream(svc7)
                torch.cuda.synchronize()
            built = compiler.stats.kernels_built
        add_rows(by_row, service_rows(counts_delta(before, read_counts())))
        counts = read_counts()
        # ------------------------------------------------------------------
        # make's ms/step on the same card: the resident loop of the body
        program, _ = get_workload("heat3d").record(shape, np.float32, S)
        run = single_runner(plan(program, RunOptions(
            backend="pallas", time_tile=1, device=DEV)))
        env = {"T": torch.tensor(program.fields["T"].init_data, device=DEV)}
        make_ms = cuda_time_ms(lambda: run(env), repeats=3) / S
        # allocations per chunk of a request the service serves (advance,
        # the wait, the probe): the growth of a warm one-worker service's
        # 2S-step request less its S-step one, after a warm-up request of
        # each (the request's env, spares, probe buffers and result cancel)
        with SimulationService(workers=1, manifest=[heat],
                               device=DEV) as svc8:
            chunk = svc8.default_chunk
            grown = {}
            for n_steps in (S, 2 * S, S, 2 * S):
                torch.cuda.synchronize()
                a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
                serve(svc8, StepRequest(heat, steps=n_steps))
                torch.cuda.synchronize()
                grown[n_steps] = (torch.cuda.memory_stats()
                                  ["allocation.all.allocated"] - a0)
            cw = svc8._plans[heat.key()]
        allocs_per_step = (grown[2 * S] - grown[S]) / S
        # host us per chunk (enqueue only), on one request's env and spares
        e, sp = cw.initial_env(None)
        host_us_chunk = host_us(lambda: cw.advance(e, sp, chunk), samples=9)
        # checkpoint write and restore of a resident env at 134 MB a field
        mgr = CheckpointManager(os.path.join(root, "timing"), keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(chunk, e, extra={"signature": heat.key(), "step": chunk,
                                  "pad": cw.layout.pad})
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _, _ = svc8._restore_env(cw, mgr)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check("restore_timing_bitwise",
              all(torch.equal(restored[n], e[n]) for n in e), True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lat = np.array([t.stats.latency_s for t in ts])
    by_kind = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            if us > 0:
                by_kind.append((us, ev.key[:60], ev.count))
    by_kind.sort(reverse=True)
    busy_us = sum(k[0] for k in by_kind)
    steps_served = SERVICE_STREAM * S
    field_mb = e["T"].numel() * e["T"].element_size() / 1e6
    timing = {
        "requests": SERVICE_STREAM, "workers": SERVICE_WORKERS,
        "steps_per_request": S, "chunk": chunk,
        "requests_per_s": SERVICE_STREAM / wall,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "mean_queue_wait_s": float(np.mean([t.stats.queue_wait_s
                                            for t in ts])),
        "device_ms_per_served_step": busy_us / 1e3 / steps_served,
        "device_us_by_kind": [{"kernel": name, "us": us, "calls": n}
                              for us, name, n in by_kind[:6]],
        "make_ms_per_step": make_ms,
        "device_idle_share": 1.0 - busy_us / (wall_prof * 1e6),
        "device_idle_share_unprofiled": 1.0 - busy_us / (wall * 1e6),
        "host_us_per_chunk": host_us_chunk,
        "allocations_per_chunk": allocs_per_step * chunk,
        "allocations_per_step": allocs_per_step,
        "allocations_per_request": [grown[S], grown[2 * S]],
        "checkpoint_field_mb": field_mb,
        "checkpoint_write_s": write_s, "checkpoint_restore_s": restore_s,
        "kernels_built_after_warm_up": built,
    }
    check("steady_state", allocs_per_step == 0 and built == 0,
          {"allocations_per_step": allocs_per_step,
           "kernels_built_after_warm_up": built})
    need = {"k1_margin", "k1_padded", "sweep", "members_k1", "bricks_k1",
            "bricks_sweep", "K2"}
    missing = sorted(k for k in need if not by_row.get(k))
    if missing:
        raise AssertionError(f"service: {missing} never launched: {by_row}")
    emit({"phase": "service", "card": card_line(),
          "seconds": time.perf_counter() - t_phase,
          "shape": list(shape), "dtype": "float32", "checks": report,
          "timing": timing, "launches": counts, "by_row": by_row,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("service")}})
    return by_row


# ---------------------------------------------------------------------------
# slice 16: the measured cost model
# ---------------------------------------------------------------------------

#: the fused and split schedules the ``cost_model`` phase times, and the
#: tile factors it calibrates at
COST_FUSED_KS = (1, 2, 4, 8)
COST_SPLIT_KS = (1, 4)
COST_CALIBRATION_KS = (1, 2, 4)


def cost_rows(delta, split_k=None) -> dict:
    """One run's K1 launches (``read_counts`` deltas, all margin mode but
    the shells) by the ``kernels`` row they add to: the k = 1 entry and
    the sweep of the monolithic steps, and the interior (region) and shell
    launches of split steps, all of which ran at ``split_k``."""
    region, shell = delta["K1rg"], delta["K1"] - delta["K1m"]
    split = region + shell
    return {"k1_margin": delta["K1k1"] - (split if split_k == 1 else 0),
            "sweep": delta["K1sw"] - (split if (split_k or 0) > 1 else 0),
            "region": region, "shell": shell}


def phase_cost_model(steps: int, cfg=None):
    """The measured cost model on the card, at ``HeatConfig()``'s
    512×512×128 float32: the resident fused step at k = 1, 2, 4, 8 and the
    split step at k = 1, 4 timed (CUDA events, ``steps`` steps after a
    warm-up); ``calibrate_program`` at k = 1, 2, 4 (the entry, its
    seconds, ``predict_step_us`` beside every measured schedule); the
    calibrated plan (``time_tile=None``, ``overlap="auto"``): its k, split,
    hits and ms per step, bitwise the uncalibrated ``make``, 0 allocations
    per step; a ``cpu``-tagged entry gives the card plan no hit; the
    manifest reloads to an equal entry; Eq. 12's rate beside the measured
    one.  The process-wide model is cleared in a ``finally``."""
    t_phase = time.perf_counter()
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch import compiler
    from repro_torch.configs.heat3d import HeatConfig, record_heat
    from repro_torch.core import perfmodel
    from repro_torch.core.program import _group_ops
    from repro_torch.engine import (RunOptions, plan, reset_stats,
                                    single_runner, stats)

    cfg = cfg or HeatConfig()
    shape = (cfg.nx, cfg.ny, cfg.nz)

    def program():
        wse, T = record_heat(cfg, steps)
        wse.__exit__()
        return wse.program, T.init_data

    def make():
        wse, T = record_heat(cfg, steps)
        return wse.make(answer=T, options=RunOptions(
            backend="pallas", time_tile=None, overlap="auto", device=DEV))

    def timed(time_tile, overlap):
        prog, init = program()
        p = plan(prog, RunOptions(backend="pallas", time_tile=time_tile,
                                  overlap=overlap, device=DEV))
        run = single_runner(p)
        env = {"T_n": torch.tensor(init, device=DEV)}
        seg = p.segments[0]
        return {"time_tile": seg.time_tile, "split": seg.split,
                "ms_per_step": cuda_time_ms(lambda: run(env),
                                            repeats=3) / steps}

    try:
        perfmodel.cost_model.clear()
        # --- the schedules, uncalibrated ----------------------------------
        schedules = {}
        for k in COST_FUSED_KS:
            schedules[f"fused_k{k}"] = timed(k, False)
        for k in COST_SPLIT_KS:
            schedules[f"split_k{k}"] = timed(k, True)
        for key, r in schedules.items():
            want = (int(key.split("_k")[1]), 4 if key.startswith("split") else 0)
            if (r["time_tile"], r["split"]) != want:
                raise AssertionError(f"cost_model: {key} planned as {r}")
        reset_stats()
        want = make()
        if stats.cost_model_hits:
            raise AssertionError("cost_model: a hit before calibrating")

        # --- the main path: calibrate, then the calibrated make ----------
        compiler.reset_stats()
        reset_counts()
        reset_stats()
        before = read_counts()
        prog, _ = program()
        t0 = time.perf_counter()
        entries = perfmodel.calibrate_program(prog, device=DEV,
                                              ks=COST_CALIBRATION_KS)
        calibration_s = time.perf_counter() - t0
        mid = read_counts()
        calibrations = stats.calibrations
        reset_stats()
        out = make()
        hits = stats.cost_model_hits
        after = read_counts()
        fallbacks = compiler.stats.fallbacks
        # ------------------------------------------------------------------
        entry = entries["T_n"]
        calib = counts_delta(before, mid)
        made = counts_delta(mid, after)
        reset_stats()
        p = plan(prog, RunOptions(backend="pallas", time_tile=None,
                                  overlap="auto", device=DEV))
        pick = {"time_tile": p.segments[0].time_tile,
                "split": p.segments[0].split}
        k_b = max(k for k in COST_CALIBRATION_KS if (
            shape[0] > 2 * k and shape[1] > 2 * k))
        by_row = add_rows(cost_rows(calib, k_b),
                          cost_rows(made, pick["time_tile"]
                                    if pick["split"] else None))
        checks = {
            "calibrations": calibrations == 1,
            "tag": entry.device == perfmodel.current_device(DEV)
            and entry.device.startswith("cuda:"),
            "hits": hits >= 1,
            "fallbacks": fallbacks == 0,
            "main_path_launched_k1": made["K1"] > 0 and calib["K1"] > 0,
            "bitwise_vs_uncalibrated": bool(np.array_equal(out, want)),
            "finite": out.shape == shape and bool(np.isfinite(out).all()),
        }
        allocs = allocations_per_step(lambda n: record_heat(cfg, n), steps,
                                      None, overlap="auto")
        checks["allocations_per_step"] = allocs["allocations_per_step"] == 0
        calibrated = timed(None, "auto")

        # a cpu-tagged entry for the same body steers no card plan
        group = compiler.lower_group(
            next(ops for loop, ops in _group_ops(prog) if loop is not None))
        perfmodel.cost_model.clear()
        perfmodel.cost_model.put(dataclasses.replace(
            entry, signature=perfmodel.body_signature(
                group, shape[2], cfg.dtype, "cpu"), device="cpu"))
        reset_stats()
        plan(prog, RunOptions(backend="pallas", time_tile=None,
                              overlap="auto", device=DEV))
        checks["cpu_entry_gives_no_hit"] = stats.cost_model_hits == 0

        # the manifest written on the card reloads to an equal entry
        model = perfmodel.CostModel()
        model.put(entry)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "cost.json")
            model.save_manifest(path)
            fresh = perfmodel.CostModel()
            fresh.load_manifest(path)
        checks["manifest_roundtrip"] = fresh.entries == {entry.signature:
                                                         entry}
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"cost_model: {failed} failed: {checks}, "
                                 f"{entry}, {pick}, {allocs}")
    finally:
        perfmodel.cost_model.clear()

    h = 1
    predicted_us = {key: perfmodel.predict_step_us(
        entry, shape[:2], shape[2], h, r["time_tile"],
        split=bool(r["split"])) for key, r in schedules.items()}
    predicted_us["calibrated"] = perfmodel.predict_step_us(
        entry, shape[:2], shape[2], h, pick["time_tile"],
        split=bool(pick["split"]))
    fastest_fused = min(r["ms_per_step"] for key, r in schedules.items()
                        if key.startswith("fused"))
    W = shape[0] * shape[1] * shape[2]
    emit({"phase": "cost_model", "card": card_line(),
          "seconds": time.perf_counter() - t_phase,
          "shape": list(shape), "dtype": cfg.dtype, "steps": steps,
          "entry": entry.to_json(), "calibration_s": calibration_s,
          "intercept_us": entry.launch_us + entry.exchange_us,
          "schedules": {key: dict(r, predicted_ms_per_step=predicted_us[key]
                                  / 1e3) for key, r in schedules.items()},
          "calibrated_plan": dict(pick, cost_model_hits=hits,
                                  ms_per_step=calibrated["ms_per_step"],
                                  predicted_ms_per_step=predicted_us[
                                      "calibrated"] / 1e3,
                                  over_fastest_fused=calibrated["ms_per_step"]
                                  / fastest_fused),
          "allocations": allocs, "checks": checks,
          "eq12_gpu_max_rate_steps_per_s": perfmodel.gpu_max_rate(
              W, HBM_BYTES_PER_S),
          "measured_steps_per_s": 1e3 / fastest_fused,
          "launches": {"calibration": calib, "calibrated_make": made},
          "by_row": by_row,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("cost_model")}})
    return by_row


LM_ARCH = "qwen3-0.6b"
#: the served batch: 8 prompts of 512 tokens, 64 generated tokens each
LM_BATCH, LM_PROMPT, LM_GEN = 8, 512, 64
#: the teacher-forced check: prefill the first 448 tokens of the 512,
#: decode the other 64 one at a time against the forward on all 512
LM_FORCED_S0 = 448
#: bounds, each × max|logit| of the forward over the compared positions:
#: float32 decode vs forward (TF32 off; another summation order per
#: matrix product shape), and the card vs the CPU at ``smoke()``
LM_F32_REL = 1e-3
LM_CARD_CPU_REL = 1e-4
#: bfloat16 decode vs forward at full width and 28 layers, × max|logit|:
#: the decode's (8, 1, ·) products and the forward's (8, 512, ·) ones
#: round to bfloat16 after float32 sums of other orders, and 28 layers
#: compound a bfloat16 ulp (2⁻⁸ ≈ 0.39 % relative) of each residual add.
#: The first card run read 0.0176 (4.5 ulps of max|logit|; PERF.md §6);
#: the bound is 13 ulps
LM_BF16_REL = 0.05
#: bfloat16 vs float32 last-token logits on the same (bfloat16) weights:
#: relative Frobenius error; first card run 0.0177, the same 13-ulp bound
LM_BF16_VS_F32 = 0.05
#: the other nine architectures: batch, prompt and decode steps of their
#: float32 teacher-forced check at published width, reduced depth
LM_OTHER_BATCH, LM_OTHER_PROMPT, LM_OTHER_STEPS = 2, 64, 8


def lm_depth_cut(cfg):
    """``cfg`` at published width with each block kind's first segment
    kept, capped at two layers (zamba2: one mamba + mamba_shared period;
    deepseek-v2: its dense MLA layer and two MoE layers)."""
    import dataclasses

    seen, segs = set(), []
    for kind, count in cfg.segments:
        if kind not in seen:
            seen.add(kind)
            segs.append((kind, min(count, 2)))
    return dataclasses.replace(cfg, segments=tuple(segs),
                               n_layers=sum(c for _, c in segs))


def lm_forced(params, tokens, cfg, s0: int) -> dict:
    """Teacher-forced decode against the forward: prefill ``tokens[:, :s0]``,
    decode the rest one token at a time; the largest |difference| of the
    prefill's and each step's logits from the forward's at the same
    position, over max|forward logit| there."""
    import torch

    from repro_torch.models import model as M

    full, _ = M.forward(params, tokens, cfg)
    want = full[:, s0 - 1:].float()
    del full
    got = lm_forced_logits(params, tokens, cfg, s0).float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return {"max_abs_err": err, "max_abs_logit": scale,
            "rel": err / scale, "positions": tokens.shape[1] - s0 + 1,
            "finite": bool(torch.isfinite(got).all()
                           and torch.isfinite(want).all())}


def lm_forced_logits(params, tokens, cfg, s0: int):
    """The prefill's logits and each teacher-forced decode step's, along
    the sequence axis."""
    import torch

    from repro_torch.models import model as M

    got, cache = M.prefill(params, tokens[:, :s0], cfg, tokens.shape[1])
    rows = [got]
    for t in range(s0, tokens.shape[1]):
        got, cache = M.decode_step(params, cache, tokens[:, t:t + 1], t, cfg)
        rows.append(got)
    return torch.cat(rows, dim=1)


def lm_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def phase_lm_serve(seed: int):
    """The LM serving path (``repro_torch.{models,launch}``) on the card:
    qwen3-0.6b at full width and depth in bfloat16 through ``serve``
    (batch 8, prompt 512, gen 64) with its checks and times, the card
    against the CPU at ``smoke()``, and the nine other architectures'
    float32 teacher-forced check at published width, reduced depth."""
    import copy
    import dataclasses

    import torch

    from repro_torch import compiler
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.kernels import build
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    B, S, G = LM_BATCH, LM_PROMPT, LM_GEN
    built = (compiler.stats.kernels_built, len(build._LIBS))

    # --- the main path: serve at full width, counters 0 before, read after
    reset_counts()
    torch.cuda.synchronize()
    # what earlier phases still hold is not the serving path's
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens, tok_per_s = serve(cfg, batch=B, prompt_len=S, gen=G, seed=seed,
                              device=DEV)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = read_counts()
    # ------------------------------------------------------------------------
    checks = {"tokens_shape": tuple(tokens.shape) == (B, G),
              "tokens_in_range": int(tokens.min()) >= 0
              and int(tokens.max()) < cfg.vocab_size,
              "no_port_kernel_launched": not any(launches.values())}

    params = M.init_params(cfg, seed=seed, device=DEV)   # serve's weights
    weight_bytes = lm_bytes(params)
    layer_params = sum(p.numel() for name, p in params.named_parameters()
                       if name.startswith("segments."))
    gen_t = torch.Generator(device=DEV).manual_seed(seed + 1)
    prompts = torch.randint(1, cfg.vocab_size, (B, S), generator=gen_t,
                            device=DEV)
    s_max = S + G
    prefill_step = make_prefill_step(cfg)
    decode_step = make_decode_step(cfg)
    with torch.no_grad():
        logits, cache = M.prefill(params, prompts, cfg, s_max)
        first = torch.argmax(logits, dim=-1)
        checks["served_first_token"] = torch.equal(first, tokens[:, :1])
        checks["prefill_step_argmax"] = torch.equal(
            torch.argmax(prefill_step(params, prompts), dim=-1), first)

        def decode_run(n):
            tok = first
            for i in range(S, S + n):
                lg, _ = decode_step(params, cache, tok, i)
                tok = torch.argmax(lg, dim=-1)
            return tok

        checks["decode_replays_serve"] = torch.equal(
            decode_run(G - 1), tokens[:, -1:])
        prefill_ms = cuda_time_ms(
            lambda: M.prefill(params, prompts, cfg, s_max), repeats=3)
        decode_ms = cuda_time_ms(lambda: decode_run(G - 1), repeats=2) \
            / (G - 1)
        t0 = time.perf_counter()
        decode_run(G - 1)
        torch.cuda.synchronize()
        decode_host_ms = (time.perf_counter() - t0) * 1e3 / (G - 1)
        decode_profile = device_breakdown(lambda: decode_run(16))
        prefill_profile = device_breakdown(
            lambda: M.prefill(params, prompts, cfg, s_max))

        # (a) teacher-forced decode against the forward, bfloat16
        forced16 = lm_forced(params, prompts, cfg, LM_FORCED_S0)
        # (a) in float32 on the same weights cast, and (b) bfloat16 against
        # float32 on the last prompt token
        params32 = copy.deepcopy(params).to(torch.float32)
        forced32 = lm_forced(params32, prompts, cfg32, LM_FORCED_S0)
        last16 = prefill_step(params, prompts).float()
        last32 = make_prefill_step(cfg32)(params32, prompts)
        bf16_vs_f32 = float(torch.linalg.vector_norm(last16 - last32)
                            / torch.linalg.vector_norm(last32))
        checks["logits_finite"] = bool(torch.isfinite(logits).all()
                                       and torch.isfinite(last16).all()
                                       and forced16["finite"]
                                       and forced32["finite"])
        del params, params32, cache, last16, last32

        # (c) the card against the CPU at smoke(), the same weights
        small = get_config(LM_ARCH).smoke()
        p_cpu = M.init_params(small, seed=seed, device="cpu")
        p_gpu = lm_params_from_numpy(lm_params_to_numpy(p_cpu), small, DEV)
        toks = torch.randint(1, small.vocab_size, (2, 24),
                             generator=torch.Generator().manual_seed(seed))
        card_cpu = {}
        for name, run in (
                ("forward", lambda p, t: M.forward(p, t, small)[0]),
                ("forced", lambda p, t: lm_forced_logits(p, t, small, 16))):
            want = run(p_cpu, toks).float()
            got = run(p_gpu, toks.to(DEV)).float().cpu()
            card_cpu[name] = float((got - want).abs().max()
                                   / want.abs().max())
        # (d) nothing of kernels/ built
        checks["no_port_kernel_built"] = built == (
            compiler.stats.kernels_built, len(build._LIBS))

    checks["forced_f32"] = forced32["rel"] <= LM_F32_REL
    checks["forced_bf16"] = forced16["rel"] <= LM_BF16_REL
    checks["bf16_vs_f32"] = bf16_vs_f32 <= LM_BF16_VS_F32
    checks["card_vs_cpu"] = max(card_cpu.values()) <= LM_CARD_CPU_REL
    torch.cuda.empty_cache()

    # --- the nine other architectures at published width, reduced depth ---
    others = {}
    for arch in ARCHS:
        if arch == LM_ARCH:
            continue
        t0 = time.perf_counter()
        c = lm_depth_cut(dataclasses.replace(
            get_config(arch), param_dtype="float32", compute_dtype="float32"))
        if c.moe:    # no capacity drops in the forward of the comparison
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=64.0))
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            p = M.init_params(c, seed=seed, device=DEV)
            shape = (LM_OTHER_BATCH, LM_OTHER_PROMPT + LM_OTHER_STEPS) + (
                (c.n_codebooks,) if c.n_codebooks > 1 else ())
            toks = torch.randint(1, c.vocab_size, shape, device=DEV,
                                 generator=torch.Generator(
                                     device=DEV).manual_seed(seed))
            r = lm_forced(p, toks, c, LM_OTHER_PROMPT)
        others[arch] = dict(r, segments=[list(x) for x in c.segments],
                            weight_gb=lm_bytes(p) / 1e9,
                            peak_gb=(torch.cuda.max_memory_allocated()
                                     - held) / 1e9,
                            seconds=time.perf_counter() - t0)
        del p
        torch.cuda.empty_cache()
        checks[f"forced_f32_{arch}"] = r["rel"] <= LM_F32_REL and r["finite"]

    # --- bounds (data sheet): decode reads every weight once a token (and
    # the cache up to its position); prefill does 2 FLOP per weight of the
    # layers per token, plus causal attention and the head on the last
    # tokens, at the dense bfloat16 tensor peak
    cache_bytes = (2 * cfg.n_layers * B * cfg.n_kv_heads * cfg.head_dim * 2
                   * (S + G // 2))
    decode_bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    prefill_ops = lm_forward_ops(cfg, layer_params, B, S, B)
    prefill_bound = prefill_ops / H100_SXM_BF16_DENSE_FLOPS * 1e3
    failed = [k for k, ok in checks.items() if not ok]
    emit({"phase": "lm_serve", "card": card_line(), "arch": LM_ARCH,
          "seconds": time.perf_counter() - t_phase,
          "batch": B, "prompt_len": S, "gen": G, "dtype": cfg.compute_dtype,
          "weight_gb": weight_bytes / 1e9, "serve_s": serve_s,
          "serve_decode_tok_per_s": tok_per_s,
          "prefill_ms": prefill_ms,
          "prefill_tok_per_s": B * S / prefill_ms * 1e3,
          "prefill_bound_ms": prefill_bound, "prefill_bound_by": "operations",
          "prefill_ops": prefill_ops,
          "decode_ms_per_token": decode_ms,
          "decode_host_ms_per_token": decode_host_ms,
          "decode_tok_per_s": B / decode_ms * 1e3,
          "decode_bound_ms": decode_bound, "decode_bound_by": "bytes",
          "decode_bound_with_cache_ms": (weight_bytes + cache_bytes)
          / HBM_BYTES_PER_S * 1e3,
          "decode_profile": decode_profile,
          "prefill_profile": prefill_profile, "peak_gb": peak_gb,
          "held_before_gb": base / 1e9,
          "forced_bf16": forced16, "forced_f32": forced32,
          "bf16_vs_f32_rel_fro": bf16_vs_f32, "card_vs_cpu_rel": card_cpu,
          "bounds": {"forced_f32": LM_F32_REL, "forced_bf16": LM_BF16_REL,
                     "bf16_vs_f32": LM_BF16_VS_F32,
                     "card_vs_cpu": LM_CARD_CPU_REL},
          "launches": launches, "others": others, "checks": checks,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("lm_")}})
    if failed:
        raise AssertionError(f"lm_serve: {failed} failed")


#: the trained batch: 8 sequences of 512 tokens of ``TokenDataset``, 24
#: steps of the cosine schedule at 1e-3 after 5 warm-up steps (at the
#: step's default 3e-4 over 100 warm-up steps the loss moves by about 0.05
#: in 40 steps of the reference's smoke model, at 1e-3/5 by 0.4)
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 512, 24
#: lm_train's depth: qwen3-0.6b's first 16 of its 28 layers, at full width.
#: With all 28 here and in ``lm_train_mesh`` the whole smoke took 1189 s of
#: its 1200 s on a slow host (9.0 s a step here, 411 s for this phase), so
#: this earlier path runs cut; ``lm_train_mesh`` keeps the full depth
#: (``tools/lm_train_probe.py`` runs this uninterrupted run at other depths)
LM_TRAIN_LAYERS = 16
LM_TRAIN_KW = {"peak_lr": 1e-3, "warmup": 5, "total_steps": 24}
#: the uninterrupted run's first steps run alone on the card: 2 warm-up
#: steps, then the timed steps (the step time is their median), then one
#: step under the profiler; the kill-and-resume run (a second process,
#: ``lm_train_resume``) starts after them and runs beside the rest, so the
#: phase takes about one run's time, not two (both host-bound, the card
#: idle most of a step).  The window of the reported loss means
LM_TRAIN_WARM_STEPS, LM_TRAIN_SOLO_STEPS = 2, 8
LM_TRAIN_LOSS_WINDOW = 5
#: the kill-and-resume process's time limit (s)
LM_TRAIN_RESUME_TIMEOUT = 900
#: the kill-and-resume run: a checkpoint every 8 steps, a fault in step 13
LM_TRAIN_CKPT_EVERY, LM_TRAIN_FAIL_AT = 8, 13
LM_TRAIN_COMPRESS_STEPS = 4
#: the card against the CPU at ``smoke()``, one step (the bounds of
#: ``tests/test_torch_train.py``): loss and gradient norm relative; every
#: parameter's update within 2·lr (a first AdamW step moves an element by
#: about lr·sign(g), and a gradient at rounding-noise level may flip
#: sign); where |g| ≥ 1e-4·max|g| of its leaf, within 1e-3·(lr + |Δp|)
LM_TRAIN_LOSS_REL, LM_TRAIN_UPDATE_REL, LM_TRAIN_MASK_REL = 1e-5, 1e-3, 1e-4


def lm_train_config():
    """qwen3-0.6b at full width, its first ``LM_TRAIN_LAYERS`` layers."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    segs, left = [], LM_TRAIN_LAYERS
    for kind, count in cfg.segments:
        if left:
            segs.append((kind, min(count, left)))
            left -= segs[-1][1]
    return dataclasses.replace(cfg, segments=tuple(segs),
                               n_layers=sum(c for _, c in segs))


def lm_forward_ops(cfg, layer_params: int, batch: int, seq: int,
                   head_rows: int) -> float:
    """A causal forward's operations: 2 per weight of the layers per
    token, the causal attention's two products, and the head on
    ``head_rows`` rows (the last token of each sequence in a prefill,
    every token in training)."""
    attn_ops = 4 * cfg.n_layers * batch * cfg.n_heads * cfg.head_dim \
        * seq * (seq + 1) / 2
    return 2 * layer_params * batch * seq + attn_ops \
        + 2 * head_rows * cfg.d_model * cfg.vocab_size


def _train_state(params, opt) -> list:
    """The leaves of a training state: parameters, then the optimizer's
    step, moments (and residual)."""
    from repro_torch.optim.tree import leaves

    return leaves({"params": params.tree(), "opt": opt})


def state_digests(params, opt) -> list:
    """(dtype, shape, sha256 of the bytes) of every leaf of a training
    state: two processes' states are bitwise equal when these are."""
    import hashlib

    import torch

    out = []
    for t in _train_state(params, opt):
        raw = t.detach().reshape(-1).view(torch.uint8).cpu().numpy()
        out.append([str(t.dtype), list(t.shape),
                    hashlib.sha256(raw.tobytes()).hexdigest()])
    return out


def held_out_batch(cfg, seed: int) -> dict:
    """``lm_train``'s held-out batch on the card: the first batch of the
    stream seeded ``seed + 1``, which the run never trains on."""
    from repro_torch.data import TokenDataset, shard_batch

    return shard_batch(TokenDataset(cfg.vocab_size, LM_TRAIN_SEQ,
                                    LM_TRAIN_BATCH, seed=seed + 1)
                       .next_batch(), DEV)


def held_out_loss(params, batch, cfg) -> float:
    """The loss of ``batch`` under ``params``: one forward, no gradient.
    Its fall over a run is the run's: the same tokens before and after, so
    the batch-to-batch swing of the steps' own losses (±0.1-0.2 on the
    card, each on a fresh batch) does not enter it."""
    import torch

    from repro_torch.models import model as M

    with torch.no_grad():
        return float(M.loss_fn(params, batch, cfg)[0])


def _train_determinism():
    """Deterministic algorithms on (so that a replayed step gives the same
    bits), without the NaN fill of every fresh buffer; returns what to
    restore."""
    import torch

    fill = getattr(torch.utils, "deterministic", None)
    prev = (torch.are_deterministic_algorithms_enabled(),
            fill.fill_uninitialized_memory if fill else None)
    torch.use_deterministic_algorithms(True)
    if fill:
        fill.fill_uninitialized_memory = False
    return prev


def _restore_determinism(prev) -> None:
    import torch

    torch.use_deterministic_algorithms(prev[0])
    fill = getattr(torch.utils, "deterministic", None)
    if fill:
        fill.fill_uninitialized_memory = prev[1]


def lm_train_resume(seed: int) -> dict:
    """The kill-and-resume run of ``lm_train``, in a process of its own:
    ``launch/train.py::train`` (``ResilientLoop``, ``CheckpointManager`` in
    a temporary directory, a checkpoint every ``LM_TRAIN_CKPT_EVERY``
    steps) from the same seed, a fault injected in step
    ``LM_TRAIN_FAIL_AT``; the digests of its final state, its losses in
    the order they ran, the checkpoints it wrote."""
    import tempfile

    import torch

    from repro_torch.launch import train as train_mod
    from repro_torch.runtime import FaultInjector

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prev = _train_determinism()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as ckpt, FaultInjector(
                fail_at=(LM_TRAIN_FAIL_AT,), match_tag="train") as inj:
            params, opt, reached, hist = train_mod.train(
                lm_train_config(), steps=LM_TRAIN_STEPS,
                batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, ckpt_dir=ckpt,
                ckpt_every=LM_TRAIN_CKPT_EVERY, device=DEV, seed=seed,
                **LM_TRAIN_KW)
            ckpt_steps = sorted(os.listdir(ckpt))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return {"digests": state_digests(params, opt),
                "losses": [float(h["loss"]) for h in hist],
                "fired": len(inj.fired), "reached": reached,
                "checkpoints": ckpt_steps, "seconds": seconds}
    finally:
        _restore_determinism(prev)


def start_lm_train_resume(seed: int, logdir: str):
    """Start :func:`lm_train_resume` in a second Python process on the same
    card; its standard output and errors go to files in ``logdir``."""
    code = ("import json, sys; sys.path.insert(0, {root!r}); "
            "import chip_smoke as cs; cs.DEV = {dev!r}; "
            "print(json.dumps(cs.lm_train_resume({seed})))").format(
                root=ROOT, dev=DEV, seed=seed)
    out = open(os.path.join(logdir, "resume.out"), "w")
    err = open(os.path.join(logdir, "resume.err"), "w")
    child = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                             stdout=out, stderr=err)
    return child, out, err


def finish_lm_train_resume(child, out, err, logdir: str) -> dict:
    """Wait for the kill-and-resume process (killed at its time limit) and
    read its result; raise with its last errors if it failed."""
    try:
        rc = child.wait(timeout=LM_TRAIN_RESUME_TIMEOUT)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        out.close()
        err.close()
    with open(os.path.join(logdir, "resume.out")) as f:
        lines = f.read().strip().splitlines()
    if rc != 0 or not lines:
        with open(os.path.join(logdir, "resume.err")) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"lm_train: the kill-and-resume process "
                             f"exited {rc}: {tail}")
    return json.loads(lines[-1])


def lm_card_vs_cpu_step(seed: int) -> dict:
    """One train step at ``smoke()`` in float32 (TF32 off) with its remat
    ``"dots"`` and 2 microbatches, the same weights and batch on the card
    and on the CPU: the loss, gradient norm and rate, and every
    parameter's update against the CPU's (bounds ``LM_TRAIN_*``)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.data import TokenDataset, shard_batch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import model as M
    from repro_torch.optim.tree import leaves

    small = get_config(LM_ARCH).smoke(remat="dots", num_microbatches=2)
    p_cpu = M.init_params(small, seed=seed, device="cpu")
    p_gpu = lm_params_from_numpy(lm_params_to_numpy(p_cpu), small, DEV)
    host = TokenDataset(small.vocab_size, 32, 4, seed=seed).next_batch()
    before = [p.detach().double().clone() for p in p_cpu.parameters()]
    _, grads = M.value_and_grad(p_cpu, shard_batch(host, "cpu"), small)
    masks = [g.abs() >= LM_TRAIN_MASK_REL * g.abs().max()
             for g in leaves(grads)]
    out = {}
    for where, params, dev in (("cpu", p_cpu, "cpu"), ("card", p_gpu, DEV)):
        step = steps_mod.make_train_step(small, **LM_TRAIN_KW)
        opt = steps_mod.make_opt_state(params)
        _, _, m = step(params, opt, shard_batch(host, dev))
        out[where] = ({k: float(v) for k, v in m.items()},
                      [p.detach().double().cpu() for p in params.parameters()])
    (mc, pc), (mg, pg) = out["cpu"], out["card"]
    lr = mc["lr"]
    worst_all = worst_tight = 0.0
    for p0, a, b, mask in zip(before, pg, pc, masks):
        diff = ((a - p0) - (b - p0)).abs()
        worst_all = max(worst_all, float(diff.max()) / lr)
        bound = LM_TRAIN_UPDATE_REL * (lr + (b - p0).abs())
        if mask.any():
            worst_tight = max(worst_tight, float((diff / bound)[mask].max()))
    rel = {k: abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("loss", "grad_norm")}
    return {"config": "smoke(remat='dots', num_microbatches=2), float32",
            "cpu": mc, "card": mg, "rel": rel,
            "lr_ulps": abs(mg["lr"] - lr) / float(np.spacing(np.float32(lr))),
            "update_over_lr_max": worst_all,
            "significant_update_over_bound_max": worst_tight,
            "ok": (max(rel.values()) <= LM_TRAIN_LOSS_REL
                   and abs(mg["lr"] - lr) <= 2 * float(
                       np.spacing(np.float32(lr)))
                   and worst_all <= 2.0 and worst_tight <= 1.0)}


def phase_lm_train(seed: int):
    """LM training on the card (``repro_torch.{optim,data}``,
    ``launch/{steps,train}.py``): qwen3-0.6b at full width and depth in
    bfloat16 with its ``remat="dots"`` and 8 microbatches, under
    ``torch.use_deterministic_algorithms`` (so a replayed step gives the
    same bits): the uninterrupted run, the kill-and-resume run (a second
    process, beside the uninterrupted run's steps after the solo window),
    remat, compression and the card against the CPU (docstring, 10l)."""
    import dataclasses
    import shutil
    import statistics
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import compiler
    from repro_torch.data import TokenDataset, shard_batch
    from repro_torch.kernels import build
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as M
    from repro_torch.optim.tree import leaves

    t_phase = time.perf_counter()
    cfg = lm_train_config()
    B, S, N = LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS
    checks = {"config": (cfg.remat, cfg.num_microbatches, cfg.n_layers,
                         cfg.param_dtype, cfg.compute_dtype)
              == ("dots", 8, LM_TRAIN_LAYERS, "bfloat16", "bfloat16")}
    built = (compiler.stats.kernels_built, len(build._LIBS))
    prev = _train_determinism()
    logdir = tempfile.mkdtemp()
    child = None
    try:
        # --- the main path: counters 0 before, read after ----------------
        reset_counts()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        params, opt, step, _ = train_mod.build(cfg, device=DEV, seed=seed,
                                               **LM_TRAIN_KW)
        one = held_out_batch(cfg, seed)
        held_out = [held_out_loss(params, one, cfg)]
        torch.cuda.synchronize()         # the steps' peak, the state's in it
        torch.cuda.reset_peak_memory_stats()
        ds = TokenDataset(cfg.vocab_size, S, B, seed=seed)
        history, events = [], []
        t0 = time.perf_counter()
        for i in range(N):
            batch = shard_batch(ds.next_batch(), DEV)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            if i == LM_TRAIN_SOLO_STEPS - 1:     # the solo window's last
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
                t_prof = time.perf_counter()
            ev[0].record()
            params, opt, m = step(params, opt, batch)
            ev[1].record()
            history.append(m)
            events.append(ev)
            if i == LM_TRAIN_SOLO_STEPS - 1:
                torch.cuda.synchronize()
                prof_us = (time.perf_counter() - t_prof) * 1e6
                prof.stop()
                child = start_lm_train_resume(seed, logdir)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        launches = read_counts()
        # ---------------------------------------------------------------
        held_out.append(held_out_loss(params, one, cfg))
        step_ms = [a.elapsed_time(b) for a, b in events]
        median_ms = statistics.median(
            step_ms[LM_TRAIN_WARM_STEPS:LM_TRAIN_SOLO_STEPS - 1])
        profile_step = profiled_kernels(prof, prof_us, median_ms * 1e3)
        losses = [float(h["loss"]) for h in history]
        gnorms = [float(h["grad_norm"]) for h in history]
        lrs = [float(h["lr"]) for h in history]
        w = LM_TRAIN_LOSS_WINDOW
        first, last = (sum(losses[:w]) / w, sum(losses[-w:]) / w)
        checks["finite"] = all(math.isfinite(x) for x in losses + gnorms)
        # the held-out batch's loss after the run against before it
        checks["loss_falls"] = held_out[1] < held_out[0]
        checks["no_port_kernel_launched"] = not any(launches.values())
        state_gb = sum(t.numel() * t.element_size()
                       for t in _train_state(params, opt)) / 1e9
        n_params = sum(p.numel() for p in params.parameters())
        layer_params = sum(p.numel() for name, p in params.named_parameters()
                           if name.startswith("segments."))
        digests = state_digests(params, opt)
        del opt
        torch.cuda.empty_cache()

        # --- remat: "dots" against "none" on one batch ------------------
        remat = {}
        grads = {}
        for policy in ("dots", "none"):
            c = dataclasses.replace(cfg, remat=policy)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            (loss, _), g = M.value_and_grad(params, one, c)
            torch.cuda.synchronize()
            remat[policy] = {
                "loss": float(loss),
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
            grads[policy] = leaves(g)
            del g
            remat[policy]["ms"] = cuda_time_ms(
                lambda: M.value_and_grad(params, one, c), repeats=2)
        checks["remat_bitwise"] = (
            remat["dots"]["loss"] == remat["none"]["loss"] and all(
                torch.equal(a, b) for a, b in zip(grads["dots"],
                                                  grads["none"])))
        del grads, params
        torch.cuda.empty_cache()

        # --- compression: 4 steps from the same weights and stream ------
        pc, oc, cstep, _ = train_mod.build(cfg, device=DEV, seed=seed,
                                           compress=True, **LM_TRAIN_KW)
        cds = TokenDataset(cfg.vocab_size, S, B, seed=seed)
        closses = []
        for _ in range(LM_TRAIN_COMPRESS_STEPS):
            pc, oc, m = cstep(pc, oc, shard_batch(cds.next_batch(), DEV))
            closses.append(float(m["loss"]))
        resid_norm = math.sqrt(sum(float(torch.sum(r.double() ** 2))
                                   for r in leaves(oc["residual"])))
        checks["compressed_finite"] = all(math.isfinite(x) for x in closses)
        checks["compressed_step1_loss"] = closses[0] == losses[0]
        del pc, oc
        torch.cuda.empty_cache()

        card_cpu = lm_card_vs_cpu_step(seed)
        checks["card_vs_cpu"] = card_cpu["ok"]
        checks["no_port_kernel_built"] = built == (
            compiler.stats.kernels_built, len(build._LIBS))

        # --- the kill-and-resume run's result ----------------------------
        resume = finish_lm_train_resume(*child, logdir)
        child = None
    finally:
        if child is not None:          # a check above raised: stop it
            child[0].kill()
            child[0].wait()
            child[1].close()
            child[2].close()
        shutil.rmtree(logdir, ignore_errors=True)
        _restore_determinism(prev)
    replayed = resume.pop("losses")
    checks["fault_fired_once"] = resume["fired"] == 1
    checks["resume_reached_the_end"] = resume["reached"] == N
    checks["resume_bitwise"] = resume.pop("digests") == digests
    # the fault in step F loses it; the replay runs steps C..N-1 again
    restart = LM_TRAIN_FAIL_AT // LM_TRAIN_CKPT_EVERY * LM_TRAIN_CKPT_EVERY
    checks["replayed_losses_bitwise"] = (
        replayed[:LM_TRAIN_FAIL_AT] == losses[:LM_TRAIN_FAIL_AT]
        and replayed[LM_TRAIN_FAIL_AT:] == losses[restart:])

    # --- bounds (data sheet): the step's products are 3× the forward's
    # (forward, and two in the backward); under "dots" the projections are
    # saved and the attention's products recomputed, one forward's more
    fwd_ops = lm_forward_ops(cfg, layer_params, B, S, B * S)
    attn_ops = lm_forward_ops(cfg, 0, B, S, 0)
    ops = 3 * fwd_ops + attn_ops
    ops_bound_ms = 3 * fwd_ops / H100_SXM_BF16_DENSE_FLOPS * 1e3
    floor_gb = n_params * (2 + 2 + 4 + 4 + 4) / 1e9
    failed = [k for k, ok in checks.items() if not ok]
    emit({"phase": "lm_train", "card": card_line(), "arch": LM_ARCH,
          "seconds": time.perf_counter() - t_phase,
          "batch": B, "seq": S, "steps": N, "dtype": cfg.compute_dtype,
          "remat": cfg.remat, "num_microbatches": cfg.num_microbatches,
          "deterministic": True, "schedule": LM_TRAIN_KW,
          "params": n_params, "run_s": run_s,
          "step_ms": step_ms, "step_ms_median": median_ms,
          "step_ms_median_beside_resume": statistics.median(
              step_ms[LM_TRAIN_SOLO_STEPS:]),
          "tok_per_s": B * S / median_ms * 1e3,
          "ops_bound_ms": ops_bound_ms, "ops_bound_by": "operations",
          "ops_with_recompute": ops,
          "ops_with_recompute_bound_ms":
              ops / H100_SXM_BF16_DENSE_FLOPS * 1e3,
          "profile_step": profile_step, "peak_gb": peak_gb,
          "memory_floor_gb": floor_gb, "state_gb": state_gb,
          "held_before_gb": held / 1e9,
          "loss": losses, "grad_norm": gnorms, "lr": lrs,
          "loss_first5_mean": first, "loss_last5_mean": last,
          "held_out_loss_before_after": held_out,
          "resume": dict(resume, fail_at=LM_TRAIN_FAIL_AT,
                         ckpt_every=LM_TRAIN_CKPT_EVERY,
                         steps_run=len(replayed)),
          "remat_vs_none": remat,
          "compressed": {"loss": closses, "residual_norm": resid_norm},
          "card_vs_cpu": card_cpu, "launches": launches, "checks": checks,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("lm_train")}})
    if failed:
        raise AssertionError(f"lm_train: {failed} failed")


#: ``lm_train_mesh``: qwen3-0.6b trained on a 2×2 (data, model) mesh of the
#: card: 16 rows of 512 (at 8 rows a microbatch is 1 row, which data = 2
#: does not divide), 8 microbatches, so each replica takes one row of each;
#: one warm-up step, under the profiler (its kernels are the timed steps'),
#: then three timed steps
LM_MESH, LM_MESH_BATCH = (2, 2), 16
LM_MESH_TIMED, LM_MESH_STEPS = (1, 2, 3), 4
#: the remesh after step 2 (index 1) onto 1×2, keeping the global batch
LM_MESH_REMESH_AFTER, LM_MESH_SHRUNK = 1, (1, 2)
#: 2×2 against 1×1 in bfloat16, relative (PERF.md §6): the card read the
#: loss bitwise and the gradient norm 8.6e-6 apart (a row's products give
#: the same bits at M = 512 and 1024); what differs is the order of the
#: float32 sums — 16 one-row passes against 8 two-row ones, ≤ 16 roundings
#: of a sum near 194 (≈ 1.3e-6 of the loss) — and the bfloat16 rounding of
#: a two-row gradient against two one-row ones.  Dropping one of the 16
#: rows moves the loss by the row's distance from the mean over 16
#: (≈ 1e-4 of it at these losses) and half of them the gradient norm by
#: far more, so the bounds catch a lost replica
LM_MESH_BF16_REL = {"loss": 1e-5, "grad_norm": 1e-4}
#: psum_compressed on the card: four parts of this many float32 values,
#: their scales 1e-2 to 1e1 apart
LM_MESH_PSUM_N = 1 << 20


def _bits(t):
    """``t``'s bits as integers (bitwise comparison of floats)."""
    import torch

    size = t.element_size()
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32, 8: torch.int64}[size])


def lm_mesh_smoke_step(seed: int) -> dict:
    """One step at ``smoke()`` in float32 (TF32 off) with 2 microbatches,
    8 × 32, the same weights and batch, on 1×1 and on a 2×2 mesh of the
    card: the loss and gradient norm within ``LM_TRAIN_LOSS_REL``, every
    update within 2·lr (``lm_train``'s card-against-CPU bounds)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset, shard_batch
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh2d
    from repro_torch.parallel import use_sharding

    small = get_config(LM_ARCH).smoke(num_microbatches=2)
    host = TokenDataset(small.vocab_size, 32, 8, seed=seed).next_batch()
    out = {}
    for shape in ((1, 1), LM_MESH):
        mesh = make_mesh2d(*shape, device=DEV)
        params, opt, step, rules = train_mod.build(
            small, mesh, seed=seed, **LM_TRAIN_KW)
        before = [p.detach().double().clone() for p in params.parameters()]
        with use_sharding(rules):
            _, _, m = step(params, opt, shard_batch(
                host, rules.sharding(("batch", "seq"), (8, 32))))
        out[shape] = ({k: float(v) for k, v in m.items()},
                      [(p.detach().double() - b).cpu()
                       for p, b in zip(params.parameters(), before)])
    (m1, d1), (m2, d2) = out[(1, 1)], out[LM_MESH]
    rel = {k: abs(m2[k] - m1[k]) / abs(m1[k]) for k in ("loss", "grad_norm")}
    worst = max(float((a - b).abs().max()) for a, b in zip(d2, d1)) / m1["lr"]
    return {"config": "smoke(num_microbatches=2), float32, 8 x 32",
            "one": m1, "mesh": m2, "rel": rel, "update_over_lr_max": worst,
            "ok": max(rel.values()) <= LM_TRAIN_LOSS_REL and worst <= 2.0
            and m1["lr"] == m2["lr"]}


def psum_compressed_card_vs_cpu(seed: int) -> dict:
    """``psum_compressed`` over ``data`` of 2×2 and 4×1 meshes, on the card
    and on the CPU, the same seeded parts of different scales: bitwise."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_mesh2d
    from repro_torch.optim.compression import psum_compressed

    rng = np.random.default_rng(seed)
    parts = [(rng.standard_normal(LM_MESH_PSUM_N) * 10.0 ** (b - 2))
             .astype(np.float32) for b in range(4)]
    out = {}
    for dims in ((2, 2), (4, 1)):
        got = {}
        for dev in (DEV, "cpu"):
            mesh = make_mesh2d(*dims, device=dev)
            got[dev] = [t.cpu() for t in psum_compressed(
                [torch.from_numpy(p).to(dev) for p in parts], mesh, "data")]
        out["x".join(map(str, dims))] = all(
            torch.equal(_bits(a), _bits(b)) for a, b in zip(got[DEV],
                                                              got["cpu"]))
    return out


def phase_lm_train_mesh(seed: int):
    """LM training on a 2×2 (data, model) mesh of the card
    (``repro_torch.parallel``, ``launch/{mesh,steps,train}.py``,
    ``runtime/elastic.py``, ``psum_compressed``): qwen3-0.6b at full width
    and depth in bfloat16 with its ``remat="dots"`` and 8 microbatches,
    under deterministic algorithms (docstring, 10m)."""
    import dataclasses
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import compiler
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset, shard_batch
    from repro_torch.kernels import build
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh2d
    from repro_torch.models.model import ParamTree
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.tree import leaves, tree_map
    from repro_torch.parallel import (PartitionSpec, param_specs_for,
                                      rules_for, use_sharding)
    from repro_torch.runtime import remesh, shrink_plan

    t_phase = time.perf_counter()
    parts, t_part = {}, [t_phase]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    cfg = get_config(LM_ARCH)
    B, S = LM_MESH_BATCH, LM_TRAIN_SEQ
    mb = cfg.num_microbatches
    checks = {"config": (cfg.remat, mb, cfg.n_layers, cfg.param_dtype)
              == ("dots", 8, 28, "bfloat16")}
    built = (compiler.stats.kernels_built, len(build._LIBS))
    ds = TokenDataset(cfg.vocab_size, S, B, seed=seed)
    host = [ds.next_batch() for _ in range(LM_MESH_STEPS)]
    prev = _train_determinism()

    def state_specs(params, mesh):
        p = param_specs_for(cfg, params.tree(), rules_for(cfg, mesh))
        return {"params": p, "opt": AdamWState(PartitionSpec(), p, p)}

    try:
        # --- 1×1: one step, its peak ------------------------------------
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params, opt, step, rules = train_mod.build(
            cfg, make_mesh2d(1, 1, device=DEV), seed=seed, **LM_TRAIN_KW)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        with use_sharding(rules):
            batch = shard_batch(host[0], rules.sharding(("batch", "seq"),
                                                        (B, S)))
            ev[0].record()
            _, _, m = step(params, opt, batch)
            ev[1].record()
        torch.cuda.synchronize()
        one = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "step_ms": ev[0].elapsed_time(ev[1]),
               "peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
               "state_gb": sum(t.numel() * t.element_size() for t in
                               _train_state(params, opt)) / 1e9}
        del params, opt, step, m, batch, _
        torch.cuda.empty_cache()
        part("one_device")

        # --- the main path: 2×2, counters 0 before, read after -----------
        mesh = make_mesh2d(*LM_MESH, device=DEV)
        reset_counts()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params, opt, step, rules = train_mod.build(cfg, mesh, seed=seed,
                                                   **LM_TRAIN_KW)
        sharding = rules.sharding(("batch", "seq"), (B, S))
        plan = steps_mod.batch_axes(rules, B // mb)
        checks["data_parallel"] = plan == (("data",), 2)
        history, events, batches = [], [], []
        with use_sharding(rules):
            for i in range(LM_MESH_STEPS):
                batch = shard_batch(host[i], sharding)
                batches.append(batch)
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                profiled = i == 0
                if profiled:
                    # the card's kernels only: with the host's ops traced
                    # as well (2×10^5 launches a step) the phase took 2.3×
                    # as long on the card, most of it reading the trace
                    prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.start()
                    t_prof = time.perf_counter()
                ev[0].record()
                params, opt, m = step(params, opt, batch)
                ev[1].record()
                history.append(m)
                events.append(ev)
                if profiled:
                    torch.cuda.synchronize()
                    prof_us = (time.perf_counter() - t_prof) * 1e6
                    prof.stop()
                if i == LM_MESH_REMESH_AFTER:
                    # the steps' peak, before the remeshed copy is held
                    torch.cuda.synchronize()
                    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
                    # --- elastic: {params, opt} onto 1×2 -----------------
                    t0 = time.perf_counter()
                    shrunk = make_mesh2d(*LM_MESH_SHRUNK, device=DEV)
                    state = {"params": params.tree(), "opt": opt}
                    placed = remesh(state, state_specs(params, shrunk),
                                    shrunk)
                    torch.cuda.synchronize()
                    remesh_s = time.perf_counter() - t0
                    checks["remesh_bitwise"] = all(
                        torch.equal(_bits(a.local()), _bits(b))
                        for a, b in zip(leaves(placed), leaves(state)))
                    checks["remesh_specs"] = all(
                        a.mesh is shrunk for a in leaves(placed))
                    del state
                if i == LM_MESH_REMESH_AFTER + 1:
                    # what the remeshed state's step must reproduce
                    want = [t.clone() for t in _train_state(params, opt)]
        torch.cuda.synchronize()
        launches = read_counts()
        state_gb = sum(t.numel() * t.element_size()
                       for t in _train_state(params, opt)) / 1e9
        # ---------------------------------------------------------------
        step_ms = [a.elapsed_time(b) for a, b in events]
        median_ms = statistics.median(step_ms[i] for i in LM_MESH_TIMED)
        part("mesh_steps")
        profile_step = profiled_kernels(prof, prof_us, median_ms * 1e3)
        del prof
        part("profile_read")
        losses = [float(h["loss"]) for h in history]
        gnorms = [float(h["grad_norm"]) for h in history]
        checks["finite"] = all(math.isfinite(x) for x in losses + gnorms)
        checks["no_port_kernel_launched"] = not any(launches.values())
        first = {"loss": losses[0], "grad_norm": gnorms[0]}
        rel = {k: abs(first[k] - one[k]) / abs(one[k])
               for k in LM_MESH_BF16_REL}
        checks["mesh_vs_one_device"] = all(
            rel[k] <= LM_MESH_BF16_REL[k] for k in LM_MESH_BF16_REL)
        checks["state_not_larger"] = state_gb <= one["state_gb"]
        del params, opt

        # --- the remeshed state's next step: 1×2, the global batch kept --
        plan_s = shrink_plan(LM_MESH[0], LM_MESH_SHRUNK[0], B, mb)
        mb2 = plan_s["keep_global_batch"]["num_microbatches"]
        checks["keep_global_batch"] = mb2 == 2 * mb
        c2 = dataclasses.replace(cfg, num_microbatches=mb2)
        p2 = ParamTree(tree_map(lambda st: st.local(), placed["params"]))
        o2 = tree_map(lambda st: st.local(), placed["opt"])
        del placed
        rules2 = rules_for(c2, make_mesh2d(*LM_MESH_SHRUNK, device=DEV))
        step2 = steps_mod.make_train_step(c2, **LM_TRAIN_KW)
        with use_sharding(rules2):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            _, o2, m2 = step2(p2, o2, batches[LM_MESH_REMESH_AFTER + 1])
            ev[1].record()
        torch.cuda.synchronize()
        nxt = LM_MESH_REMESH_AFTER + 1
        after = {"loss": float(m2["loss"]), "grad_norm":
                 float(m2["grad_norm"]), "step_ms": ev[0].elapsed_time(ev[1]),
                 "num_microbatches": mb2, "mesh": list(LM_MESH_SHRUNK),
                 "batch_axes": steps_mod.batch_axes(rules2, B // mb2),
                 "step": int(o2.step)}
        for k, got in (("loss", losses), ("grad_norm", gnorms)):
            after[k + "_rel"] = abs(after[k] - got[nxt]) / got[nxt]
        # the 2×2 step's one-row passes in the same order (replica r of
        # microbatch i is row 2i + r): the run's own next step, bitwise
        checks["remeshed_step_bitwise"] = (
            after["loss"] == losses[nxt] and after["grad_norm"] == gnorms[nxt]
            and after["step"] == nxt + 1 and all(
                torch.equal(_bits(a), _bits(b)) for a, b in
                zip(_train_state(p2, o2), want)))
        del want
        del p2, o2, batches
        torch.cuda.empty_cache()
        part("after_remesh")

        smoke_step = lm_mesh_smoke_step(seed)
        checks["smoke_f32_mesh_vs_one_device"] = smoke_step["ok"]
        part("smoke_f32")
        psum_c = psum_compressed_card_vs_cpu(seed)
        part("psum_compressed")
        checks["psum_compressed_card_vs_cpu_bitwise"] = all(psum_c.values())
        checks["no_port_kernel_built"] = built == (
            compiler.stats.kernels_built, len(build._LIBS))
    finally:
        _restore_determinism(prev)

    failed = [k for k, ok in checks.items() if not ok]
    emit({"phase": "lm_train_mesh", "card": card_line(), "arch": LM_ARCH,
          "seconds": time.perf_counter() - t_phase, "seconds_by_part": parts,
          "mesh": list(LM_MESH), "batch": B, "seq": S,
          "num_microbatches": mb, "rows_per_replica_pass": B // mb // 2,
          "dtype": cfg.compute_dtype, "remat": cfg.remat,
          "deterministic": True, "schedule": LM_TRAIN_KW,
          "step_ms": step_ms, "step_ms_median": median_ms,
          "tok_per_s": B * S / median_ms * 1e3,
          "profile_step": profile_step,
          "peak_gb": peak_gb, "state_gb": state_gb, "one_device": one,
          "loss": losses, "grad_norm": gnorms, "mesh_vs_one_device_rel": rel,
          "bf16_bound": LM_MESH_BF16_REL, "remesh_s": remesh_s,
          "after_remesh": after, "smoke_f32": smoke_step,
          "psum_compressed_bitwise": psum_c, "launches": launches,
          "checks": checks,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("lm_mesh")}})
    if failed:
        raise AssertionError(f"lm_train_mesh: {failed} failed")


#: the heat cells' grid on the card's 2×2 mesh: the production brick
#: (2048×2048×512 on 16×16) four times
DRYRUN_HEAT_GRID = (256, 256, 512)
#: time steps (FTCS) and iterations (Krylov) of each heat variant's run
DRYRUN_HEAT_STEPS = 8
#: the lm_train model's dry-run cell: global batch × sequence
DRYRUN_STATE_BATCH, DRYRUN_STATE_SEQ = 8, 512


def phase_dryrun(seed: int) -> dict:
    """The dry-run analysis (docstring, 10n); returns K5/K6/K7's launches
    on its heat path."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeCfg, get_config
    from repro_torch.configs.heat3d import HeatConfig, make_field
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.explicit import make_sharded_ftcs
    from repro_torch.core.halo import halo_pad
    from repro_torch.core.implicit import make_sharded_iteration
    from repro_torch.core.mesh import BrickArray, make_mesh
    from repro_torch.data import TokenDataset
    from repro_torch.kernels.spmv import launch_spmv_dot, spmv_dot_ref
    from repro_torch.kernels.stencil7 import (affine_stencil_ref,
                                              launch_stencil7,
                                              launch_stencil_planes,
                                              stencil_planes_ref)
    from repro_torch.launch import dryrun, heat_cell, steps as steps_mod
    from repro_torch.launch.mesh import make_mesh2d
    from repro_torch.models import model as M
    from repro_torch.optim.tree import leaves

    t_phase = time.perf_counter()
    checks, errs = {}, {}

    # --- the dry-run of qwen3-0.6b's cells on the production meshes ----------
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    records = []
    for multi_pod in (False, True):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            records.append(dryrun.run_cell(LM_ARCH, shape, multi_pod=multi_pod,
                                           verbose=False))
    checks["dryrun_allocates_nothing"] = torch.cuda.memory_allocated() == held
    checks["every_t_total_positive"] = all(r["t_total"] > 0 for r in records)
    dry_s = time.perf_counter() - t_phase

    # --- the lm_train model's state bytes against the card -------------------
    cfg = get_config(LM_ARCH)
    cell = ShapeCfg("lm_train", DRYRUN_STATE_SEQ, DRYRUN_STATE_BATCH, "train")
    state_rec = dryrun.run_cell(LM_ARCH, cell, mesh=make_mesh2d(1, 1,
                                                                device="meta"),
                                cfg=cfg, verbose=False)
    def held_bytes():
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats()
        return (stats["requested_bytes.all.current"],
                torch.cuda.memory_allocated())

    req0, alloc0 = held_bytes()
    params = M.init_params(cfg, seed=seed, device=DEV)
    opt = steps_mod.make_opt_state(params)
    host = TokenDataset(cfg.vocab_size, DRYRUN_STATE_SEQ, DRYRUN_STATE_BATCH,
                        seed=seed).next_batch()
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(DEV)
             for k, v in host.items()}
    req1, alloc1 = held_bytes()
    state_leaves = leaves(params.tree()) + leaves(opt) + list(batch.values())
    predicted = state_rec["argument_size_in_bytes"]
    # what the caching allocator holds beyond the request (its rounding,
    # and large blocks kept whole) is read, not checked
    state = {"predicted_bytes": predicted,
             "requested_bytes": req1 - req0,
             "allocated_bytes": alloc1 - alloc0,
             "allocated_gap_bytes": alloc1 - alloc0 - predicted,
             "leaves": len(state_leaves),
             "batch_dtype": str(batch["tokens"].dtype),
             "params": sum(t.numel() for t in leaves(params.tree()))}
    checks["state_requested_bytes_equal"] = req1 - req0 == predicted
    del params, opt, batch
    torch.cuda.empty_cache()

    # --- the heat cells on a 2×2 mesh of the card ----------------------------
    hc = HeatConfig(nx=DRYRUN_HEAT_GRID[0], ny=DRYRUN_HEAT_GRID[1],
                    nz=DRYRUN_HEAT_GRID[2])
    shape, w, n = DRYRUN_HEAT_GRID, hc.omega, DRYRUN_HEAT_STEPS
    mesh = make_mesh((2, 2), ("data", "model"))
    models = heat_cell.run_heat_cells(mesh, hc)
    T0 = torch.tensor(make_field(hc), device=DEV)
    g = torch.Generator(device=DEV).manual_seed(seed + 33)
    x0 = 300.0 + 200.0 * torch.rand(shape, device=DEV, generator=g,
                                    dtype=torch.float64)
    steps_, outs = {}, {}
    for name, kw in heat_cell.EXPLICIT.items():
        k = kw.get("halo_depth", 1)
        step, sharding = make_sharded_ftcs(mesh, shape, w,
                                           steps_per_call=n // k, **kw)
        steps_[name] = (step, sharding.shard(T0), n)
    for name, method, kernel in heat_cell.IMPLICIT:
        step, specs = make_sharded_iteration(mesh, shape, w, method=method,
                                             use_kernel=kernel)
        st0 = state_from_numpy(initial_iteration_state(method, x0, w),
                               specs[0].sharding)
        steps_[name] = (step, st0, 1)
    # the main path: counters 0 before, read after
    reset_counts()
    for name, (step, x, _) in steps_.items():
        out = step(x)
        outs[name] = out.gather() if name in heat_cell.EXPLICIT else out
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {k: counts[k] for k in ("K5", "K6", "K7")}
    checks["k5_k6_k7_launched_per_brick"] = launches == {
        "K5": mesh.size, "K6": n * mesh.size, "K7": n * mesh.size}
    base = outs["explicit_baseline"]
    checks["ftcs_variants_bitwise"] = all(
        torch.equal(outs[v], base) for v in heat_cell.EXPLICIT)
    checks["finite"] = bool(torch.isfinite(base).all()) and all(
        bool(torch.isfinite(outs[v][0].gather()).all())
        for v, _, _ in heat_cell.IMPLICIT)
    # K5's iteration against the plain one after one step, at legacy_btcs's
    # bounds: ITER_ULPS float32 ulp of the field a vector entry, the
    # recurrence scalar within ITER_SCALAR_REL
    got, want = ([v.gather() if isinstance(v, BrickArray) else v
                  for v in outs[k]]
                 for k in ("implicit_cg_kernel", "implicit_cg"))
    ulp = float(np.spacing(np.float32(x0.abs().max().item())))
    cg_kernel = {
        "vectors_max_abs_err": max(float((a_.double() - b_.double()).abs().max())
                                   for a_, b_ in zip(got, want) if a_.ndim),
        "atol": ITER_ULPS * ulp,
        "scalars_rel_diff": max(abs(float(a_) / float(b_) - 1.0)
                                for a_, b_ in zip(got, want) if not a_.ndim),
        "scalars_rel_bound": ITER_SCALAR_REL}
    checks["cg_kernel_iteration_vs_plain"] = (
        cg_kernel["vectors_max_abs_err"] <= cg_kernel["atol"]
        and cg_kernel["scalars_rel_diff"] <= ITER_SCALAR_REL)
    heat = {}
    for name, (step, x, per_call) in steps_.items():
        ms = cuda_time_ms(lambda: step(x), repeats=3) / per_call
        t = models[name]["t_total"] * 1e3
        heat[name] = {"ms_per_step": ms, "model_t_total_ms": t,
                      "model_4_bricks_ms": 4 * t,
                      "model_bound": models[name]["bound"],
                      "model_t_memory_ms": models[name]["t_memory"] * 1e3}
    del steps_, outs

    # --- K5/K6/K7 per launch at the production brick (queued) ---------------
    bx, by, nz = models["explicit_baseline"]["brick"]
    br = T0[:bx, :by].contiguous()
    P = halo_pad([br], 1, make_mesh((1, 1), ("data", "model")))[0]
    planes = [torch.rand(s_, device=DEV, generator=g) for s_ in
              ((1, by, nz), (1, by, nz), (bx, 1, nz), (bx, 1, nz))]
    a, wpsi = 1.0 - 6.0 * w, w / (1.0 + 6.0 * w)
    # the middle brick of a 3×3 mesh: every plane is read
    pargs = (br, *planes, (1, 1), a, w, 3 * bx, 3 * by)
    cells = bx * by * nz
    # each kernel against its plain version on these inputs: K6 and K7
    # bitwise, K5's Ap bitwise and its dot within K5_REL of Σ|c·Ap|
    for key, kern, plain in (
            ("K6", launch_stencil7(P, a, w), affine_stencil_ref(P, a, w)),
            ("K7", launch_stencil_planes(*pargs), stencil_planes_ref(*pargs))):
        checks[f"{key.lower()}_bitwise_plain"] = torch.equal(kern, plain)
        errs[key] = float((kern.double() - plain.double()).abs().max())
    av, parts = launch_spmv_dot(P, 1.0, -wpsi)
    want_av, _ = spmv_dot_ref(P, 1.0, -wpsi)
    prod = P[1:-1, 1:-1].double() * want_av.double()
    errs["K5"] = float((av.double() - want_av.double()).abs().max())
    k5_dot_err = abs(float(torch.sum(parts)) - float(prod.sum()))
    k5_ratio = k5_dot_err / float(prod.abs().sum())
    checks["k5_ap_bitwise_plain"] = torch.equal(av, want_av)
    checks["k5_dot_within_bound"] = k5_ratio <= K5_REL["float32"]
    partials = parts.numel()
    del av, want_av, prod
    per_launch = {}
    for key, kern, plain, nbytes, ops_n in (
            ("K5", lambda: launch_spmv_dot(P, 1.0, -wpsi),
             lambda: spmv_dot_ref(P, 1.0, -wpsi),
             4 * (P.numel() + cells + partials), 10 * cells),
            ("K6", lambda: launch_stencil7(P, a, w),
             lambda: affine_stencil_ref(P, a, w), 4 * (P.numel() + cells),
             8 * cells),
            ("K7", lambda: launch_stencil_planes(*pargs),
             lambda: stencil_planes_ref(*pargs),
             4 * (2 * cells + 2 * (bx + by) * nz), 8 * cells)):
        b_ms, b_by = roofline(nbytes, ops_n, "float32")
        per_launch[key] = {"brick": [bx, by, nz], "max_abs_err": errs[key],
                           "timed": "queued behind a sleep kernel (queued_ms)",
                           "ms": queued_ms(kern, repeats=200),
                           "plain_ms": cuda_time_ms(plain, repeats=10),
                           "bound_ms": b_ms, "bound_by": b_by}

    failed = [k for k, ok in checks.items() if not ok]
    emit({"phase": "dryrun", "card": card_line(),
          "seconds": time.perf_counter() - t_phase, "dryrun_host_s": dry_s,
          "records": records, "note": "records are models, not measurements",
          "state_vs_card": state, "heat_grid": list(shape),
          "heat_mesh": list(mesh.dims), "heat_steps": n, "heat": heat,
          "heat_models": models, "launches": launches,
          "cg_kernel_vs_plain": cg_kernel,
          "k5_dot_abs_err": k5_dot_err, "k5_dot_err_over_sum_abs": k5_ratio,
          "k5_bound": K5_REL["float32"],
          "per_launch": per_launch, "checks": checks,
          "predicted": {k: PREDICTED[k] for k in PREDICTED
                        if k == "card" or k.startswith("dryrun")}})
    if failed:
        raise AssertionError(f"dryrun: {failed} failed")
    return launches


def device_breakdown(fn, top: int = 4) -> dict:
    """Device time by kernel over one ``fn()`` under ``torch.profiler``, and
    the device's idle share: of the profiled call's wall time
    (``device_idle_share``, the profiler's own host cost included) and of
    an unprofiled call's (``device_idle_share_unprofiled``).  The shares are
    None where the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profiled_kernels(prof, wall_us, plain_wall_us, top)


def profiled_kernels(prof, wall_us: float, plain_wall_us: float,
                     top: int = 4) -> dict:
    """Device time by kernel in a ``torch.profiler`` trace, its sum, and
    the idle share of the profiled wall time and of an unprofiled one.
    The card's events are summed by name straight from the profiler's
    result, without the per-event objects that ``key_averages`` builds
    first (a trace of 2×10^5 launches took 37-49 s to read that way, 3 s
    this way, with the same sums)."""
    import torch

    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        us, n = by.get(e.name(), (0.0, 0))
        by[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    kernels = sorted(((us, name[:60], n) for name, (us, n) in by.items()
                      if us > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    return {"device_kernels_us": [{"kernel": name, "us": us, "calls": n}
                                  for us, name, n in kernels[:top]],
            "device_kernel_launches": sum(k[2] for k in kernels),
            "device_busy_us": busy,
            "device_idle_share": 1.0 - busy / wall_us if kernels else None,
            "device_idle_share_unprofiled":
                1.0 - busy / plain_wall_us if kernels else None}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="heat3d time steps per run (default 200)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random operands and right-hand sides")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    heat = phase_kernel_vs_ref(args.steps, args.seed)
    k2 = phase_dual_dot_vs_ref(args.seed)
    transfers = phase_transfer_vs_ref(args.seed)
    k1 = phase_heat3d(args.steps, heat)
    hazard = phase_hazard_make(args.steps, args.seed, heat)
    ensemble = phase_ensemble_make(args.steps, args.seed, heat)
    solve_counts = phase_solve_heat3d()
    ensemble_solve_counts = phase_ensemble_solve(args.seed)
    mg_counts = phase_mg_poisson(args.seed)
    legacy = phase_legacy_kernels_vs_ref(args.seed)
    ftcs_counts = phase_legacy_ftcs(args.steps, args.seed)
    btcs_counts, k5_by_mesh = phase_legacy_btcs(args.seed)
    sharded = phase_sharded_make(args.steps, heat)
    sharded_solve_counts = phase_sharded_solve()
    region, shell = phase_overlap_make(args.steps, args.seed, heat)
    phase_rows = {"health_make": phase_health_make(args.steps, args.seed),
                  "health_solve": phase_health_solve(args.seed)}
    phase_rows["adjoint_solve"], adjoint_levels = phase_adjoint_solve(
        args.seed)
    phase_rows["adjoint_make"] = phase_adjoint_make(args.seed)
    phase_rows["service"] = phase_service(args.seed)
    phase_rows["cost_model"] = phase_cost_model(args.steps)
    phase_lm_serve(args.seed)
    phase_lm_train(args.seed)
    phase_lm_train_mesh(args.seed)
    phase_rows["dryrun"] = phase_dryrun(args.seed)
    csrc = "src/repro_torch/kernels/csrc/"
    # the solves apply their operators through the k = 1 entry, padded;
    # K2 (cg + mg), K3 and K4 run in the multigrid solves of both solve
    # phases
    mg_levels = add_levels(add_levels(add_levels(add_levels(
        {}, solve_counts["by_level"]), mg_counts["by_level"]),
        sharded_solve_counts["by_level"]), adjoint_levels)
    mesh_tag = "x".join(map(str, SHARD_MESH))
    # the sharded bricks' k = 1 launches: the sharded make's (both modes)
    # and the sharded solves' operator applications (padded)
    sharded["k1"]["launches_by_mode"]["padded"] += sharded_solve_counts["K1br"]
    for tag in ("k1", "sweep"):
        n = sum(sharded[tag]["launches_by_mode"].values())
        sharded[tag].update(launches=n, launches_by_mesh={mesh_tag: n})
    solve_k1 = solve_counts["K1k1"] + mg_counts["K1k1"]
    rows = [("K1 fused_stencil, k = 1 entry, padded mode", "fused_stencil.cu",
             "src/repro/kernels/fused.py:245",
             dict(k1["k1_padded"],
                  launches=k1["k1_padded"]["launches"] + solve_k1)),
            ("K1 fused_stencil, k = 1 entry, margin mode", "fused_stencil.cu",
             "src/repro/kernels/fused.py:245",
             dict(k1["k1_margin"], library_ms=None)),
            (f"K1 fused_stencil, sweep (column entry k times), "
             f"k = {heat['sweep']['kernel'].k}, margin mode",
             "fused_stencil.cu", "src/repro/kernels/fused.py:245",
             dict(k1["sweep"], library_ms=None)),
            (HAZARD_ROW + f", k = {hazard['k']}, margin mode",
             "fused_stencil.cu", "src/repro/kernels/fused.py:245",
             dict(hazard, library_ms=None)),
            # the member axis: the ensemble phases' launches (both modes;
            # the solves' operator applications at k = 1), timed at
            # ENSEMBLE_MAKE_MEMBERS members in margin mode
            (f"K1 fused_stencil, k = 1 entry, {ENSEMBLE_MAKE_MEMBERS} members "
             "per launch, margin mode", "fused_stencil.cu",
             "src/repro/kernels/fused.py:245",
             dict(ensemble["k1"],
                  launches=ensemble["k1"]["launches"]
                  + ensemble_solve_counts["K1b"])),
            (f"K1 fused_stencil, sweep, k = {ensemble['sweep']['k']}, "
             f"{ENSEMBLE_MAKE_MEMBERS} members per launch, margin mode",
             "fused_stencil.cu", "src/repro/kernels/fused.py:245",
             dict(ensemble["sweep"], library_ms=None)),
            # K1 on the 2×2 mesh's bricks (wrap=False, the bricks' global
            # origins), timed per brick in margin mode
            (f"K1 fused_stencil, k = 1 entry, {mesh_tag} mesh bricks "
             "(wrap=False), margin mode", "fused_stencil.cu",
             "src/repro/kernels/fused.py:245",
             dict(sharded["k1"])),
            (f"K1 fused_stencil, sweep, k = {sharded['sweep']['k']}, "
             f"{mesh_tag} mesh bricks (wrap=False), margin mode",
             "fused_stencil.cu", "src/repro/kernels/fused.py:245",
             dict(sharded["sweep"], library_ms=None)),
            # the overlap's split launch (overlap_make): the interior in
            # region mode, timed at k = 1 (its sweep at the auto tile
            # beside it), and the four shells' padded launches, launch-bound
            ("K1 fused_stencil, region mode (interior), k = 1, margin mode",
             "fused_stencil.cu", "src/repro/kernels/fused.py:245",
             dict(region, library_ms=None)),
            ("K1 fused_stencil, shell (padded, launch-bound), k = 1",
             "fused_stencil.cu", "src/repro/kernels/fused.py:245",
             dict(shell, library_ms=None)),
            ("K2 dual_dot", "dual_dot.cu", "src/repro/kernels/dotprod.py:39",
             dict(k2, launches=solve_counts["K2"] + mg_counts["K2"]
                  + btcs_counts["K2"] + sharded_solve_counts["K2"])),
            ("K3 restrict", "transfer.cu", "src/repro/kernels/transfer.py:119",
             dict(transfers["K3"], launches=solve_counts["K3"] + mg_counts["K3"]
                  + sharded_solve_counts["K3"],
                  launches_by_level_pair=mg_levels["K3"])),
            ("K4 prolong", "transfer.cu", "src/repro/kernels/transfer.py:126",
             dict(transfers["K4"], launches=solve_counts["K4"] + mg_counts["K4"]
                  + sharded_solve_counts["K4"],
                  launches_by_level_pair=mg_levels["K4"])),
            ("K5 spmv_dot", "stencil7.cu", "src/repro/kernels/spmv.py:52",
             dict(legacy["K5"], launches=btcs_counts["K5"],
                  launches_by_mesh=k5_by_mesh)),
            ("K6 affine_stencil", "stencil7.cu", "src/repro/kernels/stencil7.py:62",
             dict(legacy["K6"], launches=ftcs_counts["K6"])),
            ("K7 stencil_planes", "stencil7.cu", "src/repro/kernels/stencil7.py:140",
             dict(legacy["K7"], launches=ftcs_counts["K7"]))]
    # the health, adjoint and service phases' launches, by the row they
    # belong to
    row_of = {"k1_padded": 0, "k1_margin": 1, "sweep": 2, "members_k1": 4,
              "members_sweep": 5, "bricks_k1": 6, "bricks_sweep": 7,
              "region": 8, "shell": 9, "K2": 10, "K3": 11, "K4": 12,
              "K5": 13, "K6": 14, "K7": 15}
    for phase, by_row in phase_rows.items():
        for key, n in by_row.items():
            r = rows[row_of[key]][3]
            r["launches"] += n
            r.setdefault("launches_by_phase", {})[phase] = n
    missing = [name for name, _, _, r in rows if r["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their main paths: {missing}")
    emit({"kernels": [dict({
        "name": name, "route": "cuda", "source": csrc + src, "replaces": where,
        "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]},
        **{k: r[k] for k in ("launches_by_mesh", "launches_by_mode", "brick",
                             "partials", "small_brick",
                             "launches_by_level_pair", "ms_by_level_pair",
                             "sweep_schedule_bound_ms", "k1_ms",
                             "k1_plain_ms", "k1_bound_ms", "k1_err",
                             "single_ms", "launches_by_tile", "sweep_ms",
                             "region", "extents", "launches_by_phase")
           if k in r})
        for name, src, where, r in rows]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
