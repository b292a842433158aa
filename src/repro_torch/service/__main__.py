"""``python -m repro_torch.service`` — the serving smoke demo and CI gate.

The port of ``repro/service/__main__.py``: the same four gated phases, on
the card unless ``--device cpu`` asks for the host.

``--smoke`` runs the full acceptance scenario end to end:

1. warm a 3-signature manifest (heat3d / advdiff / jacobi3d), then serve a
   mixed stream of ≥64 concurrent step + solve requests and **gate** on:
   every request completed, zero kernel compiles after warm-up (every
   request a plan-cache hit), zero retries, zero unexpected interpreter
   fallbacks;
2. inject a step fault into one checkpointed request and gate on it
   completing *with* a restore (restore-and-continue, not restart);
3. force a pallas compile failure for a fresh signature and gate on it
   being served through the logged interpreter degraded mode;
4. submit a *poisoned* solve request (NaN initial state) and gate on it
   failing **fast** with ``NumericalFault`` — zero retries, the health
   taxonomy word and a populated recovery trace on the ticket — while the
   injected infrastructure fault of phase 2 still retried.

Exit status is 0 only if every gate holds, so CI can call this directly.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="simulation service smoke demo / CI gate",
    )
    p.add_argument("--smoke", action="store_true",
                   help="run the gated end-to-end scenario (CI entry point)")
    p.add_argument("--requests", type=int, default=64,
                   help="concurrent requests in the mixed stream (default 64)")
    p.add_argument("--workers", type=int, default=4,
                   help="service worker threads (default 4)")
    p.add_argument("--steps", type=int, default=24,
                   help="logical steps per step request (default 24)")
    p.add_argument("--shape", type=int, nargs=3, default=(24, 24, 6),
                   metavar=("NX", "NY", "NZ"),
                   help="base field shape (default 24 24 6)")
    p.add_argument("--no-fault", action="store_true",
                   help="skip the fault-injection and degraded-mode phases")
    p.add_argument("--json", action="store_true",
                   help="emit the final service stats as JSON on stdout")
    p.add_argument("--ckpt-root", default=None,
                   help="checkpoint directory (default: a temp dir, "
                        "removed at the end)")
    p.add_argument("--device", default="cuda",
                   help="torch device the service runs on (default cuda; "
                        "cpu runs every kernel's plain version)")
    return p


def _gate(checks: dict) -> bool:
    ok = True
    for name, passed in checks.items():
        print(f"  [{'PASS' if passed else 'FAIL'}] {name}")
        ok = ok and passed
    return ok


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if not args.smoke:
        _build_parser().print_help()
        return 0

    import shutil
    import tempfile

    from repro_torch.compiler import stats as kstats
    from repro_torch.engine import reset_stats
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.service import (
        PlanSignature,
        SimulationService,
        SolveRequest,
        StepRequest,
    )

    reset_stats()
    nx, ny, nz = args.shape
    ckpt_root = args.ckpt_root or tempfile.mkdtemp(prefix="repro-service-")
    manifest = [
        PlanSignature("heat3d", (nx, ny, nz)),
        PlanSignature("advdiff", (nx - 4, ny - 4, nz)),
        PlanSignature("jacobi3d", (nx - 8, ny - 8, nz), time_tile=2),
    ]
    solve_sig = PlanSignature("btcs_heat", (12, 12, 4))

    svc = SimulationService(
        workers=args.workers,
        capacity=max(4 * args.requests, 256),
        manifest=manifest + [solve_sig],
        ckpt_root=ckpt_root,
        default_chunk=max(1, args.steps // 3),
        device=args.device,
    )
    print(f"== warm-up: {len(manifest) + 1} manifest signatures ==")
    svc.start()

    # ---- phase 1: mixed no-fault stream ------------------------------------
    built_before = kstats.kernels_built
    print(f"== phase 1: {args.requests} concurrent mixed requests ==")
    tickets = []
    for i in range(args.requests):
        if i % 8 == 7:
            tickets.append(svc.submit(SolveRequest(solve_sig, maxiter=60)))
        else:
            sig = manifest[i % len(manifest)]
            tickets.append(
                svc.submit(
                    StepRequest(sig, steps=args.steps, priority=i % 3)
                )
            )
    results = []
    for t in tickets:
        try:
            results.append(t.result(timeout=600))
        except Exception as e:  # gate below reports it; keep draining
            print(f"  request {t.request.request_id} failed: {e!r}")
            results.append(None)
    finite = all(
        r is not None and np.all(np.isfinite(np.asarray(r))) for r in results
    )
    phase1 = {
        "all requests completed": all(t.done() and t.error() is None
                                      for t in tickets),
        "results finite": finite,
        f"distinct signatures >= 3 "
        f"({len({t.stats.signature for t in tickets})})":
            len({t.stats.signature for t in tickets}) >= 3,
        "zero kernel compiles after warm-up":
            kstats.kernels_built == built_before,
        "every request hit the plan cache":
            all(t.stats.plan_cache_hit for t in tickets),
        "zero retries on the no-fault stream":
            sum(t.stats.retries for t in tickets) == 0,
        "zero degraded requests":
            sum(t.stats.degraded for t in tickets) == 0,
        "zero unexpected interpreter fallbacks": kstats.fallbacks == 0,
    }
    ok = _gate(phase1)

    if not args.no_fault:
        # ---- phase 2: fault-injected request completes via restore --------
        print("== phase 2: injected step fault -> restore-and-continue ==")
        fail_step = 2 * max(1, args.steps // 4)
        with FaultInjector(fail_at=[fail_step]):
            t = svc.submit(
                StepRequest(
                    manifest[0], steps=args.steps,
                    ckpt_every=max(1, args.steps // 4),
                )
            )
            faulted = t.result(timeout=600)
        phase2 = {
            "fault-injected request completed":
                np.all(np.isfinite(np.asarray(faulted))),
            f"retried ({t.stats.retries}) and restored "
            f"({t.stats.restores}) mid-flight":
                t.stats.retries >= 1 and t.stats.restores >= 1,
            f"checkpoints written ({t.stats.checkpoints})":
                t.stats.checkpoints >= 2,
        }
        ok = _gate(phase2) and ok

        # ---- phase 3: forced compile failure -> logged degraded mode ------
        print("== phase 3: forced compile failure -> degraded mode ==")
        degraded_sig = PlanSignature("heat3d", (nx + 2, ny + 2, nz))
        with FaultInjector(fail_compile=["service_heat"]):
            t = svc.submit(StepRequest(degraded_sig, steps=8))
            deg = t.result(timeout=600)
        phase3 = {
            "degraded request completed":
                np.all(np.isfinite(np.asarray(deg))),
            "served via interpreter degraded mode": t.stats.degraded,
            f"fallback logged ({t.stats.degraded_reason[:40]!r})":
                bool(t.stats.degraded_reason),
        }
        ok = _gate(phase3) and ok

        # ---- phase 4: poisoned request -> fail-fast NumericalFault --------
        print("== phase 4: poisoned solve -> fail-fast NumericalFault ==")
        from repro_torch.engine.health import NumericalFault

        poison = np.full(solve_sig.shape, np.nan, solve_sig.dtype)
        t = svc.submit(SolveRequest(solve_sig, maxiter=60, init=poison))
        fault = None
        try:
            t.result(timeout=600)
        except Exception as e:
            fault = e
        phase4 = {
            "poisoned solve raised NumericalFault":
                isinstance(fault, NumericalFault),
            f"failed fast: zero retries ({t.stats.retries})":
                t.stats.retries == 0,
            f"taxonomy on ticket ({t.stats.outcome!r})":
                t.stats.outcome == "NAN_RESIDUAL",
            f"recovery trace populated ({len(t.stats.recovery)} attempts)":
                len(t.stats.recovery) >= 1,
        }
        ok = _gate(phase4) and ok

    stats = svc.service_stats()
    svc.save_manifest(f"{ckpt_root}/manifest.json")
    svc.stop()
    if args.json:
        print(json.dumps(stats, indent=1, default=str))
    else:
        req = stats["requests"]
        print(
            f"== served {req['completed']} requests "
            f"(mean queue wait {req['mean_queue_wait_s'] * 1e3:.1f} ms, "
            f"plan cache hits {stats['plans']['cache_hits']}, "
            f"kernel cache hits {stats['kernels']['cache_hits']}) =="
        )
    if args.ckpt_root is None:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    print("SMOKE PASS" if ok else "SMOKE FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
