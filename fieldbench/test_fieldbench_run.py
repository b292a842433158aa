"""CPU tests of the harness's runs at a tiny grid: the plain reference
against the port, each cell's sound run correct, each fault and each
control not correct, and no JAX in the run's process."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fieldbench import control, harness

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "fieldbench"
SPEC = harness.load_spec()
TINY = {"nx": 16, "ny": 16, "nz": 12}
CELLS = [w["name"] for w in SPEC["workloads"]]


def tiny(cell: str):
    """The cell's configuration at ``HeatConfig().smoke()``'s grid and its
    traffic cut to a host's pace."""
    files = harness.cell_files(SPEC, harness.find_cell(SPEC, cell))
    cfg = dict(harness.load_json(files["config"]), **TINY)
    wl = harness.load_json(files["workload"])
    if wl["kind"] == "make":
        wl["steps_per_call"] = 10
    return cfg, wl


def run(cell, seconds=0.3, trace=False, seed=2**31 + 17):
    cfg, wl = tiny(cell)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            cfg=cfg, wl=wl)


def ref_module(name):
    return harness.load_module(HERE / "configs" / f"{name}.py", f"t_ref_{name}")


def test_reference_matches_the_port_explicit():
    from repro_torch.configs.heat3d import HeatConfig, make_field, record_heat
    from repro_torch.engine import RunOptions

    cfg = HeatConfig().smoke()
    wse, T = record_heat(cfg, 50)
    got = wse.make(answer=T, options=RunOptions(backend="pallas", device="cpu"))
    ref = ref_module("heat3d")
    want = ref.ftcs(torch.tensor(make_field(cfg), dtype=torch.float64),
                    cfg.omega, 50)
    err = np.abs(got - want.numpy()).max()
    assert err <= 50 * np.spacing(np.float32(500.0))


def test_reference_matches_the_port_implicit():
    from repro_torch.configs.heat3d import HeatConfig
    from repro_torch.solver import btcs_program, make_solver

    cfg = HeatConfig().smoke()
    ref = ref_module("heat3d")
    spec = json.loads((HERE / "configs" / "heat3d.json").read_text())
    spec.update(TINY)
    T0 = ref.initial_fields(spec, 3, 1, "cpu")[0]
    tol = 1e-7 * ref.btcs_rhs_norm(T0, cfg.omega)
    step = make_solver(btcs_program(tuple(T0.shape), cfg.omega), "T",
                       method="cg", tol=tol, maxiter=200, steps=4, device="cpu")
    x, _ = step(T0)
    want, _, ok = ref.btcs_march(T0.double(), cfg.omega, 4, 1e-13, 500)
    assert all(ok)
    assert float((x.double() - want).abs().max()) < 1e-3


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert {n.rsplit(".", 1)[-1] for n in out["checks"]} >= {"first_call",
                                                              "last_calls"}
    names = {m["name"] for m in SPEC["end_to_end"]
             if harness.applies(m, cell, ())}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell, names", [
    ("heat3d-make", {"record_ms.make", "mfu.make"}),
    ("heat3d-btcs", {"iterations_per_solve", "mfu.solve"})])
def test_traced_run_reports_its_host_side_metrics(cell, names):
    out = run(cell, trace=True)
    assert names <= set(out["metrics"])
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(monkeypatch, kind):
    if kind == "make":
        from repro_torch import WFAInterface
        from repro_torch.core.program import release_program

        def make(self, answer, **kw):
            release_program(self.program)
            return np.array(answer.init_data)
        monkeypatch.setattr(WFAInterface, "make", make)
    else:
        import repro_torch.solver as solver

        def make_solver(*a, **kw):
            def step(x0):
                return (torch.as_tensor(x0).clone(),
                        (np.zeros(1, int), np.zeros(1), np.zeros(1, int)))
            return step
        monkeypatch.setattr(solver, "make_solver", make_solver)


def _wrap(monkeypatch, kind, fault):
    """Pass every answer of the timed entry through ``fault`` where it is
    produced."""
    if kind == "make":
        from repro_torch import WFAInterface

        orig = WFAInterface.make
        monkeypatch.setattr(WFAInterface, "make",
                            lambda self, answer, **kw: fault(orig(self, answer, **kw)))
    else:
        import repro_torch.solver as solver

        orig_make = solver.make_solver

        def make_solver(*a, **kw):
            step = orig_make(*a, **kw)

            def faulty(x0):
                x, info = step(x0)
                return fault(x), info
            return faulty
        monkeypatch.setattr(solver, "make_solver", make_solver)


def _altered(monkeypatch, kind):
    """One interior cell of each answer moved by a tenth of the field's
    largest value."""
    def alter(x):
        x[5, 6, 4] += 0.1 * float(abs(x).max())
        return x
    _wrap(monkeypatch, kind, alter)


def _stale(monkeypatch, kind):
    """Each call returns the answer of the call before it (the set-up's
    warm-up call its own)."""
    last = []

    def stale(x):
        prev = last[0] if last else x
        last[:] = [x]
        return prev
    _wrap(monkeypatch, kind, stale)


def _stale_late(monkeypatch, kind):
    """From the window's third call on, each call returns the answer of
    the call before it: a fault that the first call cannot show, and that
    fed back into make's next call strikes every other call."""
    seen = []

    def stale(x):
        seen.append(x)
        return seen[-2] if len(seen) > 3 else x
    _wrap(monkeypatch, kind, stale)


FAULTS = {"unchanged": _unchanged, "altered": _altered, "stale": _stale,
          "stale_late": _stale_late}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_not_correct(monkeypatch, cell, fault):
    wl = tiny(cell)[1]
    per_call = wl["steps_per_call"] if wl["kind"] == "march" else 1
    # a window of at least four calls and not many more: the tiny grid's
    # field comes to rest within a few hundred steps, after which a stale
    # answer equals a fresh one; the window doubles until it holds four
    seconds = 0.02
    while True:
        FAULTS[fault](monkeypatch, wl["kind"])
        out = run(cell, seconds=seconds)
        monkeypatch.undo()
        if out["attempted"] >= 4 * per_call:
            break
        seconds *= 2
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_its_limit(cell):
    cfg, wl = tiny(cell)
    (_, got), = control.readings(cell, [2**31 + 5], device="cpu", cfg=cfg,
                                 wl=wl)
    assert {n.rsplit(".", 1)[-1] for n, _ in got} == {"first_call",
                                                      "last_calls"}
    for name, value in got:
        assert value > LIMIT[name.split(".")[0]](wl), (name, value)


#: the workload key that holds the limit of each kind of number compared
LIMIT = {"max_abs_K": lambda wl: wl["limit_K"],
         "rel_gap": lambda wl: wl["limit_rel"]}


def test_the_run_holds_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from fieldbench import harness\n"
            "from fieldbench.test_fieldbench_run import tiny\n"
            "cfg, wl = tiny('heat3d-btcs')\n"
            "harness.run_cell('heat3d-btcs', 3, 0.1, True, device='cpu', "
            "cfg=cfg, wl=wl)\n"
            "print('FORBIDDEN', harness.forbidden_modules())\n"
            % (str(ROOT / "src"), str(ROOT)))
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert "FORBIDDEN []" in out.stdout, out.stdout + out.stderr
    assert harness.forbidden_modules.__doc__


def test_forbidden_names_are_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = sys
        assert "repro_torch_like" not in harness.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert "jax.numpy" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cuda_control_fails_at_the_cells_size(card, cell):
    """The control at the cell's own size, on three seeds: every number
    it reads is above its limit."""
    files = harness.cell_files(SPEC, harness.find_cell(SPEC, cell))
    wl = harness.load_json(files["workload"])
    for seed, got in control.readings(cell, [11, 12, 13]):
        for name, value in got:
            assert value > LIMIT[name.split(".")[0]](wl), (seed, name, value)
