"""Card-only tests of the port's solver kernels K2, K3 and K4.

This file imports neither JAX nor ``repro``, so it runs on a machine that
has a CUDA card and no JAX::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips.  Tolerances:

* K2 against its plain version evaluated in float64: ``|K2 − exact| ≤
  rel·Σ|aᵢbᵢ|`` with rel = 1e-5 (float32) / 1e-13 (float64) — the kernel
  sums in another order than ``torch.sum`` (about 50 roundings deep), and
  is deterministic (no atomics), so two runs give the same bits;
* K3/K4 against ``restrict_ref``/``prolong_ref``: bitwise (both round
  every operation on its own, in the same separable order);
* a solve on the card against the same solve on the CPU, at ``tol =
  1e-5·‖T0‖``: the same outcome word, iteration counts within ±1 (the dots
  sum in different orders) and solutions within ``3.2·tol`` (each lies
  within ``1.6·tol`` of the exact one: the BTCS operator's smallest
  eigenvalue is ≥ 0.625).
"""
import numpy as np
import pytest
import torch

from conftest import heat_init
from repro_torch.engine import RunOptions
from repro_torch.kernels import ops
from repro_torch.kernels import transfer as port_transfer
from repro_torch.kernels.dotprod import dual_dot_ref, launch_dual_dot
from repro_torch.solver import record_btcs

SHAPES = [(9, 9, 9), (17, 17, 5), (16, 12, 10), (8, 7, 6), (257, 129, 33)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_cuda_dual_dot_within_bound():
    """K2 within its bound of the float64 plain version, deterministic,
    aliased operands too (chip_smoke.py runs the same check at the main
    path's size)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        a, b, c = (torch.randn(37, 29, 1001, device="cuda", generator=g,
                               dtype=dtype) for _ in range(3))
        for ops4 in ((a, b, c, a), (a, a, b, a)):
            got = ops.dual_dot(*ops4)
            again = ops.dual_dot(*ops4)
            assert torch.equal(got, again)
            exact = dual_dot_ref(*(t.double() for t in ops4))
            scale = torch.stack([(ops4[0].double() * ops4[1]).abs().sum(),
                                 (ops4[2].double() * ops4[3]).abs().sum()])
            assert ((got.double() - exact).abs() <= rel * scale).all()


@pytest.mark.cuda
def test_cuda_transfers_bitwise_vs_plain():
    """K3 and K4 equal restrict_ref / prolong_ref bit for bit at float32 and
    float64 on odd, even and ragged level pairs (chip_smoke.py runs every
    level pair of the 512×512×128 hierarchy)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(4)
    for dtype in (torch.float32, torch.float64):
        for shape in SHAPES:
            fine = torch.randn(shape, device="cuda", generator=g, dtype=dtype)
            coarse = torch.randn(port_transfer.coarsen_shape(shape),
                                 device="cuda", generator=g, dtype=dtype)
            assert torch.equal(port_transfer.launch_restrict(fine),
                               port_transfer.restrict_ref(fine))
            assert torch.equal(port_transfer.launch_prolong(coarse, shape),
                               port_transfer.prolong_ref(coarse, shape))


@pytest.mark.cuda
@pytest.mark.parametrize("method,precondition", [
    ("cg", None), ("pipecg", None), ("cg", "mg"), ("bicgstab", "mg")])
def test_cuda_solve_matches_the_cpu(method, precondition):
    """solve(backend="pallas") on the card launches K2 (where the method
    has a fused dot pair) and K3/K4 (multigrid), and agrees with the same
    solve on the CPU."""
    _need_card()
    T0 = heat_init((33, 33, 17))
    tol = 1e-5 * float(np.linalg.norm(T0))   # Kelvin scale: f32 floors near 1e-7·‖b‖
    out = {}
    for device in ("cuda", "cpu"):
        before = (launch_dual_dot.launches, port_transfer.launch_restrict.launches)
        wse, T = record_btcs(T0, 0.1)
        out[device] = wse.solve(T, method=method, precondition=precondition,
                                tol=tol, return_info=True,
                                options=RunOptions(backend="pallas",
                                                   device=device))
        launched = (launch_dual_dot.launches - before[0],
                    port_transfer.launch_restrict.launches - before[1])
        fused_dots = method == "pipecg" or (method == "cg" and precondition)
        assert (launched[0] > 0) == (device == "cuda" and bool(fused_dots))
        assert (launched[1] > 0) == (device == "cuda" and bool(precondition))
    (x_card, i_card), (x_cpu, i_cpu) = out["cuda"], out["cpu"]
    assert list(i_card.outcomes) == list(i_cpu.outcomes) == ["CONVERGED"]
    assert abs(int(i_card.iterations[0]) - int(i_cpu.iterations[0])) <= 1
    assert np.abs(x_card.astype(np.float64) - x_cpu).max() <= 3.2 * tol
