"""The plain reference agrees with the port at small sizes, and its counts
with the port's op counters."""

import pytest
import torch

import repro_torch as rt
from repro_torch.core import dispatch
from sigbench import check, entries
from sigbench.counts import pde
from sigbench.reference import calls, goursat


def _paths(seed, shape, drift=0.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * 0.1 + torch.linspace(0, drift, shape[1])[:, None]


def test_scheme_and_adjoint_match_the_row_scan():
    delta = torch.randn(3, 9, 7, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    d1 = delta.clone().requires_grad_()
    d2 = delta.clone().requires_grad_()
    goursat.solve(d1).sum().backward()
    from repro_torch.core.sigkernel import solve_goursat
    solve_goursat(d2).sum().backward()
    torch.testing.assert_close(d1.grad, d2.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("lam", [0, 1])
def test_sigkernel_value_and_gradient(lam):
    x, y = _paths(2, (4, 24, 3)), _paths(3, (4, 21, 3), 0.3)
    v, g = calls.sigkernel(x, y, lam=lam, grad=True)
    xg = x.clone().requires_grad_()
    k = rt.sigkernel(xg, y, grid=rt.GridConfig(lam, lam))
    gp, = torch.autograd.grad(k.sum(), xg)
    found = check.numbers([(k, gp)], [(v, g)])
    assert found["value_err"] < 2e-5 and found["grad_err"] < 2e-5, found


def test_mmd2_value_and_gradient():
    X, Y = _paths(4, (5, 20, 3)), _paths(5, (6, 20, 3), 0.3)
    v, g = calls.mmd2(X, Y, grad=True)
    Xg = X.clone().requires_grad_()
    vp = rt.mmd2(Xg, Y)
    gp, = torch.autograd.grad(vp, Xg)
    found = check.numbers([(vp, gp)], [(v, g)])
    assert found["value_err"] < 2e-5 and found["grad_err"] < 2e-5, found
    v0, g0 = calls.mmd2(X, Y)
    assert g0 is None and torch.equal(v0, v)


@pytest.mark.parametrize("name", ["mmd2", "sigkernel", "mmd2_sharded"])
def test_entry_reference_takes_the_traffic_keywords(name):
    """A keyword that only chooses how the port computes reaches the
    reference and leaves its answer as it is."""
    X, Y = _paths(10, (4, 16, 3)), _paths(11, (4, 16, 3), 0.3)
    cfg = {"dyadic_order": 0}
    entry = entries.load(name)
    plain = entry.reference({"x": X, "y": Y}, cfg, {"grad": True})
    blocked = entry.reference({"x": X, "y": Y}, cfg, {"grad": True, "kwargs": {"row_block": 2}})
    assert torch.equal(plain[0], blocked[0]) and torch.equal(plain[1], blocked[1])


def test_control_departs_from_the_reference():
    X, Y = _paths(6, (5, 30, 4)), _paths(7, (5, 30, 4), 0.3)
    v, g = calls.mmd2(X, Y, grad=True)
    vc, gc = calls.mmd2(X, Y, grad=True, control=True)
    assert vc.dtype == torch.float32
    assert abs(float(vc) - float(v)) / abs(float(v)) > 1e-5
    assert calls.round_tf32(torch.tensor([1.0 + 2 ** -12])).item() == 1.0


@pytest.mark.parametrize("entry,grad", [("mmd2", True), ("mmd2", False), ("sigkernel", True)])
def test_counts_agree_with_the_counters(entry, grad):
    cfg = {"x_shape": [5, 12, 3], "y_shape": [5, 10, 3], "dyadic_order": 0,
           "dtype": "float32"}
    counted = entries.load(entry).counts(cfg, {"entry": entry, "grad": grad})
    X, Y = _paths(8, tuple(cfg["x_shape"])), _paths(9, tuple(cfg["y_shape"]))
    with dispatch.count_pair_solves() as pairs, dispatch.count_scan_steps() as scans:
        if entry == "mmd2":
            rt.mmd2(X, Y)
        else:
            rt.sigkernel(X, Y)
    assert counted["pair_solves"] == pairs.total
    assert counted["scan_steps"] == scans.total == 0
    cells = 11 * 9
    fwd = pairs.total * cells * pde.FWD_FLOPS_PER_CELL
    if grad:
        swept = 15 + 25 if entry == "mmd2" else 5
        assert counted["goursat_flops"] == fwd + swept * cells * pde.ADJ_FLOPS_PER_CELL
    else:
        assert counted["goursat_flops"] == fwd
