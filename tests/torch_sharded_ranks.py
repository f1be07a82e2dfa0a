"""The ranks' side of the sharded-Gram tests (tests/test_torch_sharded_gram.py
on gloo, tests/test_torch_kernels_gpu.py on NCCL).

Each rank of a ``repro_torch.launch.spawn_ranks`` group imports this module
by name, so it imports torch, numpy and the port only.  The inputs and the
cases are plain values that both the ranks and the JAX side build their
configs from.
"""

import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch as rt
from repro_torch.core import dispatch
from repro_torch.core import features as ft
from repro_torch.launch import make_gram_mesh

BX, BY, L, D = 5, 4, 9, 2
SIGMA = 0.8
#: the transforms case's pipeline, as keyword arguments of either package's
PIPELINE = dict(time_aug=True, basepoint=True, t0=0.5, t1=2.0)
FEATURE_RANK = {"rff": 4, "nystroem": 3}

#: value cases: sym (Y omitted), kernel ("linear" / "rbf"), order2 (scheme
#: order2 at λ = (1, 1)), ragged (lengths=), transforms, row_block, tile,
#: features ("rff" / "nystroem"), bx (paths in X)
CASES = {
    "linear": {},
    "linear_sym": {"sym": True},
    "ragged": {"ragged": True},
    "ragged_sym": {"sym": True, "ragged": True},
    "transforms": {"transforms": True},
    "row_block2": {"row_block": 2},
    "row_block2_sym": {"sym": True, "row_block": 2},
    "tile2": {"tile": 2},
    "rbf": {"kernel": "rbf"},
    "rbf_sym": {"sym": True, "kernel": "rbf"},
    "order2": {"order2": True},
    "order2_sym": {"sym": True, "order2": True},
    "rff": {"features": "rff"},
    "rff_sym": {"sym": True, "features": "rff"},
    "rff_rbf": {"features": "rff", "kernel": "rbf"},
    "rff_three_paths": {"features": "rff", "bx": 3},
    "nystroem": {"features": "nystroem"},
    "nystroem_sym": {"sym": True, "features": "nystroem"},
}
#: gradient cases: a value case and what the gradient is taken with respect to
GRAD_CASES = {
    "linear": ("linear", ("X", "Y")),
    "linear_sym": ("linear_sym", ("X",)),
    "ragged_sym": ("ragged_sym", ("X",)),
    "rbf_sigma": ("rbf", ("X", "Y", "sigma")),
    "rbf_sym_sigma": ("rbf_sym", ("X", "sigma")),
    "order2": ("order2", ("X", "Y")),
    "rff_rbf_sigma": ("rff_rbf", ("X", "Y", "sigma")),
    "nystroem_sym": ("nystroem_sym", ("X",)),
}


def inputs(case):
    """(X, Y or None, lengths or None, lengths_y or None, W) as float64 numpy;
    W weights the gradient cases' loss sum(K * W)."""
    c = CASES[case]
    rng = np.random.default_rng(7)
    X = rng.normal(size=(BX, L, D)) * 0.3
    Y = rng.normal(size=(BY, L, D)) * 0.3
    lengths, lengths_y = np.array([9, 4, 7, 2, 6]), np.array([3, 9, 5, 8])
    bx = c.get("bx", BX)
    X, lengths = X[:bx], lengths[:bx]
    by = bx if c.get("sym") else BY
    W = rng.normal(size=(BX, BX if c.get("sym") else BY))[:bx, :by]
    if c.get("sym"):
        Y, lengths_y = None, None
    if not c.get("ragged"):
        lengths = lengths_y = None
    return X, Y, lengths, lengths_y, W


def config_kwargs(case, pkg, sigma=SIGMA):
    """Keyword arguments of ``sigkernel_gram`` for ``case`` in ``pkg`` (the
    port or the JAX package), features excepted."""
    c = CASES[case]
    kw = {"static_kernel": pkg.RBF(sigma) if c.get("kernel") == "rbf" else pkg.Linear()}
    if c.get("order2"):
        kw["grid"] = pkg.GridConfig(lam1=1, lam2=1, scheme="order2")
    if c.get("transforms"):
        kw["transforms"] = pkg.TransformPipeline(**PIPELINE)
    return kw


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _case_call(case, fn, X, Y, sigma, device):
    """``fn(X, Y, ...)`` with ``case``'s configs and arguments."""
    c = CASES[case]
    _, _, lengths, lengths_y, _ = inputs(case)
    kw = config_kwargs(case, rt, sigma)
    if c.get("features"):
        kw["features"] = rt.FeatureConfig(c["features"], rank=FEATURE_RANK[c["features"]])
    if fn is rt.sigkernel_gram_sharded:
        kw.update({k: c[k] for k in ("tile",) if k in c})
    if "row_block" in c:
        kw["row_block"] = c["row_block"]
    if lengths is not None:
        kw["lengths"] = _t(lengths).to(device)
        if lengths_y is not None:
            kw["lengths_y"] = _t(lengths_y).to(device)
    return fn(X, Y, **kw)


def _use_draws(draws, device, dtype):
    """Make the port's feature maps take the given draws (the JAX package's)."""
    if draws is None:
        return
    if "pool" in draws:
        pool = _t(draws["pool"]).to(device)
        ft.nystroem_pool = lambda feats, batch, *, device: pool
    else:
        rff = ft.RFFDraws(*(None if draws[k] is None else _t(draws[k]).to(device, dtype)
                            for k in ("w", "b", "proj")))
        ft.rff_draws = lambda feats, kernel, d, *, device, dtype=dtype: rff


def run_case(case, device, dtype, draws=None, wrt=()):
    """The sharded Gram, the dense one, their pair budgets and, for ``wrt``,
    both gradients of sum(K * W), on this rank."""
    X, Y, _, _, W = inputs(case)
    _use_draws(draws, device, dtype)
    out = {}
    for name, fn in (("sharded", rt.sigkernel_gram_sharded), ("dense", rt.sigkernel_gram)):
        leaves = {"X": _t(X).to(device, dtype), "Y": None if Y is None else _t(Y).to(device, dtype),
                  "sigma": torch.tensor(SIGMA, dtype=dtype, device=device)}
        for k in wrt:
            leaves[k].requires_grad_()
        with dispatch.count_pair_solves() as count:
            K = _case_call(case, fn, leaves["X"], leaves["Y"], leaves["sigma"], device)
        out[name] = K.detach().cpu()
        out[name + "_pairs"] = count.total
        if wrt:
            gs = torch.autograd.grad((K * _t(W).to(device, dtype)).sum(),
                                     [leaves[k] for k in wrt])
            out[name + "_grads"] = {k: v.cpu() for k, v in zip(wrt, gs)}
    return out


def refusals(world):
    """The messages of the refusals a gloo group of ``world`` ranks can show."""
    from torch.distributed.device_mesh import init_device_mesh
    got = {}
    X, Y, _, _, _ = inputs("linear")
    for what, call in (
            ("n_not_world", lambda: make_gram_mesh(world + 1)),
            ("card_mesh_on_gloo", lambda: make_gram_mesh(device_type="cuda")),
            ("missing_axis", lambda: rt.sigkernel_gram_sharded(
                _t(X), _t(Y), mesh=init_device_mesh("cpu", (world,), mesh_dim_names=("data",)))),
            ("same_axis", lambda: rt.sigkernel_gram_sharded(
                _t(X), _t(Y), mesh=make_gram_mesh(), col_axis="data"))):
        try:
            call()
            got[what] = None
        except ValueError as e:
            got[what] = str(e)
    return got


def gloo_rank(rank, world, draws):
    """One gloo rank: the mesh shape, every value and gradient case, and the
    refusals.  ``draws``: the JAX draws of each features case."""
    mesh = make_gram_mesh()
    cpu, f64 = torch.device("cpu"), torch.float64
    return {"mesh": tuple(mesh.shape),
            "values": {c: run_case(c, cpu, f64, draws.get(c)) for c in CASES},
            "grads": {g: run_case(c, cpu, f64, draws.get(c), wrt)
                      for g, (c, wrt) in GRAD_CASES.items()},
            "refusals": refusals(world)}


def nccl_rank(rank, world, cases):
    """One NCCL rank: ``cases`` in float32 on this rank's card."""
    dev = torch.device("cuda", rank)
    return {c: run_case(c, dev, torch.float32, wrt=("X",)) for c in cases}


def failing_rank(rank, world):
    """Rank 1 raises while the others wait for it in a collective."""
    if rank == 1:
        raise RuntimeError("rank 1 fails before the barrier")
    dist.barrier()


def sleeping_rank(rank, world):
    time.sleep(120)


def sync_count_rank(rank, world):
    """The unbiased MMD² from three sharded Grams and its gradient in X,
    as the benchmark's sharded cell assembles it: the blocking uploads
    counted, and the port's spans under a CPU profiler."""
    from collections import Counter

    from repro_torch import spans
    mesh = make_gram_mesh()
    g = torch.Generator().manual_seed(7)
    X = (torch.randn(BX, L, D, generator=g) * 0.1).cumsum(1).requires_grad_()
    Y = (torch.randn(BY, L, D, generator=g) * 0.1).cumsum(1) + 0.3

    def call():
        gram = rt.sigkernel_gram_sharded
        Kxx, Kyy, Kxy = gram(X, mesh=mesh), gram(Y, mesh=mesh), gram(X, Y, mesh=mesh)
        v = ((Kxx.sum() - torch.trace(Kxx)) / (BX * (BX - 1))
             + (Kyy.sum() - torch.trace(Kyy)) / (BY * (BY - 1)) - 2.0 * Kxy.mean())
        torch.autograd.grad(v, X)

    with dispatch.count_host_syncs() as c:
        call()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    return {"syncs": c.total,
            "spans": dict(Counter(e.name for e in prof.events() if e.name in spans.NAMES))}
