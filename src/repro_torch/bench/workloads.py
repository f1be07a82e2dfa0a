"""Paper-aligned benchmark workloads at smoke / quick / full sizes.

Counterpart of ``repro.bench.workloads``: the same cells, letter for letter,
and the same entry names, each workload calling the port's counterpart of
the JAX function with the same arguments.  Every workload returns a list of
*entries* — plain dicts the suite serialises into the BENCH JSON:

``{"name": str, "kind": "time" | "accuracy" | "check",
   "seconds": float,          # kind == "time"
   "value": float,            # kind == "accuracy" (relative error)
   "derived": str,            # human-readable extras
   "meta": {...}}             # shape/op context; meta["gate"] = False
                              # excludes an entry from the perf gate

Names are stable across runs — :mod:`repro_torch.bench.compare` matches
entries by name.  ``full`` uses the paper's exact (B, L, d, N) cells,
``quick`` scales them down but keeps every comparison intact, and
``smoke`` is the tiny gate.  Every workload runs on ``device`` (the card
unless the caller passes ``"cpu"``); inputs come from a seeded
``torch.Generator`` on that device.

Backends: ``"gpu"`` and ``"gpu_fused"`` (the hand-written CUDA kernels, the
JAX package's ``"pallas"`` and ``"pallas_fused"``) run on the card only, so
off the card the Gram sweep, the smoke checks and the ragged agreement
take the plain backends, as the JAX package drops its TPU-only ones off
the TPU.

**The per-entry budget.**  Two baselines are Python loops of small eager
launches: Table 2's row scan (``solve_goursat``, 11 ops a refined cell)
and autograd through it (28).  Before a timed entry runs,
:func:`over_budget` estimates one call's cost from the cell's shape alone
(ops × :data:`SECONDS_PER_OP`), and an entry over
:data:`ENTRY_BUDGET_SECONDS` is recorded as a ``kind="check"`` entry with
``gate=False`` whose ``derived`` gives the estimate and the reason.  The
estimate depends on the name and meta only, so every run of a mode skips
the same entries (:func:`plan` lists them): at ``full``, the row scan at
L = 512 and 1024 and the autodiff at L = 512 and 1024.

``autotune_auto``, ``approx_frontier`` and ``scheme_frontier`` write the
autotune cache (:mod:`repro_torch.bench.autotune`) at
``REPRO_AUTOTUNE_CACHE`` (default ``~/.cache/repro_torch/autotune.json``):
a run that must not touch the home directory's cache points that variable
at a file of its own.  Which frontier points run depends on the key shape
alone (:func:`repro_torch.bench.autotune.scheme_points`), so :func:`plan`
lists them too.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.config import RBF, TransformPipeline, delta_from_gram
from repro_torch.core.features import FeatureConfig
from repro_torch.core.gram import (sigkernel_gram, sigkernel_gram_reduce,
                                   sigkernel_gram_sharded)
from repro_torch.core.logsignature import logsignature
from repro_torch.core.lyndon import logsig_dim
from repro_torch.core.signature import signature, signature_direct
from repro_torch.core.sigkernel import (delta_matrix, sigkernel, solve_goursat,
                                        solve_goursat_antidiag, solve_goursat_grad,
                                        solve_goursat_grad_pde_approx)
from repro_torch.core.tensoralg import sig_dim
from repro_torch.stream import Path

from . import autotune, timer

MODES = ("smoke", "quick", "full")


def _check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return mode


def _t(name: str, seconds: float, derived: str = "", **meta) -> dict:
    return {"name": name, "kind": "time", "seconds": float(seconds),
            "derived": derived, "meta": meta}


def _acc(name: str, value: float, derived: str = "", **meta) -> dict:
    return {"name": name, "kind": "accuracy", "value": float(value),
            "derived": derived, "meta": meta}


def _chk(name: str, derived: str = "ok", **meta) -> dict:
    return {"name": name, "kind": "check", "derived": derived, "meta": meta}


def _paths(seed: int, B: int, L: int, d: int, scale: float, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((B, L, d), generator=g, device=device) * scale


def _grad(f: Callable, argnums=(0,)) -> Callable:
    """``jax.grad`` of ``f(*args).sum()``: the gradients with respect to the
    arguments at ``argnums``, at fresh leaves of them."""
    def g(*args):
        leaves = [a.detach().requires_grad_(i in argnums) for i, a in enumerate(args)]
        return torch.autograd.grad(f(*leaves).sum(), [leaves[i] for i in argnums])
    return g


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _vs(label: str, t_base: Optional[float]) -> Callable[[float], str]:
    """``derived`` text "label=<t_base / t>x"; empty when the base entry was
    skipped by the budget."""
    return lambda t: f"{label}={t_base / t:.2f}x" if t_base else ""


# ---------------------------------------------------------------------------
# the per-entry budget of the plain-loop baselines
# ---------------------------------------------------------------------------

#: host cost of one small eager PyTorch op (a launch of a tiny kernel plus
#: the Python around it), the unit of the loop baselines' estimate
SECONDS_PER_OP = 10e-6
#: a timed entry whose one call is estimated above this is not run
ENTRY_BUDGET_SECONDS = 20.0
#: eager ops a refined cell of ``solve_goursat``'s row scan issues, and of
#: autograd through it (forward + backward), counted with a
#: TorchDispatchMode over the scan
_LOOP_OPS_PER_CELL = {"_fwd_rowscan": 11, "_bwd_autodiff": 28}


def estimated_seconds(name: str, meta: dict) -> Optional[float]:
    """One call's estimated seconds for a plain-loop baseline (Table 2's row
    scan and autograd through it), from its name and meta; None for other
    entries."""
    if meta.get("op") != "sigkernel":
        return None
    for suffix, ops in _LOOP_OPS_PER_CELL.items():
        if name.endswith(suffix):
            return ops * (meta["L"] - 1) ** 2 * SECONDS_PER_OP
    return None


def over_budget(name: str, meta: dict) -> Optional[str]:
    """Why the entry is not run (its estimate against the budget), or None."""
    seconds = estimated_seconds(name, meta)
    if seconds is None or seconds <= ENTRY_BUDGET_SECONDS:
        return None
    return (f"estimated {seconds:.0f} s a call > budget {ENTRY_BUDGET_SECONDS:.0f} s "
            f"(plain Python loop of small launches)")


def _timed(name: str, fn: Callable, args: tuple, repeats: int,
           derived: Callable[[float], str] = lambda t: "",
           **meta) -> Tuple[dict, Optional[float]]:
    """(entry, seconds): the timed entry, or the budget's skip check and None."""
    reason = over_budget(name, meta)
    if reason is not None:
        return _chk(name, f"skipped: {reason}", gate=False, **meta), None
    t = timer.bench(fn, *args, repeats=repeats)
    return _t(name, t, derived(t), **meta), t


# ---------------------------------------------------------------------------
# calibration — a fixed machine-speed probe every BENCH JSON carries, so
# compare.py can normalise away uniform box-speed differences
# ---------------------------------------------------------------------------

def calibration(mode: str = "smoke", repeats: int = 3, *, device="cuda") -> List[dict]:
    _check_mode(mode)
    x = torch.full((256, 256), 1.0 / 256.0, device=device)

    def probe(x):
        c = x
        for _ in range(32):
            c = c @ x
        return c.sum()

    t = timer.bench(probe, x, repeats=max(repeats, 3))
    return [_t("calibration_matmul_scan", t,
               "fixed 256x256 matmul scan (machine-speed probe)", gate=False)]


# ---------------------------------------------------------------------------
# Table 1 — truncated signatures: direct (Alg 1) vs Horner (Alg 2),
# autodiff vs time-reversed exact backward
# ---------------------------------------------------------------------------

_TABLE1_CELLS = {
    "smoke": [(4, 32, 3, 4)],
    "quick": [(16, 64, 4, 6), (16, 128, 8, 5), (16, 256, 16, 4)],
    "full": [(128, 256, 4, 6), (128, 512, 8, 5), (128, 1024, 16, 4)],
}


def table1_signatures(mode: str = "quick", repeats: int = 5, *,
                      device="cuda") -> List[dict]:
    entries = []
    for (B, L, d, N) in _TABLE1_CELLS[_check_mode(mode)]:
        path = _paths(0, B, L, d, 0.2, device)
        tag = f"table1_B{B}_L{L}_d{d}_N{N}"
        meta = dict(op="signature", B=B, L=L, d=d, depth=N)

        e, t_dir = _timed(f"{tag}_fwd_direct", lambda p: signature_direct(p, N),
                          (path,), repeats, **meta)
        entries.append(e)
        entries.append(_timed(f"{tag}_fwd_horner",
                              lambda p: signature(p, N, backend="reference"), (path,),
                              repeats, _vs("speedup_vs_direct", t_dir), **meta)[0])
        e, t_ga = _timed(f"{tag}_bwd_autodiff",
                         _grad(lambda p: signature_direct(p, N)), (path,), repeats, **meta)
        entries.append(e)
        entries.append(_timed(f"{tag}_bwd_timereversed",
                              _grad(lambda p: signature(p, N, backend="reference")),
                              (path,), repeats, _vs("speedup_vs_autodiff", t_ga),
                              **meta)[0])
    return entries


# ---------------------------------------------------------------------------
# Table 2 — signature kernels: row-scan vs wavefront forward, autodiff vs
# exact one-pass backward, plus the Gram engine through every usable backend
# ---------------------------------------------------------------------------

_TABLE2_CELLS = {
    "smoke": [(4, 16, 4)],
    "quick": [(16, 64, 8), (16, 128, 16), (8, 256, 32)],
    "full": [(128, 256, 8), (128, 512, 16), (128, 1024, 32)],
}

_GRAM_CELLS = {
    "smoke": [(4, 12, 3)],
    "quick": [(8, 32, 4)],
    "full": [(32, 128, 8)],
}


def _exact_gram_backends(device) -> List[str]:
    """The exact Gram backends that run on ``device``, in registry order
    (the CUDA kernels' only on the card)."""
    on_card = torch.device(device).type == "cuda"
    return [b for b in dispatch.backends_for("gram")
            if not dispatch.get(b).approximate
            and (on_card or not dispatch.get(b).needs_cuda)]


def _usable_gram_backends(device) -> List[str]:
    # approximate feature-map backends answer a different question (an
    # approximation of the Gram); reference first so the other rows can
    # report their speedup against it
    backends = _exact_gram_backends(device)
    return (["reference"] if "reference" in backends else []) + \
        [b for b in backends if b != "reference"]


def table2_sigkernels(mode: str = "quick", repeats: int = 5, *,
                      device="cuda") -> List[dict]:
    entries = []
    for (B, L, d) in _TABLE2_CELLS[_check_mode(mode)]:
        kx = _paths(0, B, L, d, 0.1, device)
        ky = _paths(1, B, L, d, 0.1, device)
        tag = f"table2_B{B}_L{L}_d{d}"
        meta = dict(op="sigkernel", B=B, L=L, d=d)

        e, t_scan = _timed(f"{tag}_fwd_rowscan",
                           lambda x, y: solve_goursat(delta_matrix(x, y)), (kx, ky),
                           repeats, **meta)
        entries.append(e)
        entries.append(_timed(f"{tag}_fwd_wavefront",
                              lambda x, y: solve_goursat_antidiag(delta_matrix(x, y)),
                              (kx, ky), repeats, _vs("speedup_vs_rowscan", t_scan),
                              **meta)[0])
        e, t_ga = _timed(f"{tag}_bwd_autodiff",
                         _grad(lambda x, y: solve_goursat(delta_matrix(x, y))),
                         (kx, ky), repeats, **meta)
        entries.append(e)
        # the default backend: B1-cps and B2 on the card
        entries.append(_timed(f"{tag}_bwd_exact_alg4", _grad(sigkernel), (kx, ky),
                              repeats, _vs("speedup_vs_autodiff", t_ga), **meta)[0])

    entries.extend(gram_backends(mode=mode, repeats=repeats, device=device))
    return entries


def gram_backends(mode: str = "quick", repeats: int = 5, backends=None, *,
                  device="cuda") -> List[dict]:
    """Gram engine entries: every usable backend × {dense, symmetric}."""
    if backends is None:
        backends = _usable_gram_backends(device)
    entries = []
    for (B, L, d) in _GRAM_CELLS[_check_mode(mode)]:
        X = _paths(2, B, L, d, 0.1, device)
        Y = _paths(3, B, L, d, 0.1, device)
        tag = f"table2_gram_B{B}_L{L}_d{d}"
        meta = dict(op="gram", B=B, L=L, d=d)
        t_ref = None
        for b in backends:
            e, t = _timed(f"{tag}_dense_{b}",
                          lambda x, y, b=b: sigkernel_gram(x, y, backend=b, symmetric=False),
                          (X, Y), repeats, _vs("speedup_vs_reference", t_ref),
                          backend=b, **meta)
            entries.append(e)
            if b == "reference":
                t_ref = t
        # symmetric fast path: ~half the PDE solves of the dense Kxx
        for b in backends:
            entries.append(_timed(f"{tag}_symmetric_{b}",
                                  lambda x, b=b: sigkernel_gram(x, backend=b), (X,),
                                  repeats, backend=b, **meta)[0])
    return entries


# ---------------------------------------------------------------------------
# RBF static-kernel lift — the Δ-from-Gram path: one timed Gram entry per
# mode + an oracle agreement check
# ---------------------------------------------------------------------------

_RBF_CELLS = {
    "smoke": [(4, 12, 3)],
    "quick": [(8, 32, 4)],
    "full": [(32, 128, 8)],
}


def rbf_lift(mode: str = "smoke", repeats: int = 3, *, device="cuda") -> List[dict]:
    entries = []
    for (B, L, d) in _RBF_CELLS[_check_mode(mode)]:
        X = _paths(4, B, L, d, 0.3, device)
        Y = _paths(5, B, L, d, 0.3, device)
        kernel = RBF(sigma=1.0)
        tag = f"rbf_lift_B{B}_L{L}_d{d}"
        meta = dict(op="gram", B=B, L=L, d=d, static_kernel="rbf")

        def f(x, y):
            return sigkernel_gram(x, y, static_kernel=kernel, symmetric=False)

        entries.append(_timed(f"{tag}_gram", f, (X, Y), repeats, **meta)[0])
        entries.append(_timed(f"{tag}_gram_grad", _grad(f), (X, Y), repeats, **meta)[0])

        # oracle: Δ as the double increment of the pointwise RBF Gram,
        # solved pairwise by the reference row scan
        G = kernel.gram(X[:, None], Y[None, :])
        K_oracle = solve_goursat(delta_from_gram(G))
        np.testing.assert_allclose(_np(f(X, Y)), _np(K_oracle), rtol=5e-4, atol=1e-5,
                                   err_msg="rbf lift disagrees with oracle")
        entries.append(_chk(f"{tag}_agreement", **meta))
    return entries


# ---------------------------------------------------------------------------
# ragged Gram — variable-length (lengths=) batches through the Gram engine;
# timed per usable backend and agreement-checked against the per-path
# truncated oracle
# ---------------------------------------------------------------------------

_RAGGED_CELLS = {
    "smoke": [(4, 12, 3)],
    "quick": [(8, 32, 4)],
    "full": [(32, 128, 8)],
}


def _ragged_lengths(batch: int, points: int) -> np.ndarray:
    """Deterministic length spread [~P/2, P] (the JAX package's
    ``autotune._ragged_lengths``)."""
    lo = max(2, points // 2)
    return np.linspace(lo, points, batch).round().astype("int32")


def _ragged_spread(B: int, L: int, device, reverse: bool = False) -> torch.Tensor:
    lens = _ragged_lengths(B, L)
    return torch.as_tensor(lens[::-1].copy() if reverse else lens, device=device)


def ragged_gram(mode: str = "smoke", repeats: int = 3, *, device="cuda") -> List[dict]:
    cfg = TransformPipeline(time_aug=True)
    entries = []
    for (B, L, d) in _RAGGED_CELLS[_check_mode(mode)]:
        X = _paths(6, B, L, d, 0.1, device)
        Y = _paths(7, B, L, d, 0.1, device)
        lx = _ragged_spread(B, L, device)
        ly = _ragged_spread(B, L, device, reverse=True)
        tag = f"ragged_gram_B{B}_L{L}_d{d}"
        meta = dict(op="gram", B=B, L=L, d=d, ragged=True)

        t_ref = None
        for b in _usable_gram_backends(device):
            e, t = _timed(f"{tag}_{b}",
                          lambda x, y, b=b: sigkernel_gram(
                              x, y, backend=b, transforms=cfg, symmetric=False,
                              lengths=lx, lengths_y=ly),
                          (X, Y), repeats, _vs("speedup_vs_reference", t_ref),
                          backend=b, **meta)
            entries.append(e)
            if b == "reference":
                t_ref = t
        entries.append(_timed(f"{tag}_grad", _grad(lambda x, y: sigkernel_gram(
            x, y, transforms=cfg, symmetric=False, lengths=lx, lengths_y=ly)),
            (X, Y), repeats, **meta)[0])
        entries.append(_timed(f"{tag}_symmetric", lambda x: sigkernel_gram(
            x, transforms=cfg, lengths=lx), (X,), repeats, **meta)[0])

        # agreement vs the per-path truncated oracle on a sampled pair set,
        # through every exact backend that runs here
        lx_np, ly_np = _np(lx), _np(ly)
        pairs = [(i, (i + 1) % B) for i in range(min(B, 4))]
        for b in _exact_gram_backends(device):
            K = sigkernel_gram(X, Y, backend=b, transforms=cfg, symmetric=False,
                               lengths=lx, lengths_y=ly)
            for (i, j) in pairs:
                want = sigkernel_gram(
                    X[i:i + 1, :lx_np[i]], Y[j:j + 1, :ly_np[j]],
                    backend=b, transforms=cfg, symmetric=False)
                np.testing.assert_allclose(
                    float(K[i, j]), float(want[0, 0]), rtol=1e-6,
                    err_msg=f"ragged gram {b} disagrees with truncated "
                            f"oracle at pair ({i},{j})")
            entries.append(_chk(f"{tag}_agreement_{b}", backend=b, **meta))
    return entries


# ---------------------------------------------------------------------------
# distributed / streaming Gram — streaming reduce vs dense sum (timed +
# agreement-checked, forward and gradient), plus the sharded Gram on local
# process groups of 1, 2 and 4 ranks (NCCL on the card, one rank a card;
# gloo on the CPU) held to the dense Gram.  The group's wall clock includes
# process start-up, so its timing entry is gate=False.
# ---------------------------------------------------------------------------

_DISTGRAM_CELLS = {
    "smoke": [(6, 12, 3, 2)],
    "quick": [(16, 32, 4, 4)],
    "full": [(64, 128, 8, 8)],
}

#: world sizes of the mesh-invariance check, where the host has them
_MESH_WORLDS = (1, 2, 4)
_MESH_TIMEOUT = 600.0


def _mesh_worlds(device) -> Tuple[str, Tuple[int, ...]]:
    """(process-group backend, world sizes) this host can form: one NCCL
    rank a card on the card (never gloo there), gloo CPU processes off it."""
    import torch.distributed as dist
    if not dist.is_available():
        return "", ()
    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count() if dist.is_nccl_available() else 0
        return "nccl", tuple(w for w in _MESH_WORLDS if w <= n)
    n = (os.cpu_count() or 1) if dist.is_gloo_available() else 0
    return "gloo", tuple(w for w in _MESH_WORLDS if w <= n)


def _mesh_rank(rank: int, world: int, B: int, L: int, d: int) -> dict:
    """One rank of the mesh-invariance check: the sharded Gram (asymmetric
    and symmetric) on this group's mesh against the dense one."""
    import torch.distributed as dist
    from repro_torch.launch import make_gram_mesh
    device = torch.device("cuda", rank) if dist.get_backend() == "nccl" else "cpu"
    X = _paths(0, B, L, d, 0.1, device)
    Y = _paths(1, B + 1, L, d, 0.1, device)
    want = sigkernel_gram(X, Y, symmetric=False)
    mesh = make_gram_mesh()
    K = sigkernel_gram_sharded(X, Y, mesh=mesh)
    np.testing.assert_allclose(_np(K), _np(want), rtol=1e-5, atol=1e-6)
    Ks = _np(sigkernel_gram_sharded(X, mesh=mesh))
    np.testing.assert_allclose(Ks, Ks.T, rtol=1e-6, atol=1e-7)
    return {"mesh": list(mesh.shape)}


def distributed_gram(mode: str = "smoke", repeats: int = 3, *,
                     device="cuda") -> List[dict]:
    entries = []
    for (B, L, d, rb) in _DISTGRAM_CELLS[_check_mode(mode)]:
        X = _paths(8, B, L, d, 0.1, device)
        Y = _paths(9, B, L, d, 0.1, device)
        tag = f"distgram_B{B}_L{L}_d{d}"
        meta = dict(op="gram_reduce", B=B, L=L, d=d, row_block=rb)

        def f_dense(x, y):
            return sigkernel_gram(x, y, symmetric=False).sum()

        def f_stream(x, y):
            return sigkernel_gram_reduce(x, y, row_block=rb)

        def f_sym(x):
            return sigkernel_gram_reduce(x, row_block=rb)

        g_stream = _grad(f_stream, argnums=(0, 1))
        e, t_dense = _timed(f"{tag}_reduce_dense", f_dense, (X, Y), repeats, **meta)
        entries.append(e)
        entries.append(_timed(f"{tag}_reduce_stream", f_stream, (X, Y), repeats,
                              _vs("vs_dense", t_dense), **meta)[0])
        entries.append(_timed(f"{tag}_reduce_stream_grad", g_stream, (X, Y), repeats,
                              **meta)[0])
        # symmetric streaming: upper-triangle pairs with 2/1/0 weights
        entries.append(_timed(f"{tag}_reduce_stream_symmetric", f_sym, (X,), repeats,
                              **meta)[0])

        # agreement: streaming == dense oracle, values and gradients
        np.testing.assert_allclose(
            float(f_stream(X, Y)), float(f_dense(X, Y)), rtol=1e-5,
            err_msg="streaming reduce disagrees with dense sum")
        gx, _ = g_stream(X, Y)
        gx_d, = _grad(lambda x: sigkernel_gram(x, Y, symmetric=False))(X)
        np.testing.assert_allclose(_np(gx), _np(gx_d), rtol=1e-4, atol=1e-6,
                                   err_msg="streaming grad disagrees")
        np.testing.assert_allclose(
            float(f_sym(X)), float(sigkernel_gram(X).sum()), rtol=1e-5,
            err_msg="symmetric streaming reduce disagrees")
        entries.append(_chk(f"{tag}_agreement", **meta))

    # the sharded Gram on a local group of each world size this host can
    # form: every rank's Gram against the dense one.  Wall clock includes
    # process start-up — informative, never gated.
    B, L, d, _ = _DISTGRAM_CELLS[_check_mode(mode)][0]
    mesh_meta = dict(op="gram_sharded", B=B, L=L, d=d)
    backend, worlds = _mesh_worlds(device)
    if not worlds:
        # a host that cannot form the group is an environment limit, not a
        # regression — record it visibly but never gate on it
        entries.append(_chk("distgram_mesh_invariance",
                            f"skipped: no {backend or 'torch.distributed'} group on "
                            f"{torch.device(device).type}", gate=False, **mesh_meta))
        return entries
    from repro_torch.launch import spawn_ranks
    t0 = time.perf_counter()
    meshes = [spawn_ranks(_mesh_rank, w, (B, L, d), backend=backend,
                          timeout=_MESH_TIMEOUT)[0]["mesh"] for w in worlds]
    entries.append(_t("distgram_mesh_invariance_wall", time.perf_counter() - t0,
                      f"{backend} ranks {list(worlds)} (meshes {meshes}) sharded == "
                      f"dense (spawned)", gate=False, **mesh_meta))
    entries.append(_chk("distgram_mesh_invariance", **mesh_meta))
    return entries


# ---------------------------------------------------------------------------
# Table 3 — log-signatures: epilogue cost per mode + compression ratio
# ---------------------------------------------------------------------------

_TABLE3_CELLS = {
    "smoke": [(4, 32, 3, 3)],
    "quick": [(16, 64, 4, 6), (16, 128, 8, 5), (16, 256, 16, 4)],
    "full": [(128, 256, 4, 6), (128, 512, 8, 5), (128, 1024, 16, 4)],
}

_LOGSIG_MODES = ("lyndon", "brackets", "expand")


def table3_logsignatures(mode: str = "quick", repeats: int = 5, *,
                         device="cuda") -> List[dict]:
    entries = []
    for (B, L, d, N) in _TABLE3_CELLS[_check_mode(mode)]:
        path = _paths(0, B, L, d, 0.2, device)
        tag = f"table3_B{B}_L{L}_d{d}_N{N}"
        meta = dict(op="logsignature", B=B, L=L, d=d, depth=N)
        ratio = f"compress={logsig_dim(d, N)}/{sig_dim(d, N)}"

        e, t_sig = _timed(f"{tag}_signature", lambda p: signature(p, N, backend="reference"),
                          (path,), repeats, lambda t: ratio, **meta)
        entries.append(e)
        for lmode in _LOGSIG_MODES:
            entries.append(_timed(
                f"{tag}_logsig_{lmode}",
                lambda p, m=lmode: logsignature(p, N, mode=m, backend="reference"),
                (path,), repeats, lambda t: f"epilogue_x{t / max(t_sig, 1e-12):.2f}",
                **meta)[0])
        entries.append(_timed(f"{tag}_logsig_grad",
                              _grad(lambda p: logsignature(p, N, backend="reference")),
                              (path,), repeats, **meta)[0])
    return entries


# ---------------------------------------------------------------------------
# Figure 1 / Figure 2 sweeps — runtime vs truncation level / stream length
# ---------------------------------------------------------------------------

_FIG1_CELLS = {"quick": (8, 128, 5), "full": (32, 1024, 5)}
_FIG1_DEPTHS = range(2, 8)
_FIG2_CELLS = {"quick": ((8, 5), [32, 64, 128, 256]),
               "full": ((32, 5), [128, 256, 512, 1024, 2048])}


def fig1_truncation_sweep(mode: str = "quick", repeats: int = 3, *,
                          device="cuda") -> List[dict]:
    """Signature runtime vs truncation level (paper: B=32, L=1024, d=5)."""
    if _check_mode(mode) == "smoke":
        return []
    B, L, d = _FIG1_CELLS[mode]
    path = _paths(0, B, L, d, 0.2, device)
    entries = []
    for N in _FIG1_DEPTHS:
        meta = dict(op="signature", B=B, L=L, d=d, depth=N)
        t_d = timer.bench(lambda p: signature_direct(p, N), path, repeats=repeats)
        entries.append(_timed(f"fig1_N{N}_fwd_horner",
                              lambda p: signature(p, N, backend="reference"), (path,),
                              repeats, lambda t: f"direct/horner={t_d / t:.2f}", **meta)[0])
        entries.append(_timed(f"fig1_N{N}_bwd",
                              _grad(lambda p: signature(p, N, backend="reference")),
                              (path,), repeats, **meta)[0])
    return entries


def fig2_length_sweep(mode: str = "quick", repeats: int = 3, *,
                      device="cuda") -> List[dict]:
    """Sig-kernel runtime vs stream length (paper: B=32, d=5)."""
    if _check_mode(mode) == "smoke":
        return []
    (B, d), lengths = _FIG2_CELLS[mode]
    entries = []
    for L in lengths:
        kx = _paths(0, B, L, d, 0.1, device)
        ky = _paths(1, B, L, d, 0.1, device)
        meta = dict(op="sigkernel", B=B, L=L, d=d)
        entries.append(_timed(f"fig2_L{L}_fwd",
                              lambda x, y: solve_goursat_antidiag(delta_matrix(x, y)),
                              (kx, ky), repeats, lambda t: f"per_pair_us={t / B * 1e6:.1f}",
                              **meta)[0])
        entries.append(_timed(f"fig2_L{L}_bwd_exact", _grad(sigkernel), (kx, ky),
                              repeats, **meta)[0])
    return entries


# ---------------------------------------------------------------------------
# §3.4 gradient accuracy — exact one-pass backward vs the second-PDE
# approximation of [30]
# ---------------------------------------------------------------------------

_GRADACC_CELLS = {
    "smoke": ([4, 8], [0, 1]),
    "quick": ([4, 8, 16], [0, 1]),
    "full": ([4, 8, 16, 32, 64], [0, 1, 2]),
}


def grad_accuracy(mode: str = "quick", repeats: int = 0, *, device="cuda") -> List[dict]:
    del repeats  # deterministic accuracy study, nothing to repeat
    lengths, lams = _GRADACC_CELLS[_check_mode(mode)]
    entries = []
    for L in lengths:
        for lam in lams:
            x = _paths(0, 4, L, 3, 0.3, device)
            y = _paths(1, 4, L, 3, 0.3, device)
            delta = delta_matrix(x, y)
            grid = solve_goursat(delta, lam, lam, return_grid=True)
            gbar = torch.ones(delta.shape[:-2], device=device)
            d_true, = _grad(lambda dl: solve_goursat(dl, lam, lam))(delta)
            d_exact = solve_goursat_grad(delta, grid, gbar, lam, lam)
            d_approx = solve_goursat_grad_pde_approx(delta, grid, gbar, lam, lam)
            scale = float(d_true.abs().max())
            e_exact = float((d_exact - d_true).abs().max()) / scale
            e_approx = float((d_approx - d_true).abs().max()) / scale
            meta = dict(op="sigkernel_grad", L=L, lam=lam)
            entries.append(_acc(f"gradacc_L{L}_lam{lam}_exact", e_exact,
                                f"rel_err={e_exact:.2e}", **meta))
            entries.append(_acc(
                f"gradacc_L{L}_lam{lam}_pde_approx", e_approx,
                f"rel_err={e_approx:.2e}", gate=False, **meta))
    return entries


# ---------------------------------------------------------------------------
# smoke checks — tiny shapes through every exact backend that runs here
# (forward + grad + the symmetric pair-solve budget) and the feature maps;
# any dispatch regression fails here in seconds.  Correctness only.
# ---------------------------------------------------------------------------

_SMOKE_FEATURES = ("rff", "nystroem")


def _sigkernel_backends(device) -> List[str]:
    on_card = torch.device(device).type == "cuda"
    return [b for b in dispatch.backends_for("sigkernel")
            if on_card or not dispatch.get(b).needs_cuda]


def smoke_checks(mode: str = "smoke", repeats: int = 1, *, device="cuda") -> List[dict]:
    del mode, repeats
    B, L, d = 3, 8, 2
    X = _paths(0, B, L, d, 0.1, device)
    Y = _paths(1, B, L, d, 0.1, device)
    entries = []
    K_ref = _np(sigkernel_gram(X, Y, backend="reference", symmetric=False))
    for b in _exact_gram_backends(device):
        K = sigkernel_gram(X, Y, backend=b, symmetric=False)
        np.testing.assert_allclose(_np(K), K_ref, rtol=5e-4, atol=1e-5,
                                   err_msg=f"smoke: {b} disagrees")
        g, = _grad(lambda q: sigkernel_gram(q, Y, backend=b, symmetric=False))(X)
        assert bool(torch.isfinite(g).all()), f"smoke: {b} grad not finite"
        entries.append(_chk(f"smoke_gram_{b}", backend=b))
    # approximate feature-map backends: finite + in the right ballpark of
    # the exact Gram, with a differentiable path and — for rff — zero PDE
    # pair-solves
    for b, feats in zip(_SMOKE_FEATURES, (FeatureConfig("rff", rank=128, depth=4),
                                          FeatureConfig("nystroem", rank=B))):
        with dispatch.count_pair_solves() as c:
            Ka = sigkernel_gram(X, Y, backend=b, symmetric=False, features=feats)
        rel = float(np.abs(_np(Ka) - K_ref).max() / np.abs(K_ref).max())
        assert rel < 0.5, f"smoke: {b} rel err {rel:.2f} out of ballpark"
        if b == "rff":
            assert c.total == 0, f"smoke: rff issued {c.total} PDE solves"
        ga, = _grad(lambda q: sigkernel_gram(q, Y, backend=b, symmetric=False,
                                             features=feats))(X)
        assert bool(torch.isfinite(ga).all()), f"smoke: {b} grad not finite"
        entries.append(_chk(f"smoke_gram_{b}", f"rel_err={rel:.2e};solves={c.total}",
                            backend=b))
    # the symmetric pair-solve budget, through B4 on the card
    sym_backend = "gpu_fused" if torch.device(device).type == "cuda" else "auto"
    with dispatch.count_pair_solves() as c:
        sigkernel_gram(X, backend=sym_backend)
    budget = B * (B + 1) // 2
    assert c.total <= budget, (c.total, budget)
    entries.append(_chk("smoke_symmetric_pair_solves",
                        f"solves={c.total}<=budget={budget};backend={sym_backend}"))
    k_ref = _np(sigkernel(X, Y, backend="reference"))
    for b in _sigkernel_backends(device):
        np.testing.assert_allclose(
            _np(sigkernel(X, Y, backend=b)), k_ref, rtol=5e-4, atol=1e-5,
            err_msg=f"smoke: sigkernel {b} disagrees")
        entries.append(_chk(f"smoke_sigkernel_{b}", backend=b))
    return entries


# ---------------------------------------------------------------------------
# accuracy-vs-speed frontier — the approximate feature-map backends (rff /
# nystroem) over rank, each point timed and held to the exact Gram, persisted
# by autotune.tune_frontier so backend="auto" + error_budget= can take the
# cheapest one that fits
# ---------------------------------------------------------------------------

#: (gram key shape, rank sweep) per mode, as autotune.key_shape documents it:
#: (Bx, By, nx, ny, d)
_FRONTIER_CELLS = {
    "smoke": ((4, 4, 12, 12, 3), (8, 32)),
    "quick": ((8, 8, 32, 32, 4), (8, 32, 128)),
    "full": ((32, 32, 128, 128, 8), (32, 128, 512)),
}


def approx_frontier(mode: str = "smoke", repeats: int = 3, *,
                    device="cuda") -> List[dict]:
    """One timed and one accuracy entry a (method, rank); the timings are
    ``gate=False`` (fixed overheads dominate at bench shapes), the errors
    gated (the maps are deterministic given their seed).  The sweep persists
    the frontier (``force=True``), arming
    :func:`repro_torch.core.dispatch.resolve_approx` for this key."""
    shape, ranks = _FRONTIER_CELLS[_check_mode(mode)]
    entry = autotune.tune_frontier("gram", shape, device=device, ranks=ranks,
                                   repeats=repeats, force=True)
    meta = dict(op="gram", shape=list(autotune.key_shape("gram", shape)))
    entries = [_t("approx_frontier_exact", entry["exact_seconds"],
                  f"backend={entry['exact_backend']}", gate=False, **meta)]
    for p in entry["frontier"]:
        tag = f"approx_frontier_{p['backend']}_r{p['rank']}"
        entries.append(_t(f"{tag}_time", p["seconds"],
                          f"vs_exact={entry['exact_seconds'] / p['seconds']:.2f}x",
                          gate=False, backend=p["backend"], rank=p["rank"], **meta))
        entries.append(_acc(f"{tag}_rel_err", p["rel_err"], f"rel_err={p['rel_err']:.2e}",
                            backend=p["backend"], rank=p["rank"], **meta))
    # the budget's round trip on the fresh frontier; at small shapes no point
    # may beat the exact engine, and None is then the right answer
    found = autotune.lookup_budget("gram", shape, "float32", 0.5, device=device)
    entries.append(_chk("approx_frontier_budget_lookup", f"budget=0.5->{found}",
                        gate=False, **meta))
    return entries


# ---------------------------------------------------------------------------
# discretisation frontier — stencil order × grid coarseness × interior
# precision of the EXACT engine, each point timed and held to the order-1
# fine-grid f32 Gram, persisted by autotune.tune_scheme_frontier
# ---------------------------------------------------------------------------

#: gram key shape per mode, as autotune.key_shape documents it
_SCHEME_CELLS = {
    "smoke": (4, 4, 12, 12, 3),
    "quick": (8, 8, 32, 32, 4),
    "full": (16, 16, 128, 128, 8),
}

#: order 2 on the 2x-coarser grid must match the order-1 fine-grid Gram
#: within this relative Frobenius error
_SCHEME_COARSE_BUDGET = 0.05


def _scheme_tag(sch: str, coarsen: int, idt: str) -> str:
    return f"scheme_frontier_{sch}_c{coarsen}_{'bf16' if idt == 'bfloat16' else 'f32'}"


def scheme_frontier(mode: str = "smoke", repeats: int = 3, *,
                    device="cuda") -> List[dict]:
    """One timed and one accuracy entry a discretisation (timings
    ``gate=False``, errors gated), and the hard in-run assert that order 2
    on the 2x-coarser grid stays within :data:`_SCHEME_COARSE_BUDGET` of
    the order-1 fine grid.  The sweep persists the frontier, arming
    :func:`repro_torch.core.dispatch.resolve_scheme` for this key."""
    shape = _SCHEME_CELLS[_check_mode(mode)]
    entry = autotune.tune_scheme_frontier("gram", shape, device=device, repeats=repeats,
                                          force=True)
    meta = dict(op="gram", shape=list(autotune.key_shape("gram", shape)))
    entries = [_t("scheme_frontier_exact", entry["exact_seconds"],
                  f"backend={entry['exact_backend']}", gate=False, **meta)]
    coarse_o2 = None
    for p in entry["scheme_frontier"]:
        point = dict(scheme=p["scheme"], coarsen=p["coarsen"],
                     interior_dtype=p["interior_dtype"])
        tag = _scheme_tag(p["scheme"], p["coarsen"], p["interior_dtype"])
        entries.append(_t(f"{tag}_time", p["seconds"],
                          f"vs_exact={entry['exact_seconds'] / p['seconds']:.2f}x",
                          gate=False, **point, **meta))
        entries.append(_acc(f"{tag}_rel_err", p["rel_err"], f"rel_err={p['rel_err']:.2e}",
                            **point, **meta))
        if (p["scheme"], p["coarsen"], p["interior_dtype"]) == ("order2", 1, "float32"):
            coarse_o2 = p
    assert coarse_o2 is not None, "order2/coarsen=1/f32 point did not run"
    assert coarse_o2["rel_err"] <= _SCHEME_COARSE_BUDGET, (
        f"order-2 on the 2x-coarser grid misses the order-1 fine baseline by "
        f"rel_err={coarse_o2['rel_err']:.2e} (budget {_SCHEME_COARSE_BUDGET})")
    entries.append(_chk("scheme_frontier_order2_coarse_budget",
                        f"rel_err={coarse_o2['rel_err']:.2e}<={_SCHEME_COARSE_BUDGET}",
                        **meta))
    found = autotune.lookup_scheme_budget("gram", shape, "float32", _SCHEME_COARSE_BUDGET,
                                          device=device)
    entries.append(_chk("scheme_frontier_budget_lookup",
                        f"budget={_SCHEME_COARSE_BUDGET}->{found}", gate=False, **meta))
    return entries


# ---------------------------------------------------------------------------
# autotune round trip — tune the smoke shapes, then check that
# backend="auto" on a warm cache is never slower than the worst fixed backend
# ---------------------------------------------------------------------------

#: per-op key shapes the smoke suite tunes (see autotune.key_shape)
_AUTOTUNE_SMOKE_SHAPES = {
    "sigkernel": (24, 24, 3),
    "gram": (4, 4, 12, 12, 3),
}


def autotune_auto(mode: str = "smoke", repeats: int = 2, *, device="cuda") -> List[dict]:
    del mode
    if not autotune.enabled():
        return [_chk("autotune_disabled", "REPRO_DISABLE_AUTOTUNE set; skipped", gate=False)]
    entries = []
    for op, shape in _AUTOTUNE_SMOKE_SHAPES.items():
        winner = autotune.tune(op, shape, device=device, repeats=repeats, force=True)
        times = autotune.cache_entry(op, shape, device=device)["timings"]
        bshape = autotune.key_shape(op, shape)
        for b, t in sorted(times.items()):
            entries.append(_t(f"autotune_{op}_{b}", t, op=op, shape=list(bshape),
                              backend=b))
        if op == "gram":
            Bx, By, nx, ny, d = bshape
            Xa = _paths(7, Bx, nx + 1, d, 0.1, device)
            Ya = _paths(8, By, ny + 1, d, 0.1, device)

            def f(x, y):
                return sigkernel_gram(x, y, backend="auto", symmetric=False)
        else:
            nx, ny, d = bshape
            Xa = _paths(7, 8, nx + 1, d, 0.1, device)
            Ya = _paths(8, 8, ny + 1, d, 0.1, device)

            def f(x, y):
                return sigkernel(x, y, backend="auto")
        t_auto = timer.bench(f, Xa, Ya, repeats=repeats)
        worst = max(times.values())
        # warm-cache auto never loses to the worst fixed backend (2x + 5 ms
        # of slack for timer noise)
        assert t_auto <= worst * 2.0 + 5e-3, (
            f"auto ({t_auto * 1e6:.1f}us) slower than worst fixed backend "
            f"({worst * 1e6:.1f}us) for op={op} despite a warm cache")
        entries.append(_t(f"autotune_{op}_auto", t_auto,
                          f"winner={winner};worst_fixed={worst * 1e6:.1f}us",
                          op=op, shape=list(bshape)))
        entries.append(_chk(f"autotune_{op}_winner", f"winner={winner}", op=op))
    return entries


# ---------------------------------------------------------------------------
# streaming Path engine — incremental append+query vs full recompute
# ---------------------------------------------------------------------------

_PATH_CELLS = {
    "smoke": [(64, 3, 3)],
    "quick": [(256, 4, 4)],
    "full": [(1024, 4, 5), (4096, 3, 4)],
}


def path_update(mode: str = "smoke", repeats: int = 3, *, device="cuda") -> List[dict]:
    """Streaming serving pattern: one-tick append + full-signature query.

    ``incremental`` is the ``repro_torch.Path`` engine (O(chunk) scan + one
    Chen combine against the prefix store); ``full_recompute`` re-scans all
    L+1 points per tick.  The agreement entry pins the two to each other.
    The timed appends run at a pre-grown capacity.
    """
    entries = []
    for (L, d, N) in _PATH_CELLS[_check_mode(mode)]:
        pts = _paths(0, 1, L, d, 0.2, device)[0]
        tick = _paths(1, 1, 1, d, 0.2, device)[0]
        tag = f"path_update_L{L}_d{d}_N{N}"
        meta = dict(op="path_update", L=L, d=d, depth=N)

        base = Path.from_points(pts, N).update(tick)   # pre-grow + warm

        def append_query(p, t):
            return p.update(t).signature()

        e, t_inc = _timed(f"{tag}_incremental", append_query, (base, tick), repeats,
                          **meta)
        entries.append(e)
        full = torch.cat([pts, tick, tick])

        def f_full(pp):
            return signature(pp, N, backend="reference")

        entries.append(_timed(f"{tag}_full_recompute", f_full, (full,), repeats,
                              lambda t: f"speedup_incremental={t / t_inc:.2f}x",
                              **meta)[0])

        got = append_query(base, tick)
        want = f_full(full)
        denom = max(float(want.abs().max()), 1e-30)
        rel = float((got - want).abs().max()) / denom
        entries.append(_acc(f"{tag}_agreement", rel,
                            "incremental vs full recompute", **meta))
        assert rel < 5e-5, f"Path incremental drifted from recompute: {rel}"
    return entries


# ---------------------------------------------------------------------------
# the plan — every entry a mode writes, before it runs
# ---------------------------------------------------------------------------

def plan(mode: str, device="cuda") -> List[Tuple[str, str, dict]]:
    """(name, kind, meta) of every entry :func:`repro_torch.bench.suite.run_suite`
    writes for ``mode`` on ``device``, in run order, with the budget's
    skips as ``kind="check"`` — from the cell tables alone, nothing runs.
    The suite checks every run against it."""
    from .suite import WORKLOAD_SETS
    _check_mode(mode)
    out: List[Tuple[str, str, dict]] = []

    def timed(name, **meta):
        reason = over_budget(name, meta)
        out.append((name, "check", {"gate": False, **meta}) if reason else
                   (name, "time", meta))

    for fn in WORKLOAD_SETS[mode]:
        n = fn.__name__
        if n == "calibration":
            out.append(("calibration_matmul_scan", "time", {"gate": False}))
        elif n == "smoke_checks":
            out += [(f"smoke_gram_{b}", "check", {"backend": b})
                    for b in _exact_gram_backends(device)]
            out += [(f"smoke_gram_{b}", "check", {"backend": b}) for b in _SMOKE_FEATURES]
            out.append(("smoke_symmetric_pair_solves", "check", {}))
            out += [(f"smoke_sigkernel_{b}", "check", {"backend": b})
                    for b in _sigkernel_backends(device)]
        elif n == "autotune_auto":
            if not autotune.enabled():
                out.append(("autotune_disabled", "check", {"gate": False}))
                continue
            for op, shape in _AUTOTUNE_SMOKE_SHAPES.items():
                meta = dict(op=op, shape=list(autotune.key_shape(op, shape)))
                out += [(f"autotune_{op}_{b}", "time", {"backend": b, **meta})
                        for b in sorted(autotune.candidates(op, device))]
                out.append((f"autotune_{op}_auto", "time", meta))
                out.append((f"autotune_{op}_winner", "check", {"op": op}))
        elif n == "approx_frontier":
            shape, ranks = _FRONTIER_CELLS[mode]
            meta = dict(op="gram", shape=list(autotune.key_shape("gram", shape)))
            out.append(("approx_frontier_exact", "time", {"gate": False, **meta}))
            for b in (m for m in dispatch.backends_for("gram") if dispatch.get(m).approximate):
                for r in ranks:
                    tag, pm = f"approx_frontier_{b}_r{r}", dict(backend=b, rank=r, **meta)
                    out.append((f"{tag}_time", "time", {"gate": False, **pm}))
                    out.append((f"{tag}_rel_err", "accuracy", pm))
            out.append(("approx_frontier_budget_lookup", "check", {"gate": False, **meta}))
        elif n == "scheme_frontier":
            shape = _SCHEME_CELLS[mode]
            meta = dict(op="gram", shape=list(autotune.key_shape("gram", shape)))
            out.append(("scheme_frontier_exact", "time", {"gate": False, **meta}))
            for sch, c, idt in autotune.scheme_points(shape):
                tag = _scheme_tag(sch, c, idt)
                pm = dict(scheme=sch, coarsen=c, interior_dtype=idt, **meta)
                out.append((f"{tag}_time", "time", {"gate": False, **pm}))
                out.append((f"{tag}_rel_err", "accuracy", pm))
            out.append(("scheme_frontier_order2_coarse_budget", "check", meta))
            out.append(("scheme_frontier_budget_lookup", "check", {"gate": False, **meta}))
        elif n == "table1_signatures":
            for (B, L, d, N) in _TABLE1_CELLS[mode]:
                for s in ("fwd_direct", "fwd_horner", "bwd_autodiff", "bwd_timereversed"):
                    timed(f"table1_B{B}_L{L}_d{d}_N{N}_{s}", op="signature", B=B, L=L,
                          d=d, depth=N)
        elif n == "table2_sigkernels":
            for (B, L, d) in _TABLE2_CELLS[mode]:
                for s in ("fwd_rowscan", "fwd_wavefront", "bwd_autodiff", "bwd_exact_alg4"):
                    timed(f"table2_B{B}_L{L}_d{d}_{s}", op="sigkernel", B=B, L=L, d=d)
            for (B, L, d) in _GRAM_CELLS[mode]:
                for kind in ("dense", "symmetric"):
                    for b in _usable_gram_backends(device):
                        timed(f"table2_gram_B{B}_L{L}_d{d}_{kind}_{b}", backend=b, op="gram",
                              B=B, L=L, d=d)
        elif n == "rbf_lift":
            for (B, L, d) in _RBF_CELLS[mode]:
                meta = dict(op="gram", B=B, L=L, d=d, static_kernel="rbf")
                timed(f"rbf_lift_B{B}_L{L}_d{d}_gram", **meta)
                timed(f"rbf_lift_B{B}_L{L}_d{d}_gram_grad", **meta)
                out.append((f"rbf_lift_B{B}_L{L}_d{d}_agreement", "check", meta))
        elif n == "ragged_gram":
            for (B, L, d) in _RAGGED_CELLS[mode]:
                tag, meta = f"ragged_gram_B{B}_L{L}_d{d}", dict(op="gram", B=B, L=L, d=d,
                                                                 ragged=True)
                for b in _usable_gram_backends(device):
                    timed(f"{tag}_{b}", backend=b, **meta)
                timed(f"{tag}_grad", **meta)
                timed(f"{tag}_symmetric", **meta)
                out += [(f"{tag}_agreement_{b}", "check", {"backend": b, **meta})
                        for b in _exact_gram_backends(device)]
        elif n == "distributed_gram":
            for (B, L, d, rb) in _DISTGRAM_CELLS[mode]:
                meta = dict(op="gram_reduce", B=B, L=L, d=d, row_block=rb)
                for s in ("reduce_dense", "reduce_stream", "reduce_stream_grad",
                          "reduce_stream_symmetric"):
                    timed(f"distgram_B{B}_L{L}_d{d}_{s}", **meta)
                out.append((f"distgram_B{B}_L{L}_d{d}_agreement", "check", meta))
            B, L, d, _ = _DISTGRAM_CELLS[mode][0]
            meta = dict(op="gram_sharded", B=B, L=L, d=d)
            if _mesh_worlds(device)[1]:
                out.append(("distgram_mesh_invariance_wall", "time", {"gate": False, **meta}))
                out.append(("distgram_mesh_invariance", "check", meta))
            else:
                out.append(("distgram_mesh_invariance", "check", {"gate": False, **meta}))
        elif n == "path_update":
            for (L, d, N) in _PATH_CELLS[mode]:
                tag, meta = f"path_update_L{L}_d{d}_N{N}", dict(op="path_update", L=L, d=d,
                                                                 depth=N)
                timed(f"{tag}_incremental", **meta)
                timed(f"{tag}_full_recompute", **meta)
                out.append((f"{tag}_agreement", "accuracy", meta))
        elif n == "table3_logsignatures":
            for (B, L, d, N) in _TABLE3_CELLS[mode]:
                for s in ("signature",) + tuple(f"logsig_{m}" for m in _LOGSIG_MODES) + \
                        ("logsig_grad",):
                    timed(f"table3_B{B}_L{L}_d{d}_N{N}_{s}", op="logsignature", B=B, L=L,
                          d=d, depth=N)
        elif n == "fig1_truncation_sweep":
            B, L, d = _FIG1_CELLS[mode]
            for N in _FIG1_DEPTHS:
                for s in ("fwd_horner", "bwd"):
                    timed(f"fig1_N{N}_{s}", op="signature", B=B, L=L, d=d, depth=N)
        elif n == "fig2_length_sweep":
            (B, d), lengths = _FIG2_CELLS[mode]
            for L in lengths:
                for s in ("fwd", "bwd_exact"):
                    timed(f"fig2_L{L}_{s}", op="sigkernel", B=B, L=L, d=d)
        elif n == "grad_accuracy":
            lengths, lams = _GRADACC_CELLS[mode]
            for L in lengths:
                for lam in lams:
                    meta = dict(op="sigkernel_grad", L=L, lam=lam)
                    out.append((f"gradacc_L{L}_lam{lam}_exact", "accuracy", meta))
                    out.append((f"gradacc_L{L}_lam{lam}_pde_approx", "accuracy",
                                {"gate": False, **meta}))
        else:
            raise ValueError(f"plan has no entry list for workload {n!r}")
    return out
