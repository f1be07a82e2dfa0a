#!/usr/bin/env python3
"""Drive the PyTorch port's signature and signature-kernel paths, forward and
gradient, on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing runs without CUDA):

1. build the Goursat kernels (``src/repro_torch/kernels/sigkernel_pde/csrc``)
   and the Horner kernel (``src/repro_torch/kernels/signature/csrc``) with
   nvcc, both at once, and print the compilers' register / shared-memory
   reports;
2. drive the forward path through the public entry points at the paper's
   Table 2 "full" sizes, with every launch count set to 0 just before and
   read just after: ``sigkernel`` on (128, 1024, 32) paths (auto -> "gpu",
   and "gpu_fused"), ``SigKernel().gram(X, Y)``, the symmetric
   ``gram(X)``, ``mmd2`` and the RBF-lift Gram on (128, 256, 8) paths;
   results must be finite, the routes must agree, and every kernel of the
   path must have launched; the Goursat launches are also counted by shape
   (problems, Lx, Ly, d) and strip height;
3. drive the gradient path the same way, counts reset just before it:
   ``torch.autograd.grad`` of ``sigkernel(x, y).sum()`` on (128, 1024, 32)
   through auto ("gpu") and "gpu_fused", of ``SigKernel().mmd2(X, Y)`` and
   of the streaming ``mmd2(X, Y, row_block=16)`` on (128, 256, 8), a small
   input against the CPU reference gradient, and a trainer: five Adam steps
   on an ``nn.Parameter`` of (64, 256, 8) paths under the biased MMD² to
   fixed targets (ms/step; the loss must fall); launches counted by shape
   as on the forward path;
4. drive the signature path at the paper's Table 1 / Table 3 "full" sizes
   (B, L, d, N) = (128, 256, 4, 6), (128, 512, 8, 5), (128, 1024, 16, 4),
   the Horner count set to 0 just before and read just after:
   ``signature`` (auto -> "gpu") and ``Signature``, ``logsignature`` in its
   modes and ``LogSignature`` on each shape, two transform pipelines at the
   paper's depth 6 (time-aug + lead-lag makes d' = 9), ragged ``lengths=``,
   and ``stream=True`` on the first shape, with the Horner launches counted
   per kernel shape; checks: Chen's identity across a split, the kernel
   against the direct algorithm (Alg 1) on the card, and a small input
   against the CPU reference;
5. the signature gradient: ``torch.autograd.grad`` of ``signature(...)
   .sum()`` and ``logsignature(...).sum()`` at the three shapes, with time
   and peak memory; the §2.4 backward must keep a bounded number of
   (B, sig_dim) buffers, the same at L = 512 and L = 1024;
6. hold each kernel against its plain PyTorch version on the card: the
   Goursat kernels at B = 8, L = 128, d = 8 for every scheme, interior dtype
   and refinement in the sweep, plus strips that do not divide Lx, an nx >
   ny case and T = 2 (the checkpoint rows exactly, the backward to 1e-4);
   the Horner kernel over d in {1, 2, 3, 4, 8, 9, 16} and N in 2..6, at
   L = 2 and at a length that no length block divides (but (16, 6): L = 2
   only), an odd batch, a bf16 input and two launch settings, all exactly;
7. time each kernel and its plain version at the main paths' shapes
   (CUDA events, median), compute the bound (bytes / 3.35 TB/s vs
   operations / 67 TFLOP/s FP32, H100 SXM data sheet), sweep the forward
   kernels' strip height, the backward's with its checkpoint forward, and
   the Horner kernel's length block and prefix length (also at the two
   pipelines' kernel shapes), time every Goursat kernel at every shape it
   launched at on the forward and gradient paths against its bound (B4 and
   B3 also against their plain versions, rel <= 1e-4, with a strip sweep),
   and print one JSON line per kernel, the
   ``kernels`` line, the card's name and power limit, and the final ``ok``
   line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, FP32 outside the tensor cores
RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: flops per refined cell of the order-1 stencil: p·scale, A (5), B (3),
#: (left + up)·A − upleft·B (4)
CELL_FLOPS = 13
#: flops per refined cell of the order-1 backward kernel: the recompute (13)
#: and the adjoint: p·scale, A and B (5), g (2), g·A and g·B (2), A' (2),
#: the dΔ term (5), g·term (1), the fold (1)
BWD_CELL_FLOPS = 13 + 19

SOURCE = "src/repro_torch/kernels/sigkernel_pde/csrc/sigkernel_pde.cu"
REPLACES = {
    "fwd": "src/repro/kernels/sigkernel_pde/kernel.py:111",
    "fwd_cps": "src/repro/kernels/sigkernel_pde/kernel.py:134",
    "fwd_fused": "src/repro/kernels/sigkernel_pde/kernel.py:84",
    "gram_fused": "src/repro/kernels/sigkernel_pde/kernel.py:323",
    "bwd": "src/repro/kernels/sigkernel_pde/grad_kernel.py:62",
}
#: the kernels each driven path must launch
FORWARD_PATH = ("fwd", "fwd_fused", "gram_fused")
GRADIENT_PATH = ("fwd_cps", "bwd", "fwd_fused", "gram_fused")

SIG_SOURCE = "src/repro_torch/kernels/signature/csrc/signature.cu"
SIG_REPLACES = "src/repro/kernels/signature/kernel.py:48"
#: the paper's Table 1 / Table 3 "full" cells, (B, L, d, N)
#: (src/repro/bench/workloads.py:110-114, :475-479)
SIG_SHAPES = ((128, 256, 4, 6), (128, 512, 8, 5), (128, 1024, 16, 4))
#: the §2.4 backward's peak above its increments and gradients, in
#: (B, sig_dim) float32 buffers: O(1) in L (10-11.5 measured on an H100 at
#: the three shapes)
SIG_BWD_MAX_BUFFERS = 16


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def random_paths(rng, B, L, d):
    """Random walks whose signature kernels stay of order one."""
    steps = rng.normal(size=(B, L, d)) / np.sqrt(L * np.sqrt(d))
    return np.cumsum(steps, axis=1).astype(np.float32)


def rel_err(a, b) -> float:
    scale = float(b.abs().max().clamp_min(1e-30))
    return float((a - b).abs().max()) / scale


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def grads(fn, *inputs):
    """``torch.autograd.grad`` of fn(*leaves) at fresh leaves of the inputs."""
    import torch
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves)


def shape_rows(shapes) -> list:
    """kernel.launch_shapes() as JSON rows, most launches first."""
    return [{"kernel": k, "problems": list(P) if isinstance(P, tuple) else P, "Lx": Lx,
             "Ly": Ly, "d": d, "T": T, "launches": n}
            for (k, P, Lx, Ly, d, T), n in sorted(shapes.items(), key=lambda kv: -kv[1])]


def build_all(modules) -> dict:
    """Build every kernel library at once (one nvcc each); raise the first
    failure.  Returns {module: library path}."""
    done, errors = {}, []

    def run(mod):
        try:
            done[mod] = mod.build()
        except Exception as e:  # re-raised below, after every build ends
            errors.append(e)

    threads = [threading.Thread(target=run, args=(m,)) for m in modules]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    for mod in modules:
        mod.library()
    return done


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    try:
        import repro_torch as rt
        from repro_torch.kernels.sigkernel_pde import kernel, ops
        from repro_torch.kernels.signature import kernel as sig_kernel
        from repro_torch.kernels.signature import ops as sig_ops
        from repro_torch.kernels.signature import ref as sig_ref
        from repro_torch.core.sigkernel import delta_matrix
        from repro_torch.core import tensoralg as ta
        from repro_torch.core import transforms as tf
    except ImportError as e:
        print(f"chip_smoke: the repo's src/repro_torch is missing ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    def reset_all():
        """Every kernel's launch count to 0, just before a driven path."""
        kernel.reset_launch_counts()
        sig_kernel.reset_launch_counts()

    card = card_line()
    name, power = [s.strip() for s in card.split(",", 1)]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ----------------------------------------------------------
    t = time.time()
    libs = build_all((kernel, sig_kernel))
    print(f"build: {time.time() - t:.1f} s (both at once)")
    for lib_path in libs.values():
        print(f"  -> {os.path.relpath(lib_path, ROOT)}")
        log = (lib_path.parent / "nvcc.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    # ---- 2. the main path at full width ------------------------------------
    rng = np.random.default_rng(0)
    x = torch.from_numpy(random_paths(rng, 128, 1024, 32)).to(dev)
    y = torch.from_numpy(random_paths(rng, 128, 1024, 32)).to(dev)
    X = torch.from_numpy(random_paths(rng, 128, 256, 8)).to(dev)
    Y = torch.from_numpy(random_paths(rng, 128, 256, 8)).to(dev)

    reset_all()
    t_path = time.time()
    steps = []

    def step(what, fn, launcher):
        before = launcher.launches
        out = fn()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{what}: non-finite values")
        check(launcher.launches > before, f"{what}: {launcher.__name__} did not launch")
        steps.append({"call": what, "kernel": launcher.__name__,
                      "launches": launcher.launches - before,
                      "shape": list(out.shape)})
        return out

    k_gpu = step("sigkernel(x, y)", lambda: rt.sigkernel(x, y), kernel.fwd)
    k_fused = step("sigkernel(x, y, backend='gpu_fused')",
                   lambda: rt.sigkernel(x, y, backend="gpu_fused"), kernel.fwd_fused)
    sk = rt.SigKernel()
    K = step("SigKernel().gram(X, Y)", lambda: sk.gram(X, Y), kernel.gram_fused)
    K_gpu = step("SigKernel(backend='gpu').gram(X, Y)",
                 lambda: rt.SigKernel(backend="gpu").gram(X, Y), kernel.fwd)
    Kxx = step("SigKernel().gram(X)", lambda: sk.gram(X), kernel.fwd_fused)
    Kxx_dense = step("SigKernel().gram(X, X)", lambda: sk.gram(X, X), kernel.gram_fused)
    Kyy = step("SigKernel().gram(Y)", lambda: sk.gram(Y), kernel.fwd_fused)
    m = step("SigKernel().mmd2(X, Y)", lambda: sk.mmd2(X, Y), kernel.gram_fused)
    rbf = rt.SigKernel(static_kernel=rt.RBF(1.0))
    K_rbf = step("SigKernel(static_kernel=RBF(1.0)).gram(X, Y, row_block=16)",
                 lambda: rbf.gram(X, Y, row_block=16), kernel.fwd)
    path_s = time.time() - t_path
    counts = kernel.launch_counts()
    shapes_fwd = kernel.launch_shapes()
    for kname in FORWARD_PATH:
        check(counts[kname] > 0, f"forward path never launched {kname}")

    check(rel_err(k_fused, k_gpu) <= 1e-4, "sigkernel: gpu and gpu_fused disagree")
    check(rel_err(K, K_gpu) <= 1e-4, "gram: gpu_fused and gpu disagree")
    check(rel_err(Kxx, Kxx_dense) <= 1e-4, "gram: symmetric pairs and dense disagree")
    b = X.shape[0]
    m_ref = ((Kxx.sum() - Kxx.trace()) / (b * (b - 1))
             + (Kyy.sum() - Kyy.trace()) / (b * (b - 1)) - 2.0 * K.mean())
    check(abs(float(m) - float(m_ref)) <= 1e-4 * float(K.abs().max()),
          "mmd2 disagrees with its Gram terms")
    # the same RBF-lift block through the plain wavefront on the card
    K_rbf_plain = rt.sigkernel_gram(X[:4], Y[:8], backend="antidiag",
                                    static_kernel=rt.RBF(1.0))
    check(rel_err(K_rbf[:4, :8], K_rbf_plain) <= 1e-4, "RBF gram disagrees with plain")
    # small input: the card's path against the CPU's plain solvers
    xs, ys = x[:4, :64, :4].cpu(), y[:4, :48, :4].cpu()
    small = rt.sigkernel(xs.to(dev), ys.to(dev)).cpu()
    check(rel_err(small, rt.sigkernel(xs, ys, backend="reference")) <= 1e-4,
          "small input: card and CPU reference disagree")
    emit({"main_path": steps, "launches": counts,
          "launches_by_shape": shape_rows(shapes_fwd), "seconds": round(path_s, 3),
          "sigkernel_gpu_vs_fused_rel": rel_err(k_fused, k_gpu),
          "gram_fused_vs_gpu_rel": rel_err(K, K_gpu), "mmd2": float(m),
          "card": name, "power_limit": power})

    # ---- 3. the gradient path at full width, and a trainer -------------------
    reset_all()
    t_path = time.time()
    gsteps = []

    def gstep(what, fn):
        out = fn()
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in out), f"{what}: non-finite grads")
        gsteps.append({"call": what, "shapes": [list(g.shape) for g in out]})
        return out

    gk = gstep("grad sigkernel(x, y).sum()",
               lambda: grads(lambda a, b: rt.sigkernel(a, b).sum(), x, y))
    gk_fused = gstep("grad sigkernel(x, y, backend='gpu_fused').sum()",
                     lambda: grads(lambda a, b: rt.sigkernel(a, b, backend="gpu_fused").sum(),
                                   x, y))
    gm = gstep("grad SigKernel().mmd2(X, Y)", lambda: grads(sk.mmd2, X, Y))
    gm_stream = gstep("grad mmd2(X, Y, row_block=16)",
                      lambda: grads(lambda a, b: rt.mmd2(a, b, row_block=16), X, Y))
    # a small input: the card's gradient against the CPU reference's
    g_small = grads(lambda a, b: rt.sigkernel(a, b).sum(), xs.to(dev), ys.to(dev))
    g_small_ref = grads(lambda a, b: rt.sigkernel(a, b, backend="reference").sum(), xs, ys)

    # the trainer: Adam on generated paths under the biased MMD² to targets
    gen = torch.nn.Parameter(torch.from_numpy(random_paths(rng, 64, 256, 8)).to(dev))
    target = torch.from_numpy(random_paths(rng, 64, 256, 8) + 0.25).to(dev)
    opt = torch.optim.Adam([gen], lr=1e-2)
    losses, step_ms = [], []
    for _ in range(5):
        t0 = time.time()
        opt.zero_grad()
        loss = rt.mmd2(gen, target, unbiased=False)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        losses.append(float(loss.detach()))
    with torch.no_grad():
        losses.append(float(rt.mmd2(gen, target, unbiased=False)))
    gpath_s = time.time() - t_path
    gcounts = kernel.launch_counts()
    shapes_grad = kernel.launch_shapes()
    for kname in GRADIENT_PATH:
        check(gcounts[kname] > 0, f"gradient path never launched {kname}")

    grad_rel = {
        "sigkernel_gpu_vs_fused": max(rel_err(a, b) for a, b in zip(gk_fused, gk)),
        "mmd2_streaming_vs_dense": max(rel_err(a, b) for a, b in zip(gm_stream, gm)),
        "small_card_vs_cpu_reference": max(rel_err(a.cpu(), b)
                                           for a, b in zip(g_small, g_small_ref)),
    }
    for what, err in grad_rel.items():
        check(err <= 1e-4, f"gradients: {what} rel err {err:.3g} > 1e-4")
    check(all(np.isfinite(losses)), f"trainer: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"trainer: the loss did not fall {losses}")
    emit({"gradient_path": gsteps, "launches": gcounts,
          "launches_by_shape": shape_rows(shapes_grad), "seconds": round(gpath_s, 3),
          "grad_rel_err": grad_rel, "trainer_losses": losses,
          "trainer_ms_per_step": step_ms, "trainer_ms_per_step_median":
          float(np.median(step_ms)), "card": name, "power_limit": power})

    # ---- 4. the signature path at full width -------------------------------
    sig_x = {(d_, N_): torch.from_numpy(random_paths(rng, B_, L_, d_)).to(dev)
             for B_, L_, d_, N_ in SIG_SHAPES}
    x85 = sig_x[(8, 5)]
    ragged = torch.from_numpy(rng.integers(2, x85.shape[1] + 1, size=x85.shape[0]))
    pipelines = {
        "time_aug+basepoint, N=6": (rt.TransformPipeline(time_aug=True, basepoint=True), 6),
        "time_aug+lead_lag, N=6": (rt.TransformPipeline(time_aug=True, lead_lag=True), 6),
    }
    reset_all()
    t_path = time.time()
    ssteps = []

    by_shape = {}

    def sstep(what, fn, launches=True, kernel_dN=None):
        """kernel_dN: the (d, N) the kernel sees, where transforms change d."""
        before = sig_kernel.horner.launches
        out = fn()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{what}: non-finite values")
        if launches:
            check(sig_kernel.horner.launches > before, f"{what}: horner did not launch")
        n = sig_kernel.horner.launches - before
        key = "d={}, N={}".format(*(kernel_dN or dN))
        by_shape[key] = by_shape.get(key, 0) + n
        ssteps.append({"call": what, "launches": n, "shape": list(out.shape)})
        return out

    sigs = {}
    for B_, L_, d_, N_ in SIG_SHAPES:
        dN = (d_, N_)
        xs_ = sig_x[(d_, N_)]
        at = f"on ({B_}, {L_}, {d_})"
        sigs[(d_, N_)] = sstep(f"signature(x, {N_}) {at}", lambda: rt.signature(xs_, N_))
        S_mod = sstep(f"Signature({N_})(x) {at}", lambda: rt.Signature(N_)(xs_))
        check(torch.equal(S_mod, sigs[(d_, N_)]), f"Signature({N_}) disagrees with signature")
        # the brackets basis is a dense numpy inverse of logsig_dim² (the JAX
        # package's table): 17,816² at d = 16, N = 4 costs minutes of host time
        for mode in (("lyndon", "brackets", "expand") if d_ < 16 else ("lyndon", "expand")):
            sstep(f"logsignature(x, {N_}, mode={mode!r}) {at}",
                  lambda: rt.logsignature(xs_, N_, mode=mode))
        sstep(f"LogSignature({N_})(x) {at}", lambda: rt.LogSignature(N_)(xs_))
    x46 = sig_x[(4, 6)]
    for what, (pipe, N_) in pipelines.items():
        sstep(f"signature(x, {N_}, transforms={what}) on {tuple(x46.shape)}",
              lambda: rt.signature(x46, N_, transforms=pipe),
              kernel_dN=(pipe.transformed_dim(4), N_))
    dN = (8, 5)
    s_ragged = sstep(f"signature(x, 5, lengths=...) on {tuple(x85.shape)}",
                     lambda: rt.signature(x85, 5, lengths=ragged))
    dN = (4, 6)
    s_stream = sstep(f"signature(x, 6, stream=True) on {tuple(x46.shape)}",
                     lambda: rt.signature(x46, 6, stream=True), launches=False)
    halves = {}
    for B_, L_, d_, N_ in SIG_SHAPES:
        dN = (d_, N_)
        m_ = L_ // 2
        xs_ = sig_x[(d_, N_)]
        halves[(d_, N_)] = (
            sstep(f"signature(x[:, :{m_}], {N_})", lambda: rt.signature(xs_[:, :m_], N_)),
            sstep(f"signature(x[:, {m_ - 1}:], {N_})",
                  lambda: rt.signature(xs_[:, m_ - 1:], N_)))
    spath_s = time.time() - t_path
    scounts = sig_kernel.launch_counts()
    check(scounts["horner"] > 0, "signature path never launched horner")

    sig_rel = {}
    for B_, L_, d_, N_ in SIG_SHAPES:
        xs_, S_ = sig_x[(d_, N_)], sigs[(d_, N_)]
        combined = rt.signature_combine(*halves[(d_, N_)], d_, N_)
        sig_rel[f"combine d={d_} N={N_}"] = rel_err(combined, S_)
        # Alg 1 on the card, on 8 of the paths
        z8 = tf.pipeline_increments(xs_[:8], rt.TransformPipeline())
        sig_rel[f"direct d={d_} N={N_}"] = rel_err(S_[:8], sig_ref.signature_from_increments(
            z8, N_))
    sig_rel["stream last prefix"] = rel_err(s_stream[:, -1], sigs[(4, 6)])
    sig_rel["ragged vs reference"] = rel_err(
        s_ragged, rt.signature(x85, 5, lengths=ragged, backend="reference"))
    xs_small = x46[:4, :20, :3].cpu()
    for mode in ("lyndon", "brackets"):
        sig_rel[f"small logsignature {mode} card vs cpu"] = rel_err(
            rt.logsignature(xs_small.to(dev), 4, mode=mode).cpu(),
            rt.logsignature(xs_small, 4, mode=mode))
    sig_rel["small signature card vs cpu"] = rel_err(
        rt.signature(xs_small.to(dev), 5).cpu(), rt.signature(xs_small, 5))
    for what, err in sig_rel.items():
        check(err <= 1e-4, f"signature path: {what} rel err {err:.3g} > 1e-4")
    emit({"signature_path": ssteps, "launches": scounts, "horner_launches_by_shape": by_shape,
          "seconds": round(spath_s, 3), "rel_err": sig_rel, "card": name,
          "power_limit": power})

    # ---- 5. the signature gradient -----------------------------------------
    sig_x[(8, 5, 1024)] = torch.from_numpy(random_paths(rng, 128, 1024, 8)).to(dev)
    sgrads, bufs = [], {}
    for key, N_ in (((4, 6), 6), ((8, 5), 5), ((16, 4), 4), ((8, 5, 1024), 5)):
        xs_ = sig_x[key]
        B_, L_, d_ = xs_.shape
        sd = ta.sig_dim(d_, N_)
        for what, fn in (("signature", rt.signature), ("logsignature", rt.logsignature)):
            if len(key) == 3 and what == "logsignature":
                continue
            leaf = xs_.clone().requires_grad_()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.time()
            (g,) = torch.autograd.grad(fn(leaf, N_).sum(), leaf)
            torch.cuda.synchronize()
            secs = time.time() - t0
            check(bool(torch.isfinite(g).all()), f"grad {what}: non-finite")
            # above the increments, their gradient and the path's gradient
            extra = torch.cuda.max_memory_allocated() - base - 3 * xs_.numel() * 4
            bufs[(what, B_, L_, d_, N_)] = extra / (B_ * sd * 4)
            sgrads.append({"call": f"grad {what}(x, {N_}).sum()", "shape": [B_, L_, d_],
                           "seconds": round(secs, 3), "peak_extra_bytes": extra,
                           "peak_extra_sig_buffers": round(bufs[(what, B_, L_, d_, N_)], 3)})
    for k, v in bufs.items():
        check(v <= SIG_BWD_MAX_BUFFERS,
              f"grad {k}: backward peak {v:.1f} (B, sig_dim) buffers > {SIG_BWD_MAX_BUFFERS}")
    grow = (bufs[("signature", *sig_x[(8, 5, 1024)].shape, 5)]
            / bufs[("signature", *sig_x[(8, 5)].shape, 5)])
    check(grow < 1.5, f"signature backward memory grows with L: x{grow:.2f} from 512 to 1024")
    g_small = grads(lambda a: rt.logsignature(a, 4, mode="brackets").sum(), xs_small.to(dev))
    g_small_ref = grads(lambda a: rt.logsignature(a, 4, mode="brackets").sum(), xs_small)
    g_small_err = rel_err(g_small[0].cpu(), g_small_ref[0])
    check(g_small_err <= 1e-4, f"small logsignature gradient: card vs cpu {g_small_err:.3g}")
    emit({"signature_gradient": sgrads, "memory_growth_512_to_1024": grow,
          "small_grad_card_vs_cpu_rel": g_small_err, "card": name, "power_limit": power})

    # ---- 6. kernels against their plain versions ---------------------------
    cases = []
    for scheme in ("order1", "order2"):
        for idt in ("float32", "bfloat16"):
            for lam in ((0, 0), (1, 1), (2, 0)):
                cases.append((scheme, idt, lam, 128, 128, None))
    cases.append(("order2", "float32", (1, 1), 128, 128, 32))   # 32 ∤ Lx = 127
    cases.append(("order1", "float32", (0, 0), 128, 64, 16))    # nx > ny
    cases.append(("order2", "bfloat16", (1, 0), 128, 64, None))
    cases.append(("order2", "float32", (0, 1), 24, 17, 2))      # T = 2
    worst = {}
    for scheme, idt, (l1, l2), Lx_pts, Ly_pts, strip in cases:
        launch = rt.LaunchConfig(pde_strip=strip)
        a = torch.from_numpy(random_paths(rng, 8, Lx_pts, 8)).to(dev)
        c = torch.from_numpy(random_paths(rng, 8, Ly_pts, 8)).to(dev)
        da = tf.pipeline_increments(a, rt.TransformPipeline())
        dc = tf.pipeline_increments(c, rt.TransformPipeline())
        delta = delta_matrix(a, c)
        runs = [
            ("fwd", lambda: ops.solve(delta, l1, l2, launch, scheme, idt),
             lambda: kernel.solve_plain(delta, l1, l2, scheme, idt)),
            ("fwd_fused", lambda: ops.solve_fused(da, dc, l1, l2, launch, scheme, idt),
             lambda: kernel.solve_fused_plain(da, dc, l1, l2, scheme, idt)),
            ("gram_fused", lambda: ops.gram_fused(da, dc, l1, l2, launch, scheme, idt),
             lambda: kernel.gram_fused_plain(da, dc, l1, l2, scheme, idt)),
        ]
        T = ops.choose_T(delta.shape[1], delta.shape[2], l1, l2, 8, scheme=scheme,
                         max_t=strip, backward=True)
        gbar = torch.from_numpy(rng.normal(size=8).astype(np.float32)).to(dev)
        cps_k = kernel.fwd_cps(delta, T, l1, l2, scheme, idt)[1]
        cps_p = kernel.solve_with_grid_plain(delta, T, l1, l2, scheme, idt)[1]
        runs += [
            ("fwd_cps", lambda: kernel.fwd_cps(delta, T, l1, l2, scheme, idt)[0],
             lambda: kernel.solve_with_grid_plain(delta, T, l1, l2, scheme, idt)[0]),
            ("fwd_cps_rows", lambda: cps_k, lambda: cps_p),
            ("bwd", lambda: kernel.bwd(delta, cps_k, gbar, T, l1, l2, scheme, idt),
             lambda: kernel.solve_grad_plain(delta, cps_p, gbar, T, l1, l2, scheme, idt)),
        ]
        for kname, run_kernel, run_plain in runs:
            got = run_kernel()
            torch.cuda.synchronize()
            want = run_plain()
            torch.cuda.synchronize()
            err = rel_err(got, want)
            tol = {"fwd_cps_rows": 0.0, "bwd": 1e-4}.get(kname, RTOL[idt])
            tag = f"{kname} {scheme} {idt} lam={l1},{l2} L={Lx_pts}x{Ly_pts} strip={strip}"
            check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
            check(err <= tol, f"{tag}: rel err {err:.3g} > {tol}")
            worst[f"{kname}/{idt}"] = max(worst.get(f"{kname}/{idt}", 0.0), err)
    emit({"kernel_vs_plain": {"cases": len(cases) * len(runs), "worst_rel_err": worst,
                              "rtol": {**RTOL, "fwd_cps_rows": 0.0, "bwd": 1e-4}}})

    # the Horner kernel, exactly: L = 2 (one increment) and 69 increments
    # (no length block divides it; not at d = 16, N = 6, 17.9 M entries a
    # path), odd batches, two launch settings, a bf16 input
    hcases = [(d_, N_) for d_ in (1, 2, 3, 4, 8, 9, 16) for N_ in range(2, 7)]
    other = rt.LaunchConfig(sig_lb=8, sig_bt=64)
    n_h = 0
    for d_, N_ in hcases:
        for B_, L_ in ((3, 2), (5, 70))[:1 if (d_, N_) == (16, 6) else 2]:
            z_ = torch.from_numpy((rng.normal(size=(B_, L_ - 1, d_)) / np.sqrt(L_))
                                  .astype(np.float32)).to(dev)
            got = sig_ops.signature_from_increments(z_, N_)
            again = sig_ops.signature_from_increments(z_, N_, other)
            want = sig_kernel.horner_plain(z_, N_)
            torch.cuda.synchronize()
            tag = f"horner d={d_} N={N_} B={B_} L={L_}"
            check(torch.equal(got, want),
                  f"{tag}: differs from plain by {float((got - want).abs().max()):.3g}")
            check(torch.equal(got, again), f"{tag}: launch settings change the result")
            n_h += 1
    zb = torch.from_numpy(rng.normal(size=(5, 69, 4)) / 8).to(dev, torch.bfloat16)
    got = sig_ops.signature_from_increments(zb, 4)
    check(got.dtype == torch.bfloat16 and torch.equal(
        got, sig_kernel.horner_plain(zb.float(), 4).to(torch.bfloat16)), "horner bf16 input")
    emit({"horner_vs_plain": {"cases": n_h + 1, "shapes_dN": hcases, "equal": True,
                              "launch_settings": ["default", "sig_lb=8, sig_bt=64"]}})

    # ---- 7. timing at the main paths' shapes ------------------------------
    identity = rt.TransformPipeline()
    delta = delta_matrix(x, y)                                     # B1 input
    dx, dy = tf.pipeline_increments(x, identity), tf.pipeline_increments(y, identity)
    dX, dY = tf.pipeline_increments(X, identity), tf.pipeline_increments(Y, identity)
    B, Lx, Ly = delta.shape
    d = dx.shape[-1]
    Bx, Lgx, dg = dX.shape
    By, Lgy = dY.shape[0], dY.shape[1]
    T_grad = ops.choose_T(Lx, Ly, 0, 0, B, backward=True)
    cps = kernel.fwd_cps(delta, T_grad, 0, 0, "order1", "float32")[1]
    gbar = torch.from_numpy(rng.normal(size=B).astype(np.float32)).to(dev)
    work = {
        "fwd": (delta.numel() * 4 + B * 4, B * Lx * Ly * CELL_FLOPS),
        "fwd_cps": (delta.numel() * 4 + B * 4 + cps.numel() * 4, B * Lx * Ly * CELL_FLOPS),
        "bwd": (2 * delta.numel() * 4 + cps.numel() * 4 + B * 4,
                B * Lx * Ly * BWD_CELL_FLOPS),
        "fwd_fused": ((dx.numel() + dy.numel()) * 4 + B * 4,
                      B * (2 * d + CELL_FLOPS) * Lx * Ly),
        "gram_fused": ((dX.numel() + dY.numel()) * 4 + Bx * By * 4,
                       Bx * By * (2 * dg + CELL_FLOPS) * Lgx * Lgy),
    }
    default_T = {
        "fwd": ops.choose_T(Lx, Ly, 0, 0, B),
        "fwd_cps": T_grad,
        "bwd": T_grad,
        "fwd_fused": ops.choose_T(Lx, Ly, 0, 0, B, d=d),
        "gram_fused": ops.choose_T(Lgx, Lgy, 0, 0, Bx * By, d=dg),
    }
    launchers = {
        "fwd": lambda T: kernel.fwd(delta, T, 0, 0, "order1", "float32"),
        "fwd_cps": lambda T: kernel.fwd_cps(delta, T, 0, 0, "order1", "float32")[0],
        "bwd": lambda T: kernel.bwd(delta, cps, gbar, T, 0, 0, "order1", "float32"),
        "fwd_fused": lambda T: kernel.fwd_fused(dx, dy, T, 0, 0, "order1", "float32"),
        "gram_fused": lambda T: kernel.gram_fused(dX, dY, T, 0, 0, "order1", "float32"),
    }
    launchers_fused = {"fwd_fused": kernel.fwd_fused, "gram_fused": kernel.gram_fused}
    plains = {
        "fwd": lambda: kernel.solve_plain(delta, 0, 0, "order1", "float32"),
        "fwd_cps": lambda: kernel.solve_with_grid_plain(delta, T_grad, 0, 0, "order1",
                                                        "float32")[0],
        "bwd": lambda: kernel.solve_grad_plain(delta, cps, gbar, T_grad, 0, 0, "order1",
                                               "float32"),
        "fwd_fused": lambda: kernel.solve_fused_plain(dx, dy, 0, 0, "order1", "float32"),
        "gram_fused": lambda: kernel.gram_fused_plain(dX, dY, 0, 0, "order1", "float32"),
    }
    rows = []
    for kname in ("fwd", "fwd_cps", "fwd_fused", "gram_fused", "bwd"):
        T = default_T[kname]
        ms = time_ms(lambda: launchers[kname](T), 5)
        plain_ms = time_ms(plains[kname], 2)
        got = launchers[kname](T)
        want = plains[kname]()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(rel_err(got, want) <= RTOL["float32"], f"{kname} at full size disagrees")
        nbytes, nflops = work[kname]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nflops / FP32_FLOPS_PER_S * 1e3
        sweep = {}
        if kname in FORWARD_PATH:
            fused = kname != "fwd"
            sweep = {Ts: round(time_ms(lambda: launchers[kname](Ts), 3), 4)
                     for Ts in (32, 64, 128, 256, 512, 1024)
                     if Ts <= (kernel.FUSED_MAX_THREADS if fused else kernel.MAX_THREADS)
                     and kernel.smem_bytes(fused, "order1", Ts, Ly if kname != "gram_fused"
                                           else Lgy, 0, 0, d if kname == "fwd_fused" else dg)
                     <= kernel.SMEM_LIMIT}
        if kname == "bwd":  # the backward with the checkpoint forward it lines up with
            for Ts in (64, 128, 256, 512):
                cps_T = kernel.fwd_cps(delta, Ts, 0, 0, "order1", "float32")[1]
                sweep[Ts] = {
                    "fwd_cps": round(time_ms(lambda: launchers["fwd_cps"](Ts), 3), 4),
                    "bwd": round(time_ms(lambda: kernel.bwd(delta, cps_T, gbar, Ts, 0, 0,
                                                            "order1", "float32"), 3), 4)}
                del cps_T
        path_counts = counts if kname in FORWARD_PATH else gcounts
        row = {"name": kname, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[kname], "launches": path_counts[kname],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None}
        rows.append(row)
        emit({"timing": kname, "strip_T": T, "bytes": nbytes, "flops": nflops,
              "bytes_ms": t_bytes, "ops_ms": t_ops, "strip_sweep_ms": sweep,
              **row, "card": name, "power_limit": power})

    # every Goursat kernel at every shape it launched at on the forward and
    # gradient paths (GridConfig() defaults: order 1, float32 interiors,
    # lam = 0): time and bound, the per-shape gaps of PERF.md's ranking; B4
    # and B3 also against their plain versions and with a strip sweep
    path_shapes = {}
    for path, log in (("forward", shapes_fwd), ("gradient", shapes_grad)):
        for key, n in log.items():
            path_shapes.setdefault(key, {})[path] = n
    for (kname, P, Lx_, Ly_, d_, T_), by_path in sorted(path_shapes.items(), key=str):
        gram = kname == "gram_fused"
        fused = kname in ("fwd_fused", "gram_fused")
        Bx_, By_ = P if gram else (P, P)
        row = {"timing_by_shape": kname, "problems": list(P) if gram else P, "Lx": Lx_,
               "Ly": Ly_, "d": d_, "T": T_, "launches": by_path}
        if fused:
            a_ = torch.from_numpy(np.diff(random_paths(rng, Bx_, Lx_ + 1, d_), axis=1)).to(dev)
            b_ = torch.from_numpy(np.diff(random_paths(rng, By_, Ly_ + 1, d_), axis=1)).to(dev)
            a_, b_ = a_.contiguous(), b_.contiguous()
            run = lambda: launchers_fused[kname](a_, b_, T_, 0, 0, "order1", "float32")
            plain = {"fwd_fused": kernel.solve_fused_plain,
                     "gram_fused": kernel.gram_fused_plain}[kname]
            plain_ms = time_ms(lambda: plain(a_, b_, 0, 0, "order1", "float32"), 2)
            got, want = run(), plain(a_, b_, 0, 0, "order1", "float32")
            torch.cuda.synchronize()
            err = rel_err(got, want)
            check(err <= RTOL["float32"],
                  f"{kname} at {(P, Lx_, Ly_, d_)} T={T_}: rel err {err:.3g}")
            n_prob = Bx_ * By_ if gram else P
            nbytes = (a_.numel() + b_.numel() + n_prob) * 4
            nflops = n_prob * (2 * d_ + CELL_FLOPS) * Lx_ * Ly_
            row["strip_sweep_ms"] = {
                Ts: round(time_ms(lambda: launchers_fused[kname](a_, b_, Ts, 0, 0, "order1",
                                                                 "float32"), 3), 4)
                for Ts in (32, 64, 128, 256, 512) if Ts <= kernel.FUSED_MAX_THREADS
                and kernel.smem_bytes(True, "order1", Ts, Ly_, 0, 0, d_) <= kernel.SMEM_LIMIT}
            row.update(plain_ms=plain_ms, max_abs_err=float((got - want).abs().max()),
                       rel_err=err)
            del got, want
        else:
            dl_ = delta_matrix(torch.from_numpy(random_paths(rng, P, Lx_ + 1, 8)).to(dev),
                               torch.from_numpy(random_paths(rng, P, Ly_ + 1, 8)).to(dev))
            dl_ = dl_.contiguous()
            if kname == "fwd":
                run = lambda: kernel.fwd(dl_, T_, 0, 0, "order1", "float32")
                extra, cell = 0, CELL_FLOPS
            else:
                cps_ = kernel.fwd_cps(dl_, T_, 0, 0, "order1", "float32")[1]
                g_ = torch.ones(P, device=dev)
                run = {"fwd_cps": lambda: kernel.fwd_cps(dl_, T_, 0, 0, "order1", "float32"),
                       "bwd": lambda: kernel.bwd(dl_, cps_, g_, T_, 0, 0, "order1",
                                                 "float32")}[kname]
                extra = cps_.numel() + (dl_.numel() if kname == "bwd" else 0)
                cell = BWD_CELL_FLOPS if kname == "bwd" else CELL_FLOPS
            nbytes = (dl_.numel() + extra + P) * 4
            nflops = P * Lx_ * Ly_ * cell
        row["ms"] = time_ms(run, 5)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nflops / FP32_FLOPS_PER_S * 1e3
        row.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations", card=name,
                   power_limit=power)
        emit(row)
        torch.cuda.empty_cache()

    # the Horner kernel at the signature path's three shapes (the kernels
    # line takes the largest, (128, 1024, 16, 4)) and at the two pipelines'
    # kernel shapes: time-aug + basepoint (d' = 5) and + lead-lag (d' = 9)
    pipe_shapes = {}
    for what, (pipe, N_) in pipelines.items():
        zp_ = tf.pipeline_increments(x46, pipe).contiguous()
        pipe_shapes[(zp_.shape[0], zp_.shape[1] + 1, zp_.shape[2], N_)] = zp_
    for B_, L_, d_, N_ in (*SIG_SHAPES, *pipe_shapes):
        z_ = pipe_shapes.get((B_, L_, d_, N_))
        if z_ is None:
            z_ = tf.pipeline_increments(sig_x[(d_, N_)], identity).contiguous()
        geo = sig_ops.geometry(B_, L_ - 1, d_, N_)
        p_, jw_, cw_, S_, th_ = geo
        ms = time_ms(lambda: sig_kernel.horner(z_, N_, *geo), 5)
        plain_ms = time_ms(lambda: sig_kernel.horner_plain(z_, N_), 2)
        got = sig_kernel.horner(z_, N_, *geo)
        want = sig_kernel.horner_plain(z_, N_)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"horner at {(B_, L_, d_, N_)} differs from plain")
        nbytes = (z_.numel() + got.numel()) * 4
        nflops = B_ * (L_ - 1) * sig_kernel.horner_flops(d_, N_)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nflops / FP32_FLOPS_PER_S * 1e3
        lb_sweep = {S2: round(time_ms(lambda: sig_kernel.horner(z_, N_, p_, jw_, cw_, S2,
                                                               th_), 3), 4)
                    for S2 in sorted({1, 4, 8, 16, 32, S_})
                    if sig_kernel.smem_bytes(d_, N_, p_, cw_, S2, th_) <= sig_kernel.SMEM_LIMIT}
        # the prefix length and the rows' chunk width around the default
        split_sweep = {}
        for p2 in range(max(0, p_ - 1), min(N_ - 1, p_ + 1) + 1):
            for cw2 in (1, 2, 4):
                th2 = sig_kernel.threads_needed(d_, N_, p2, d_, cw2)
                if th2 > sig_kernel.MAX_THREADS or sig_kernel.smem_bytes(
                        d_, N_, p2, cw2, S_, th2) > sig_kernel.SMEM_LIMIT:
                    continue
                split_sweep[f"p={p2} cw={cw2}"] = round(time_ms(
                    lambda: sig_kernel.horner(z_, N_, p2, d_, cw2, S_, th2), 3), 4)
        row = {"name": "horner", "route": "cuda", "source": SIG_SOURCE,
               "replaces": SIG_REPLACES, "launches": scounts["horner"],
               "max_abs_err": float((got - want).abs().max()), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None}
        if (d_, N_) == SIG_SHAPES[-1][2:]:
            rows.append(row)
        emit({"timing": "horner", "shape": [B_, L_, d_, N_], "prefix_p": p_,
              "columns_jw": jw_, "chunk_cw": cw_, "length_block": S_, "threads": th_,
              "blocks": B_ * d_ ** p_ * -(-d_ // jw_), "bytes": nbytes, "flops": nflops,
              "bytes_ms": t_bytes, "ops_ms": t_ops, "length_block_sweep_ms": lb_sweep,
              "prefix_chunk_sweep_ms": split_sweep,
              "launches_at_this_shape": by_shape.get(f"d={d_}, N={N_}", 0), **row,
              "card": name, "power_limit": power})

    emit({"kernels": rows})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
