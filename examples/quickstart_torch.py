"""Quickstart of the PyTorch port: signatures and signature kernels in five
minutes.

The PyTorch counterpart of ``examples/quickstart.py``, section by section,
through ``repro_torch``'s names; it runs on the card unless given
``--device cpu``.  The JAX quickstart's ``backend="pallas"`` and
``"pallas_fused"`` lines become the port's ``"gpu"`` and ``"gpu_fused"``
backends (the hand-written CUDA kernels), each against the plain
``"reference"`` backend on the same device; on the CPU they print that the
kernels need the card and are skipped.  Every ``err`` line prints a
maximum absolute error.

    PYTHONPATH=src python examples/quickstart_torch.py
"""

import argparse

import torch

import repro_torch as rt
from repro_torch.api import card_device
from repro_torch.core import losses
from repro_torch.core.gram import sigkernel_gram
from repro_torch.core.logsignature import logsignature, logsignature_combine
from repro_torch.core.sigkernel import sigkernel
from repro_torch.core.signature import signature, signature_combine


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = card_device(args.device, "quickstart_torch.py")
    g = torch.Generator(device=dev).manual_seed(0)

    # --- a batch of 3-dimensional paths (e.g. price streams) ---------------
    paths = torch.randn((8, 50, 3), generator=g, device=dev) * 0.2

    # truncated signature (levels 1..4, flat layout)
    sig = signature(paths, depth=4)
    print("signature:", tuple(sig.shape))          # (8, 3 + 9 + 27 + 81)

    # Chen's identity: signatures compose over concatenation
    left, right = signature(paths[:, :25], 4), signature(paths[:, 24:], 4)
    print("chen err:", max_err(signature_combine(left, right, 3, 4), sig))

    # lead-lag + time augmentation, applied on the fly (paper §4)
    sig_ll = signature(paths, depth=3, transforms=rt.TransformPipeline(
        lead_lag=True, time_aug=True))
    print("lead-lag signature:", tuple(sig_ll.shape))

    # --- log-signatures: same information, Lyndon-compressed ----------------
    logsig = logsignature(paths, depth=4)          # mode="lyndon" (default)
    print("log-signature:", tuple(logsig.shape), "vs signature:", tuple(sig.shape))

    # log-signatures also compose over concatenation (via exp -> Chen -> log)
    lls, rls = logsignature(paths[:, :25], 4), logsignature(paths[:, 24:], 4)
    print("logsig combine err:", max_err(logsignature_combine(lls, rls, 3, 4), logsig))

    # exact gradients through the log + Lyndon projection too
    q = paths.clone().requires_grad_()
    g_ls, = torch.autograd.grad(logsignature(q, 3).sum(), q)
    print("logsig grad finite:", bool(torch.isfinite(g_ls).all()))

    # --- signature kernels (Goursat PDE, paper §3) --------------------------
    x, y = paths[:4], paths[4:]
    k = sigkernel(x, y, grid=rt.GridConfig(1, 1))  # dyadic order (1, 1)
    print("k(x, y):", tuple(k.shape), k[:2].tolist())

    # Gram matrix + MMD loss between two path distributions
    K = sigkernel_gram(x, y)
    print("gram:", tuple(K.shape))
    mmd = losses.mmd2(x, y, unbiased=False)
    print("MMD^2:", float(mmd))

    # symmetric Gram: omit Y and only the upper triangle is solved (~2x fewer
    # PDE solves), mirrored into the full (4, 4) matrix
    Kxx = sigkernel_gram(x)
    print("symmetric gram:", tuple(Kxx.shape), "sym err:", max_err(Kxx, Kxx.T))

    # exact gradients through the PDE solver (paper §3.4) — train anything
    xq = x.clone().requires_grad_()
    gx, = torch.autograd.grad(losses.mmd2(xq, y, unbiased=False), xq)
    print("grad wrt paths:", tuple(gx.shape), "finite:", bool(torch.isfinite(gx).all()))

    # --- backend registry (repro_torch.core.dispatch) -----------------------
    # every entry point takes backend=; "auto" picks per device; "gpu" and
    # "gpu_fused" are the CUDA kernels, "reference" the plain PyTorch solver
    if dev.type == "cuda":
        k_gpu = sigkernel(x, y, backend="gpu")
        print("gpu vs reference err:", max_err(k_gpu, sigkernel(x, y, backend="reference")))
        sig_gpu = signature(paths, depth=4, backend="gpu")
        print("gpu signature err:", max_err(sig_gpu, signature(paths, 4, backend="reference")))
        # the fused-Δ Gram backend (Δ never exists in memory), differentiable too
        K_fused = sigkernel_gram(x, y, backend="gpu_fused")
        print("fused gram err:", max_err(K_fused, sigkernel_gram(x, y, backend="reference")))
    else:
        print("gpu / gpu_fused backends: the CUDA kernels need the card; skipped on the CPU")

    # --- class entry points: composable kernel modules ----------------------
    # static_kernel= swaps the lift under the signature kernel (KSig-style)
    sk = rt.SigKernel(static_kernel=rt.RBF(sigma=1.0),
                      transforms=rt.TransformPipeline(time_aug=True),
                      grid=rt.GridConfig(1, 1), device=dev)
    K_rbf = sk.gram(x)                               # RBF-lift symmetric Gram
    print("RBF-lift gram:", tuple(K_rbf.shape))
    print("RBF-lift MMD^2:", float(sk.mmd2(x, y, unbiased=False)))

    # kernel hyper-parameters may be tensors: differentiate through sigma
    s = torch.tensor(1.0, device=dev, requires_grad=True)
    dsig, = torch.autograd.grad(rt.SigKernel(static_kernel=rt.RBF(sigma=s),
                                             device=dev).gram(x).sum(), s)
    print("d gram.sum / d sigma:", float(dsig))

    # basepoint transform (translation sensitivity), on the fly as well
    sig_bp = rt.Signature(depth=3, transforms=rt.TransformPipeline(basepoint=True),
                          device=dev)
    print("basepoint signature:", tuple(sig_bp(paths).shape))

    # --- ragged batches: variable-length paths in one dense tensor ----------
    # lengths= makes each path behave as if truncated to its own length
    # (padding content is ignored — even NaN), with a per-path time grid that
    # ends at t1 at the TRUE last point
    lens = torch.tensor([6, 50, 23, 9, 41, 17, 50, 30], device=dev)
    ragged_sig = rt.signature(paths, depth=4, lengths=lens)
    oracle = rt.signature(paths[0:1, :6], depth=4)      # truncated by hand
    print("ragged == truncated:", bool(torch.equal(ragged_sig[0], oracle[0])))

    # Gram over two differently-ragged batches, any backend
    K_rag = rt.sigkernel_gram(x, y, lengths=torch.tensor([8, 50, 21, 34], device=dev),
                              lengths_y=torch.tensor([50, 5, 44, 12], device=dev))
    print("ragged gram:", tuple(K_rag.shape))

    # pad a ragged batch to a power-of-two length bucket yourself
    xp, lp = rt.pad_ragged(x, torch.tensor([8, 50, 21, 34], device=dev))
    print("bucketed length:", xp.shape[1], "=", rt.bucket_length(x.shape[1]))


if __name__ == "__main__":
    main()
