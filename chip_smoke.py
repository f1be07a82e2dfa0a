#!/usr/bin/env python3
"""Drive the PyTorch port's signature and signature-kernel paths, forward and
gradient, its LM serving path and its example scripts, on one CUDA card.

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
   (problems, Lx, Ly, d) and strip height (for the precomputed-Δ forward,
   which has none, its geometry);
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
   operations / 67 TFLOP/s FP32, H100 SXM data sheet), sweep the
   precomputed-Δ forward's geometry (rows a lane, one pass of warps or a
   loop; each result equal to the default's), the fused kernels' strip
   height, the
   backward's with its checkpoint forward, and
   the Horner kernel's length block and prefix length (also at the two
   pipelines' kernel shapes), time every Goursat kernel at every shape it
   launched at on the forward and gradient paths against its bound (B4 and
   B3 also against their plain versions, rel <= 1e-4, with a strip sweep),
   and print one JSON line per kernel, the
   ``kernels`` line, the card's name and power limit, and the final ``ok``
   line;
8. ``stream_path``: the streaming ``Path`` at the JAX bench's "full" cells,
   (L, d, N) = (1024, 4, 5) and (4096, 3, 4) for 128 paths each (and
   lead-lag at (1024, 4, 5) on a batch that fits): ``from_points``, 16
   one-point and 8 eight-point ``update``s, 1,024 random interval queries,
   ``rolling(64, stride=16)``, ``logsignature``, a ``retention=1024`` run;
   the full signature against a fresh ``signature`` on the card (the Horner
   kernel) at rel <= 5e-5; no scan step over the queries, the chunk buckets'
   steps over the updates;
9. ``features_path``: the RFF (linear and RBF lift) and Nyström Grams on
   32 x 32 paths of (129, 8) at ranks 32, 128, 512, each against the exact
   Gram of the same call (relative Frobenius error and ms); RFF issues no
   pair solve; ``torch.autograd.grad`` of ``mmd2(..., features=)`` finite
   for both methods; ``sig_aux_loss`` on hidden (32, 128, 256) with proj
   (256, 8), exact and with each method; Goursat launches by shape;
10. ``serve_path``: ``SigFeatureServer(depth=5)`` with 128 streams of
   d = 4 opened with 1,024 points, 32 flush rounds of 1 to 8 points a
   stream, after each ``signature``, ``logsignature``, ``rolling(64)`` and
   ``features(window=256)`` (RFF, rank 128) on 8 streams; every stream's
   signature against a fresh ``signature`` of its raw points at rel <= 5e-5.

11. ``sharded_path``: ``sigkernel_gram_sharded`` on NCCL groups of 1 rank
   and, where the cards exist, 2 and 4 (one rank a card, started by
   ``repro_torch.launch.spawn_ranks``), on the Table 2 Gram (128, 256, 8):
   linear and RBF (``row_block=16``), each asymmetric and symmetric, ragged
   ``lengths=``, and ``torch.autograd.grad`` of ``(K * W).sum()``; each
   rank holds every result against the dense Gram on its card (values 1e-6,
   the gradient 1e-5 relative), rank 0 returns its launch counts and
   shapes, and every shape no earlier path launched goes through
   ``shape_check``.

12. ``train_path``: the trainers.  (a) The generator of
   ``examples/train_sigkernel_gan_torch.py`` at its ``--full-100m`` width
   (12 layers of width 768, ~113M parameters, float32, scanned and
   rematerialised layers) against (64, 256, 8) GBM targets under time-aug
   (d' = 9) and (λ, λ) = (1, 1): 30 steps of the example's own AdamW and
   cosine schedule at the peak rate 1e-5, the last 10 timed, the eval MMD²
   on its fixed set before and after, which must fall.  (b) The dense LM
   at deepseek-7b's width (d_model 4096, 32 heads, d_ff 11008, vocab
   102400, bf16 compute), its
   depth cut from 30 to 2 layers, ``sig_loss`` on: ``make_train_step`` with
   two microbatches on ``TokenLM(102400, 512, 4)``, 5 steps on one batch;
   the loss must fall and ``sig`` stay finite.  (c) The reduced generator's
   loss and parameter gradients on the card against the CPU's (1e-4).
   B1-cps, B2 and a fused kernel must launch; every refined launch shape,
   and each unrefined one no earlier path launched, goes through
   ``shape_check``.

13. ``bench_path``: ``repro_torch.bench.suite.run_suite("smoke", repeats=1)``
   in-process on the card (the paper's tables at smoke sizes through every
   backend, ``gpu`` and ``gpu_fused`` included, the smoke checks, the
   sharded Gram's NCCL check); the document must be schema 1 with a
   fingerprint naming the card and its power limit, unique names, the
   ``gpu`` / ``gpu_fused`` Gram and smoke entries, no skipped check and a
   green self-compare; B1, B1-cps, B2, B3 and B4 must launch.  The smoke
   mode includes the autotune round trip and both frontiers at their smoke
   cells.  (The ``--full`` run is ``python -m repro_torch.bench --full``,
   not part of the smoke.)

14. ``autotune_path``: the autotune cache (``repro_torch.bench.autotune``)
   on a fresh temporary file.  ``tune`` the Gram at the JAX bench's full
   frontier cell (32, 32, 128, 128, 8), ``sigkernel`` at a refined
   (128, 128, 8) and ``signature`` at Table 1's (1024, 16, 4), each over
   ``reference``, ``antidiag``, ``gpu`` and ``gpu_fused`` where they serve
   the op, printing each backend's ms and the winner; ``backend="auto"``
   must resolve to the stored winner and equal it bit for bit.  Then
   ``tune_frontier`` (RFF / Nyström at ranks 8, 32, 128) and
   ``tune_scheme_frontier`` (order 1 / 2 × coarsening 0 / 1 × f32 / bf16
   interiors) at the Table 2 Gram, key (128, 128, 256, 256, 8), linear
   lift; then ``sigkernel_gram`` and ``mmd2`` (and its gradient) with
   ``error_budget=`` 0.05 and 0.5 on Table 2 data, printing what each
   resolved to, its ms and its error against the exact Gram: each value
   bit for bit the explicit call its point names (``features=`` or a
   subsampled ``GridConfig(scheme=, interior_dtype=)``, or the plain call
   when nothing qualifies), the gradient too (to 1e-6 where a coarsened
   point subsamples: float32 summation order).  B5 at the tuning batch
   against its plain version exactly; every Goursat launch shape the phase
   adds, or ran at another stencil or interior dtype, through
   ``shape_check`` at each (scheme, interior dtype) it ran at.

15. ``serve_lm_path``: LM serving at full width, under
   ``torch.inference_mode``: deepseek-7b (30 layers of width 4096, dense,
   stacked layout) serves 4 prompts of 512 tokens and decodes 32 greedy
   tokens, recurrentgemma-2b (26 layers of width 2560: 8 (rec, rec, attn)
   groups and 2 rest layers, window 2048) 4 prompts of 2,048 and 64
   tokens, the ring wrapping from the first decoded one; both in bf16 from
   one compute copy of the weights (``repro_torch.serve.step``).  Prints,
   per model, prefill ms, decode ms a token (median, CUDA events),
   tokens/s, peak memory and each bound; a depth that does not fit is cut
   by whole layer groups and printed.  Checks: finite logits, tokens in
   the vocabulary, decode's peak memory within 5% of the bf16 weights above
   what it held (a step that cast the weights again fails), and, in float32
   on the same parameters, the logits of a prefill of S tokens against a
   prefill of S - k then k decode steps (k = 1 at S = 512; k = 52 at S =
   2,074, across the wrap) within 1e-4 of their largest magnitude; then the
   reduced configs (stacked, per-layer and grouped), drawn on the CPU, on
   the card against the CPU within 1e-4.  The path reaches no hand-written
   kernel; its counts are printed.

16. ``examples_path``: ``examples/serve_lm_torch.py``,
   ``quickstart_torch.py`` and ``serve_sig_features_torch.py`` at their
   defaults in-process (their output printed; every error line < 1e-4, the
   admission check), then ``gram_matrix_distributed_torch.py`` on NCCL with
   one rank a card (its ``rank_main`` with the rank's launch counts read
   around it, then its ``report``).  B1, B1-cps, B2, B3, B4 and B5 must
   launch in-process and B3 in the ranks; every Goursat shape the examples
   (and rank 0) launched goes through ``shape_check`` at each refinement,
   scheme and interior dtype it ran at, unless an earlier phase checked it
   at λ = 0, order 1, float32, and every Horner shape and geometry through
   ``horner_shape_check``, exactly.

Phases 8-16 run after phase 7's timing and before the ``kernels`` line;
each sets the launch counts to 0 just before it and reads them just after
(phase 11 and 16's distributed example in each rank).  Phase 4 also times the host build of the
``"brackets"`` basis change at d = 16, N = 4.  Every phase reads, and
phases 13 and 14 write, an autotune cache under a temporary directory the
script makes and removes (``REPRO_AUTOTUNE_CACHE``; phase 14 a fresh file),
never the home directory's.  The script takes no arguments.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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

#: the JAX bench's "full" streaming-Path cells, (L, d, N), for PATH_BATCH
#: paths each (src/repro/bench/workloads.py:852-856), and its gate against a
#: fresh recompute (:900)
PATH_CELLS = ((1024, 4, 5), (4096, 3, 4))
PATH_BATCH = 128
PATH_REL = 5e-5
#: lead-lag doubles d to 8 at (1024, 4, 5): sig_dim 37,448 and 2,046 stored
#: rows a store, 613 MB a path for both stores; the build's scan and inverse
#: hold about five times the stores at once
LEAD_LAG_BATCH = 16
#: the JAX approximation frontier's "full" cell: Bx = By = 32 paths of 129
#: points (128 increments), d = 8, ranks 32, 128, 512
#: (src/repro/bench/workloads.py:672-677, bench/autotune.py:496-507)
FRONTIER = (32, 129, 8)
FRONTIER_RANKS = (32, 128, 512)
#: a Nyström map whose pool is the whole batch reproduces the exact Gram
NYSTROEM_FULL_RANK_REL = 1e-4
#: the served streams: count, initial points, d, depth; flush rounds, the
#: streams queried after each, the rolling window and the feature window
SERVE = (128, 1024, 4, 5)
SERVE_ROUNDS, SERVE_QUERIED, SERVE_WINDOW, SERVE_FEATURE_WINDOW = 32, 8, 64, 256
#: the sharded Gram: the Table 2 Gram (src/repro/bench/workloads.py:145-152)
#: at these world sizes, where the cards exist; its inputs' seed; its gates
#: against the dense Gram on the same card (values, the gradient)
SHARDED = (128, 256, 8)
SHARDED_WORLDS = (1, 2, 4)
SHARDED_SEED = 11
SHARDED_REL, SHARDED_GRAD_REL = 1e-6, 1e-5
#: the kernels the sharded path must launch on each rank
SHARDED_PATH = ("fwd", "fwd_cps", "bwd", "fwd_fused", "gram_fused")
# phase 12: the generator of examples/train_sigkernel_gan_torch.py at its
# --full-100m width (12 x 768, ~113M parameters, float32) against (64, 256, 8)
# GBM targets under time-aug and (λ, λ) = (1, 1), 30 steps of the example's
# own optimiser and schedule (AdamW, cosine with 20 warm-up steps), the last
# 10 timed, at the peak rate --lr 1e-5: at the example's default 1e-3, and
# at 1e-4 and 3e-5, the full-width generator's MMD² rises or overflows
# (tools/gan_probe.py); the dense LM at deepseek-7b's width with its depth
# cut from 30 to 2 layers (Adam's float32 state for 7B parameters does not
# fit one card), bf16 compute, sig_loss on, TokenLM(102400, 512, 4) in two
# microbatches, 5 steps on one batch, as tests/test_models.py:96-101 runs the
# JAX LM; the reduced generator's loss and gradients on the card against the
# CPU's on (8, 32, 8)
# phase 14: the autotune cache on a fresh temporary file.  Tuning: the Gram
# at the JAX bench's full frontier cell (src/repro/bench/workloads.py:672-677;
# at the Table 2 Gram the row scan would take about a minute a call), a
# refined sigkernel key, and Table 1's largest signature cell (:110-114).
# The frontiers and the budgeted calls: the Table 2 Gram (:145-152), key
# (128, 128, 256, 256, 8) for paths of 256 points, linear lift
TUNE_SHAPES = (("gram", (32, 32, 128, 128, 8)), ("sigkernel", (128, 128, 8)),
               ("signature", (1024, 16, 4)))
BUDGET_GRAM = (128, 256, 8)
BUDGETS = (0.05, 0.5)
#: the budgeted mmd2 gradient against its explicit call's where a coarsened
#: point subsamples the paths (float32 summation order); 0 otherwise
GRAD_SLICE_REL = 1e-6
#: phases 13 and 14 write their caches under CACHE_DIR, a temporary
#: directory the script's ``__main__`` makes and removes
AUTOTUNE_ENV = "REPRO_AUTOTUNE_CACHE"
# phase 15: LM serving at full width.  Each model serves a prompt and then
# decodes; "check" is the float32 prefill-against-decode check's (S, k): the
# logits of k decode steps after a prefill of S - k tokens against those of
# one prefill of S (tests/test_models.py); recurrentgemma-2b's S - k < 2048
# (its window) <= S - 1, so the decoded steps cross the ring's wrap
SERVE_LM = ({"arch": "deepseek-7b", "batch": 4, "prompt": 512, "tokens": 32, "check": (512, 1)},
            {"arch": "recurrentgemma-2b", "batch": 4, "prompt": 2048, "tokens": 64,
             "check": (2074, 52)})
SERVE_LM_REL = 1e-4              # float32 check, of the logits' largest magnitude
SERVE_LM_CARD_CPU_REL = 1e-4     # reduced configs, card against CPU
#: decode's peak memory above what it held before the loop, as a share of
#: the bf16 weights: a step that cast the weights again (+100%) fails
DECODE_PEAK_SHARE = 0.05
#: decode steps after the timed ones, under torch.profiler (device busy share)
PROFILE_STEPS = 4
SERVE_LM_HEADROOM = 8 << 30      # bytes left free beside weights and caches
#: the reduced configs held card against CPU: stacked, per-layer, grouped
SERVE_LM_REDUCED = (("deepseek-7b", {"scan_layers": True}), ("recurrentgemma-2b", {}),
                    ("recurrentgemma-2b", {"n_layers": 7, "scan_layers": True}))
BF16_FLOPS_PER_S = 989e12        # H100 SXM data sheet, dense bf16 tensor cores
# phase 16: the port's example scripts at their defaults, in this order
EXAMPLES_DIR = os.path.join(ROOT, "examples")
EXAMPLES = ("serve_lm_torch", "quickstart_torch", "serve_sig_features_torch",
            "gram_matrix_distributed_torch")
EXAMPLES_ERR = 1e-4              # every printed error line (the JAX quickstart's bar)
GAN = dict(batch=64, length=256, dim=8, dyadic=1, steps=30, timed=10, lr=1e-5, warmup=20)
LM = dict(layers=2, seq=512, batch=4, microbatches=2, steps=5, sig_dim=4)
GAN_SMALL = (8, 32, 8)
TRAIN_CARD_CPU_REL = 1e-4
TRAIN_PATH = ("fwd_cps", "bwd")     # and at least one of fwd_fused, gram_fused


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
             "Ly": Ly, "d": d, "T": list(T) if isinstance(T, tuple) else T, "launches": n}
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


def fwd_cps(delta, T, lam1=0, lam2=0, scheme="order1", idt="float32"):
    """The checkpoint forward at strip T and the geometry ops.geometry picks
    for it (as ops.solve_with_grid launches it)."""
    from repro_torch.kernels.sigkernel_pde import kernel, ops
    geo = ops.geometry(*delta.shape[1:], lam1, lam2, scheme=scheme, T=T)
    return kernel.fwd_cps(delta, T, lam1, lam2, scheme, idt, geo)


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
    # every phase reads, and phases 13 and 14 write, an autotune cache of the
    # script's own, never the home directory's
    os.environ[AUTOTUNE_ENV] = os.path.join(CACHE_DIR, "bench.json")
    os.environ.pop("REPRO_DISABLE_AUTOTUNE", None)

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
    # the brackets basis change at the largest cell, built on the host (an
    # inverse a block of same-letter Lyndon words), timed apart from the path
    from repro_torch.core import lyndon
    t_tab = time.time()
    M_tab = lyndon._basis_change(16, 4)[0]
    emit({"brackets_table": {"d": 16, "depth": 4, "n": M_tab.shape[0],
                             "host_seconds": round(time.time() - t_tab, 3)},
          "card": name, "power_limit": power})
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
        for mode in ("lyndon", "brackets", "expand"):
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
                         max_t=strip)
        gbar = torch.from_numpy(rng.normal(size=8).astype(np.float32)).to(dev)
        cps_k = fwd_cps(delta, T, l1, l2, scheme, idt)[1]
        cps_p = kernel.solve_with_grid_plain(delta, T, l1, l2, scheme, idt)[1]
        runs += [
            ("fwd_cps", lambda: fwd_cps(delta, T, l1, l2, scheme, idt)[0],
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
    T_grad = ops.choose_T(Lx, Ly, 0, 0, B)
    cps = fwd_cps(delta, T_grad)[1]
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
        "fwd": ops.geometry(Lx, Ly),
        "fwd_cps": T_grad,
        "bwd": T_grad,
        "fwd_fused": ops.choose_T(Lx, Ly, 0, 0, B, d=d),
        "gram_fused": ops.choose_T(Lgx, Lgy, 0, 0, Bx * By, d=dg),
    }
    launchers = {
        "fwd": lambda T: kernel.fwd(delta, T, 0, 0, "order1", "float32"),
        "fwd_cps": lambda T: fwd_cps(delta, T)[0],
        "bwd": lambda T: kernel.bwd(delta, cps, gbar, T, 0, 0, "order1", "float32"),
        "fwd_fused": lambda T: kernel.fwd_fused(dx, dy, T, 0, 0, "order1", "float32"),
        "gram_fused": lambda T: kernel.gram_fused(dX, dY, T, 0, 0, "order1", "float32"),
    }
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
        if kname == "fwd":  # the geometry: R rows a lane, one pass of warps or a loop
            for R in kernel.FWD_ROWS:
                bands = kernel.fwd_bands(Lx, R)
                for warps in sorted({min(bands, kernel.MAX_THREADS // 32), max(1, bands // 2)}):
                    geo = kernel.FwdGeometry(R, warps)
                    if kernel.fwd_smem_bytes("order1", geo, Lx, Ly, 0, 0) > kernel.SMEM_LIMIT:
                        continue
                    check(torch.equal(launchers[kname](geo), got),
                          f"fwd at geometry {tuple(geo)} differs from the default's")
                    sweep[str(tuple(geo))] = round(time_ms(lambda: launchers[kname](geo), 3), 4)
        elif kname in FORWARD_PATH:  # the fused kernels' strip height
            sweep = {Ts: round(time_ms(lambda: launchers[kname](Ts), 3), 4)
                     for Ts in (32, 64, 128, 256, 512) if Ts <= kernel.FUSED_MAX_THREADS
                     and kernel.smem_bytes("order1", Ts, Ly if kname != "gram_fused" else Lgy,
                                           0, 0, d if kname == "fwd_fused" else dg)
                     <= kernel.SMEM_LIMIT}
        if kname == "bwd":  # the backward with the checkpoint forward it lines up with
            for Ts in (64, 128, 256, 512):
                cps_T = fwd_cps(delta, Ts)[1]
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
        emit({"timing": kname, "strip_T": list(T) if kname == "fwd" else T, "bytes": nbytes,
              "flops": nflops,
              "bytes_ms": t_bytes, "ops_ms": t_ops, "strip_sweep_ms": sweep,
              **row, "card": name, "power_limit": power})

    # every Goursat kernel at every shape it launched at on the forward and
    # gradient paths, each against its plain version (shape_check)
    path_shapes = {}
    for path, log in (("forward", shapes_fwd), ("gradient", shapes_grad)):
        for key, n in log.items():
            path_shapes.setdefault(key, {})[path] = n
    for key, by_path in sorted(path_shapes.items(), key=str):
        shape_check(key, by_path, kernel, fwd_cps, dev, rng, name, power)

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

    stream_phase(rt, dev, rng, reset_all, sig_kernel, name, power)
    shapes_feat = features_phase(rt, dev, rng, reset_all, kernel, name, power)
    # the features path's own shapes (its many-problem strips among them),
    # each against its plain version; shapes the paths above share were
    # checked there
    for key, n in sorted(shapes_feat.items(), key=str):
        if key not in path_shapes:
            shape_check(key, {"features": n}, kernel, fwd_cps, dev, rng, name, power)
    serve_phase(rt, dev, rng, reset_all, sig_kernel, name, power)
    shapes_sh = sharded_phase(name, power)
    # the sharded path's per-rank shapes that no path above launched
    for key, by_world in sorted(shapes_sh.items(), key=str):
        if key not in path_shapes and key not in shapes_feat:
            shape_check(key, by_world, kernel, fwd_cps, dev, rng, name, power)
    # the trainers' shapes: every refined one, and the unrefined ones no path
    # above launched
    trained = set()
    for key, by_run, lam in train_phase(dev, reset_all, kernel, name, power):
        if lam or (key not in path_shapes and key not in shapes_feat and key not in shapes_sh):
            shape_check(key, by_run, kernel, fwd_cps, dev, rng, name, power, lam=lam)
        if not lam:
            trained.add(key)

    bench_phase(reset_all, kernel, name, power)
    seen = set(path_shapes) | set(shapes_feat) | set(shapes_sh) | trained
    for key, by_run, variants in autotune_phase(rt, dev, rng, reset_all, kernel, sig_kernel,
                                                sig_ops, name, power):
        if key not in seen or set(variants) != {("order1", "float32")}:
            shape_check(key, by_run, kernel, fwd_cps, dev, rng, name, power,
                        variants=sorted(variants))
        seen.add(key)

    serve_lm_phase(dev, reset_all, kernel, sig_kernel, name, power)
    goursat, horner = examples_phase(dev, reset_all, kernel, sig_kernel, name, power)
    # every Goursat shape of the examples at every (refinement, scheme,
    # interior dtype) it ran at, but those an earlier phase checked (at
    # λ = 0, order 1, float32), and every Horner shape, each against its
    # plain version
    for key, (by_run, ran_at) in sorted(goursat.items(), key=str):
        for lam1, lam2, scheme, idt in sorted(ran_at):
            check(lam1 == lam2, f"examples: {key} launched at refinement ({lam1}, {lam2})")
            if key not in seen or lam1 or (scheme, idt) != ("order1", "float32"):
                shape_check(key, by_run, kernel, fwd_cps, dev, rng, name, power, lam=lam1,
                            variants=((scheme, idt),))
    for key, by_run in sorted(horner.items(), key=str):
        horner_shape_check(key, by_run, sig_kernel, dev, rng, name, power)

    emit({"kernels": rows})
    return finish(card)


def finish(card) -> int:
    """The card's line and the final ``ok`` line."""
    import torch
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def shape_check(key, by_path, kernel, fwd_cps, dev, rng, name, power, lam=0,
                variants=(("order1", "float32"),)) -> None:
    """One Goursat kernel at one shape it launched at (key as in
    kernel.launch_shapes(); the refinement (lam, lam) it launched at), on
    fresh random inputs, for each (scheme, interior dtype) of ``variants``
    (default order 1, float32 interiors): held against its plain version,
    timed beside its bound (the per-shape gaps of PERF.md's ranking); B4
    and B3 also with a strip sweep.  ``by_path``: its launches on each
    driven path."""
    for scheme, idt in variants:
        _shape_check(key, by_path, kernel, fwd_cps, dev, rng, name, power, lam, scheme, idt)


def _shape_check(key, by_path, kernel, fwd_cps, dev, rng, name, power, lam, scheme,
                 idt) -> None:
    import torch
    from repro_torch.core.sigkernel import delta_matrix
    launchers_fused = {"fwd_fused": kernel.fwd_fused, "gram_fused": kernel.gram_fused}
    kname, P, Lx_, Ly_, d_, T_ = key
    gram = kname == "gram_fused"
    fused = kname in ("fwd_fused", "gram_fused")
    Bx_, By_ = P if gram else (P, P)
    row = {"timing_by_shape": kname, "problems": list(P) if gram else P, "Lx": Lx_,
           "Ly": Ly_, "d": d_, "T": list(T_) if isinstance(T_, tuple) else T_,
           "launches": by_path, "lam": lam, "scheme": scheme, "interior_dtype": idt}
    cells = Lx_ * Ly_ << 2 * lam          # refined grid cells a problem
    if fused:
        a_ = torch.from_numpy(np.diff(random_paths(rng, Bx_, Lx_ + 1, d_), axis=1)).to(dev)
        b_ = torch.from_numpy(np.diff(random_paths(rng, By_, Ly_ + 1, d_), axis=1)).to(dev)
        a_, b_ = a_.contiguous(), b_.contiguous()
        run = lambda: launchers_fused[kname](a_, b_, T_, lam, lam, scheme, idt)
        plain_fn = {"fwd_fused": kernel.solve_fused_plain,
                    "gram_fused": kernel.gram_fused_plain}[kname]
        plain = lambda: plain_fn(a_, b_, lam, lam, scheme, idt)
        n_prob = Bx_ * By_ if gram else P
        nbytes = (a_.numel() + b_.numel() + n_prob) * 4
        nflops = n_prob * (2 * d_ * Lx_ * Ly_ + CELL_FLOPS * cells)
        row["strip_sweep_ms"] = {
            Ts: round(time_ms(lambda: launchers_fused[kname](a_, b_, Ts, lam, lam, scheme,
                                                             idt), 3), 4)
            for Ts in (32, 64, 128, 256, 512) if Ts <= kernel.FUSED_MAX_THREADS
            and kernel.smem_bytes(scheme, Ts, Ly_, lam, lam, d_) <= kernel.SMEM_LIMIT}
    else:
        dl_ = delta_matrix(torch.from_numpy(random_paths(rng, P, Lx_ + 1, 8)).to(dev),
                           torch.from_numpy(random_paths(rng, P, Ly_ + 1, 8)).to(dev))
        dl_ = dl_.contiguous()
        if kname == "fwd":  # T_: the geometry it launched at
            run = lambda: kernel.fwd(dl_, kernel.FwdGeometry(*T_), lam, lam, scheme, idt)
            plain = lambda: kernel.solve_plain(dl_, lam, lam, scheme, idt)
            extra, cell = 0, CELL_FLOPS
        else:
            cps_ = fwd_cps(dl_, T_, lam, lam, scheme, idt)[1]
            g_ = torch.ones(P, device=dev)
            run, plain = {
                "fwd_cps": (lambda: fwd_cps(dl_, T_, lam, lam, scheme, idt),
                            lambda: kernel.solve_with_grid_plain(dl_, T_, lam, lam, scheme,
                                                                 idt)),
                "bwd": (lambda: kernel.bwd(dl_, cps_, g_, T_, lam, lam, scheme, idt),
                        lambda: kernel.solve_grad_plain(dl_, cps_, g_, T_, lam, lam, scheme,
                                                        idt))}[kname]
            extra = cps_.numel() + (dl_.numel() if kname == "bwd" else 0)
            cell = BWD_CELL_FLOPS if kname == "bwd" else CELL_FLOPS
        nbytes = (dl_.numel() + extra + P) * 4
        nflops = P * cells * cell
    plain_ms = time_ms(plain, 2)
    flat = lambda out: (torch.cat([v.reshape(-1) for v in out])  # fwd_cps: (k, cps)
                        if isinstance(out, tuple) else out)
    got, want = flat(run()), flat(plain())
    torch.cuda.synchronize()
    err = rel_err(got, want)
    tol = RTOL["float32"] if kname == "bwd" else RTOL[idt]
    check(err <= tol, f"{kname} {scheme} {idt} at {(P, Lx_, Ly_, d_)} T={T_} lam={lam}: "
                      f"rel err {err:.3g} > {tol}")
    row.update(plain_ms=plain_ms, max_abs_err=float((got - want).abs().max()),
               rel_err=err)
    del got, want
    row["ms"] = time_ms(run, 5)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nflops / FP32_FLOPS_PER_S * 1e3
    row.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", card=name,
               power_limit=power)
    emit(row)
    torch.cuda.empty_cache()


def synced_ms(fn):
    """(result, host ms) of one call that ends in a synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rel_rows(a, b) -> float:
    """The largest relative error of a row (path) of ``a`` against ``b``."""
    scale = b.abs().amax(dim=-1).clamp_min(1e-30)
    return float(((a - b).abs().amax(dim=-1) / scale).max())


def stream_phase(rt, dev, rng, reset_all, sig_kernel, name, power) -> None:
    """Phase 8: the streaming Path at the JAX bench's full cells."""
    import torch
    from repro_torch.core import dispatch
    from repro_torch.stream import Path
    reset_all()
    t_phase = time.time()
    cells = []
    for L_, d_, N_ in PATH_CELLS:
        walk = torch.from_numpy(random_paths(rng, PATH_BATCH, L_ + 16 + 64, d_)).to(dev)
        x = walk[:, :L_]
        # the first build pays the allocator's growth; the second is timed warm
        p, build_ms_cold = synced_ms(lambda: Path.from_points(x, N_))
        del p
        torch.cuda.reset_peak_memory_stats()
        p, build_ms = synced_ms(lambda: Path.from_points(x, N_))
        store_bytes = (p.prefix.numel() + p.inv_prefix.numel()) * p.prefix.element_size()
        upd_ms, chunk_steps = [], 0
        with dispatch.count_scan_steps() as sc_upd:
            for i in range(16):
                p, ms = synced_ms(lambda: p.update(walk[:, L_ + i:L_ + i + 1]))
                upd_ms.append(ms)
                chunk_steps += 1
            for j in range(8):
                a = L_ + 16 + 8 * j
                p, ms = synced_ms(lambda: p.update(walk[:, a:a + 8]))
                upd_ms.append(ms)
                chunk_steps += 8
        check(len(p) == walk.shape[1], f"stream {L_, d_, N_}: length {len(p)}")
        check(sc_upd.total == chunk_steps,
              f"stream {L_, d_, N_}: updates scanned {sc_upd.total} steps, "
              f"the chunk buckets hold {chunk_steps}")
        n_pts = len(p)
        i_q = rng.integers(0, n_pts - 1, size=1024)
        j_q = np.array([rng.integers(i + 2, n_pts + 1) for i in i_q])
        with dispatch.count_scan_steps() as sc_q, dispatch.count_combines() as cc_q:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [p.signature(int(i), int(j)) for i, j in zip(i_q, j_q)]
            torch.cuda.synchronize()
            query_ms = (time.perf_counter() - t0) * 1e3 / len(outs)
        check(sc_q.total == 0, f"stream {L_, d_, N_}: queries scanned {sc_q.total} steps")
        check(cc_q.total == int((i_q > 0).sum()),
              f"stream {L_, d_, N_}: {cc_q.total} combines for {len(outs)} queries")
        # interval queries against fresh signatures of the intervals (B5)
        interval_rel = max(rel_rows(outs[q], rt.signature(walk[:, i_q[q]:j_q[q]], N_))
                           for q in range(0, 1024, 128))
        roll, roll_ms = synced_ms(lambda: p.rolling(64, stride=16))
        check(roll.shape[-2] == (n_pts - 64) // 16 + 1, f"rolling shape {tuple(roll.shape)}")
        w = roll.shape[-2] - 1              # the last window, starting at point 16·w
        roll_rel = rel_rows(roll[:, w], rt.signature(walk[:, 16 * w:16 * w + 64], N_))
        logsig, logsig_ms = synced_ms(lambda: p.logsignature(mode="lyndon"))
        fresh, fresh_ms = synced_ms(lambda: rt.signature(walk, N_))
        full_rel = rel_rows(p.signature(), fresh)
        logsig_rel = rel_rows(logsig, rt.logsignature(walk, N_))
        peak = torch.cuda.max_memory_allocated()
        del p, outs, roll
        # retention: 24 updates on a path capped at L_ points
        keep = Path.from_points(x, N_, retention=L_)
        for i in range(16):
            keep = keep.update(walk[:, L_ + i:L_ + i + 1])
        for j in range(8):
            a = L_ + 16 + 8 * j
            keep = keep.update(walk[:, a:a + 8])
        check(len(keep) == L_, f"retention kept {len(keep)} points")
        retention_rel = rel_rows(keep.signature(), rt.signature(walk[:, -L_:], N_))
        del keep
        rels = {"full_signature": full_rel, "retention": retention_rel}
        for what, err in rels.items():
            check(err <= PATH_REL, f"stream {L_, d_, N_}: {what} rel err {err:.3g} > {PATH_REL}")
        for what, err in (("intervals", interval_rel), ("rolling", roll_rel),
                          ("logsignature", logsig_rel)):
            check(err <= 1e-3, f"stream {L_, d_, N_}: {what} rel err {err:.3g} > 1e-3")
        cells.append({"L": L_, "d": d_, "N": N_, "batch": PATH_BATCH, "store_bytes": store_bytes,
                      "peak_bytes": peak, "build_ms_cold": build_ms_cold, "build_ms": build_ms,
                      "update_1pt_ms": upd_ms[:16], "update_8pt_ms": upd_ms[16:],
                      "update_scan_steps": sc_upd.total, "query_ms": query_ms,
                      "query_scan_steps": sc_q.total, "query_combines": cc_q.total,
                      "rolling_ms": roll_ms, "rolling_windows": (n_pts - 64) // 16 + 1,
                      "logsignature_ms": logsig_ms, "fresh_signature_ms": fresh_ms,
                      "rel_err": {**rels, "intervals": interval_rel, "rolling": roll_rel,
                                  "logsignature": logsig_rel}})
        del walk, x
        torch.cuda.empty_cache()
    # lead-lag at (1024, 4, 5) on a batch that fits
    L_, d_, N_ = PATH_CELLS[0]
    ll = rt.TransformPipeline(lead_lag=True)
    x = torch.from_numpy(random_paths(rng, LEAD_LAG_BATCH, L_, d_)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    p, build_ms = synced_ms(lambda: Path.from_points(x, N_, transforms=ll))
    store_bytes = (p.prefix.numel() + p.inv_prefix.numel()) * p.prefix.element_size()
    i_q = rng.integers(0, L_ - 1, size=64)
    j_q = np.array([rng.integers(i + 2, L_ + 1) for i in i_q])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [p.signature(int(i), int(j)) for i, j in zip(i_q, j_q)]
    torch.cuda.synchronize()
    query_ms = (time.perf_counter() - t0) * 1e3 / len(outs)
    full_rel = rel_rows(p.signature(), rt.signature(x, N_, transforms=ll))
    check(full_rel <= PATH_REL, f"stream lead-lag: full signature rel err {full_rel:.3g}")
    cells.append({"L": L_, "d": d_, "N": N_, "lead_lag": True, "batch": LEAD_LAG_BATCH,
                  "sig_dim": p.sig_dim, "store_bytes": store_bytes,
                  "bytes_for_128_paths": store_bytes * PATH_BATCH // LEAD_LAG_BATCH,
                  "peak_bytes": torch.cuda.max_memory_allocated(), "build_ms": build_ms,
                  "query_ms": query_ms, "rel_err": {"full_signature": full_rel}})
    del p, outs, x
    torch.cuda.empty_cache()
    counts = sig_kernel.launch_counts()
    check(counts["horner"] > 0, "stream path: the fresh recompute never launched horner")
    emit({"stream_path": cells, "launches": counts, "seconds": round(time.time() - t_phase, 3),
          "card": name, "power_limit": power})


def features_phase(rt, dev, rng, reset_all, kernel, name, power) -> dict:
    """Phase 9: the RFF / Nyström feature maps, their gradients and
    sig_aux_loss at the JAX frontier's full cell.  Returns the phase's
    Goursat launches by shape."""
    import torch
    from repro_torch.core import dispatch
    from repro_torch.core.losses import sig_aux_loss
    Bf, Lf, df = FRONTIER
    X = torch.from_numpy((rng.normal(size=(Bf, Lf, df)) * 0.1).astype(np.float32)).to(dev)
    Y = torch.from_numpy((rng.normal(size=(Bf, Lf, df)) * 0.1).astype(np.float32)).to(dev)
    reset_all()
    t_phase = time.time()
    maps = []
    for lift, kern in (("linear", rt.Linear()), ("rbf", rt.RBF(1.0))):
        rt.sigkernel_gram(X, Y, static_kernel=kern)            # warm
        K, exact_ms = synced_ms(lambda: rt.sigkernel_gram(X, Y, static_kernel=kern))
        # the kernels' exact Gram against the plain wavefront on the same inputs
        K_plain = rt.sigkernel_gram(X, Y, static_kernel=kern, backend="antidiag")
        exact_rel = rel_err(K, K_plain)
        check(exact_rel <= RTOL["float32"],
              f"exact {lift} Gram: rel err {exact_rel:.3g} against the plain wavefront")
        for method in ("rff", "nystroem"):
            for rank in FRONTIER_RANKS:
                f = rt.FeatureConfig(method, rank=rank)
                rt.sigkernel_gram(X, Y, static_kernel=kern, features=f)      # warm
                with dispatch.count_pair_solves() as c:
                    Ka, ms = synced_ms(lambda: rt.sigkernel_gram(X, Y, static_kernel=kern,
                                                                 features=f))
                check(bool(torch.isfinite(Ka).all()), f"{method} {lift} r={rank}: non-finite")
                if method == "rff":
                    check(c.total == 0, f"rff {lift} r={rank}: {c.total} pair solves")
                fro = float(torch.linalg.norm(Ka - K) / torch.linalg.norm(K))
                if method == "nystroem" and f.feature_dim(Bf) == Bf:
                    # the pool is all of X, so the Nyström Gram is the exact one
                    check(fro <= NYSTROEM_FULL_RANK_REL,
                          f"full-rank nystroem {lift} r={rank}: rel fro err {fro:.3g}")
                maps.append({"method": method, "lift": lift, "rank": rank,
                             "feature_dim": f.feature_dim(Bf), "pair_solves": c.total,
                             "rel_fro_err": fro, "ms": ms, "exact_ms": exact_ms,
                             "exact_rel_err_vs_plain": exact_rel})
    grad_rows = []
    for method in ("rff", "nystroem"):
        for lift, kern in (("linear", rt.Linear()), ("rbf", rt.RBF(1.0))):
            f = rt.FeatureConfig(method, rank=32)
            (g,), ms = synced_ms(lambda: grads(
                lambda a: rt.mmd2(a, Y, static_kernel=kern, features=f), X))
            check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
                  f"grad mmd2(features={method}, {lift}): not finite or zero")
            grad_rows.append({"method": method, "lift": lift, "rank": 32, "ms": ms})
    H = torch.from_numpy((rng.normal(size=(32, 128, 256)) * 0.1).astype(np.float32)).to(dev)
    P = torch.from_numpy((rng.normal(size=(256, 8)) * 0.1).astype(np.float32)).to(dev)
    T = torch.from_numpy(random_paths(rng, 32, 128, 8)).to(dev)
    aux = {}
    for method in (None, "rff", "nystroem"):
        f = None if method is None else rt.FeatureConfig(method, rank=32)
        v, ms = synced_ms(lambda: sig_aux_loss(H, T, proj=P, features=f))
        check(bool(torch.isfinite(v)), f"sig_aux_loss({method}): non-finite")
        aux[method or "exact"] = {"value": float(v), "ms": ms}
    counts = kernel.launch_counts()
    shapes = kernel.launch_shapes()
    for kname in ("fwd", "fwd_cps", "bwd", "fwd_fused", "gram_fused"):
        check(counts[kname] > 0, f"features path never launched {kname}")
    emit({"features_path": maps, "grads": grad_rows, "sig_aux_loss": aux, "launches": counts,
          "launches_by_shape": shape_rows(shapes),
          "seconds": round(time.time() - t_phase, 3), "card": name, "power_limit": power})
    return shapes


def serve_phase(rt, dev, rng, reset_all, sig_kernel, name, power) -> None:
    """Phase 10: SigFeatureServer with 128 streams, 32 flush rounds."""
    import torch
    from repro_torch.serve import SigFeatureServer
    from repro_torch.stream import reset_trace_counts
    n_streams, L0, d_, N_ = SERVE
    walks = torch.from_numpy(random_paths(rng, n_streams, L0 + SERVE_ROUNDS * 8, d_)).to(dev)
    reset_all()
    reset_trace_counts()
    t_phase = time.time()
    srv = SigFeatureServer(N_, features=rt.FeatureConfig("rff", rank=128))
    check(srv.device.type == "cuda", f"server on {srv.device}")
    names = [f"s{s}" for s in range(n_streams)]
    _, open_ms = synced_ms(lambda: [srv.open_stream(nm, walks[s, :L0])
                                    for s, nm in enumerate(names)])
    pos = np.full(n_streams, L0)
    flush_ms, q_ms = [], {"signature": [], "logsignature": [], "rolling": [], "features": []}
    for rnd in range(SERVE_ROUNDS):
        ks = rng.integers(1, 9, size=n_streams)
        for s, nm in enumerate(names):
            srv.append(nm, walks[s, pos[s]:pos[s] + ks[s]])
        pos += ks
        n, ms = synced_ms(srv.flush)
        check(n == n_streams, f"flush {rnd} updated {n} streams")
        flush_ms.append(ms)
        for s in rng.choice(n_streams, size=SERVE_QUERIED, replace=False):
            for what, fn in (("signature", lambda: srv.signature(names[s])),
                             ("logsignature", lambda: srv.logsignature(names[s])),
                             ("rolling", lambda: srv.rolling(names[s], SERVE_WINDOW)),
                             ("features", lambda: srv.features(
                                 names[s], window=SERVE_FEATURE_WINDOW))):
                out, ms = synced_ms(fn)
                check(bool(torch.isfinite(out).all()), f"serve {what}: non-finite")
                q_ms[what].append(ms)
    served = torch.stack([srv.signature(nm) for nm in names])
    fresh, fresh_ms = synced_ms(lambda: rt.signature(
        walks[:, :int(pos.max())], N_, lengths=torch.from_numpy(pos)))
    serve_rel = rel_rows(served, fresh)
    check(serve_rel <= PATH_REL, f"serve: signatures rel err {serve_rel:.3g} > {PATH_REL}")
    counts = sig_kernel.launch_counts()
    check(counts["horner"] > 0, "serve path: the fresh recompute never launched horner")
    emit({"serve_path": {"streams": n_streams, "initial_points": L0, "d": d_, "depth": N_,
                         "rounds": SERVE_ROUNDS, "open_ms": open_ms, "flush_ms": flush_ms,
                         "flush_ms_median": float(np.median(flush_ms)),
                         "query_ms_median": {k: float(np.median(v)) for k, v in q_ms.items()},
                         "query_ms_max": {k: float(np.max(v)) for k, v in q_ms.items()},
                         "fresh_signature_ms": fresh_ms, "rel_err": serve_rel,
                         "stats": srv.stats()},
          "launches": counts, "seconds": round(time.time() - t_phase, 3), "card": name,
          "power_limit": power})


def sharded_rank(rank, world, seed) -> dict:
    """Phase 11 on one NCCL rank (on ``cuda:rank``): the cases once with the
    launch counts set to 0 just before and read just after, then each
    against the dense Gram on this card, then timed."""
    import torch
    import torch.distributed as dist
    import repro_torch as rt
    from repro_torch.core import dispatch
    from repro_torch.kernels.sigkernel_pde import kernel
    from repro_torch.launch import make_gram_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    rng = np.random.default_rng(seed)
    B, L, d = SHARDED
    X = torch.from_numpy(random_paths(rng, B, L, d)).to(dev)
    Y = torch.from_numpy(random_paths(rng, B, L, d)).to(dev)
    lx = torch.from_numpy(rng.integers(2, L + 1, size=B)).to(dev)
    ly = torch.from_numpy(rng.integers(2, L + 1, size=B)).to(dev)
    W = torch.from_numpy(rng.normal(size=(B, B)).astype(np.float32)).to(dev)
    mesh = make_gram_mesh()
    rbf = rt.RBF(1.0)
    cases = {
        "linear": ((X, Y), {}),
        "linear_symmetric": ((X,), {}),
        "rbf_row_block16": ((X, Y), {"static_kernel": rbf, "row_block": 16}),
        "rbf_symmetric": ((X,), {"static_kernel": rbf}),
        "linear_ragged": ((X, Y), {"lengths": lx, "lengths_y": ly}),
    }

    def sharded(args, kw):
        return rt.sigkernel_gram_sharded(*args, mesh=mesh, **kw)

    def grad_x(gram):
        return grads(lambda a: (gram(a, Y) * W).sum(), X)[0]

    kernel.reset_launch_counts()
    t_path = time.time()
    got, pairs = {}, {}
    for case, (args, kw) in cases.items():
        with dispatch.count_pair_solves() as c:
            got[case] = sharded(args, kw)
        pairs[case] = c.total
    g = grad_x(lambda a, b: sharded((a, b), {}))
    torch.cuda.synchronize()
    path_s = time.time() - t_path
    counts, shapes = kernel.launch_counts(), kernel.launch_shapes()

    finite = all(bool(torch.isfinite(v).all()) for v in (*got.values(), g))
    rel = {case: rel_err(got[case], rt.sigkernel_gram(*args, **kw))
           for case, (args, kw) in cases.items()}
    grad_rel = rel_err(g, grad_x(rt.sigkernel_gram))
    ms = {case: time_ms(lambda: sharded(args, kw), 5) for case, (args, kw) in cases.items()}
    ms["grad_linear"] = time_ms(lambda: grad_x(lambda a, b: sharded((a, b), {})), 3)
    dense_ms = None
    if world == 1:
        dense_ms = {case: time_ms(lambda: rt.sigkernel_gram(*args, **kw), 5)
                    for case, (args, kw) in cases.items()}
        dense_ms["grad_linear"] = time_ms(lambda: grad_x(rt.sigkernel_gram), 3)
    return {"backend": dist.get_backend(), "mesh": list(mesh.shape), "seconds": path_s,
            "finite": finite, "rel_err": rel, "grad_rel_err": grad_rel, "ms": ms,
            "dense_ms": dense_ms, "pairs": pairs, "launches": counts, "shapes": shapes}


def sharded_phase(name, power) -> dict:
    """Phase 11: the sharded Gram on NCCL groups of 1, 2 and 4 ranks (as
    many as there are cards).  Returns rank 0's Goursat launches by shape,
    each with its launches at each world size."""
    import torch
    from repro_torch.launch import spawn_ranks
    torch.cuda.empty_cache()
    t_phase = time.time()
    B = SHARDED[0]
    n_pairs = B * (B + 1) // 2
    rows, shapes, runs = [], {}, {}
    for world in (w for w in SHARDED_WORLDS if w <= torch.cuda.device_count()):
        t_group = time.time()
        outs = runs[world] = spawn_ranks(sharded_rank, world, (SHARDED_SEED,), backend="nccl",
                                         timeout=600)
        r0 = outs[0]
        for key, n in r0["shapes"].items():
            shapes.setdefault(key, {})[f"sharded_{world}"] = n
        rows.append({"ranks": world, "backend": r0["backend"], "mesh": r0["mesh"],
                     "group_seconds": round(time.time() - t_group, 3),
                     "path_seconds": round(r0["seconds"], 3), "ms": r0["ms"],
                     "dense_ms": r0["dense_ms"],
                     "max_rel_err": {c: max(o["rel_err"][c] for o in outs) for c in r0["rel_err"]},
                     "max_grad_rel_err": max(o["grad_rel_err"] for o in outs),
                     "pairs": r0["pairs"], "launches_rank0": r0["launches"],
                     "launches_by_shape_rank0": shape_rows(r0["shapes"])})
    emit({"sharded_path": rows, "sizes": list(SHARDED), "seconds": round(time.time() - t_phase, 3),
          "card": name, "power_limit": power})
    for world, outs in runs.items():
        for r, o in enumerate(outs):
            at = f"sharded, {world} ranks, rank {r}"
            check(o["backend"] == "nccl", f"{at}: backend {o['backend']}")
            check(o["finite"], f"{at}: non-finite values")
            for case, err in o["rel_err"].items():
                check(err <= SHARDED_REL, f"{at}: {case} rel err {err:.3g} against dense")
            check(o["grad_rel_err"] <= SHARDED_GRAD_REL,
                  f"{at}: gradient rel err {o['grad_rel_err']:.3g} against dense")
            check(o["pairs"]["linear_symmetric"] == n_pairs + (-n_pairs) % world,
                  f"{at}: symmetric pair budget {o['pairs']['linear_symmetric']}")
        for kname in SHARDED_PATH:
            check(outs[0]["launches"][kname] > 0, f"sharded, {world} ranks: never launched {kname}")
    return shapes


def load_gan_example():
    """examples/train_sigkernel_gan_torch.py as a module: phase 12 drives its
    generator, training loss, schedule and evaluation set."""
    import importlib.util
    path = os.path.join(ROOT, "examples", "train_sigkernel_gan_torch.py")
    spec = importlib.util.spec_from_file_location("train_sigkernel_gan_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_phase(dev, reset_all, kernel, name, power) -> list:
    """Phase 12: the generator trainer at the example's full width, the
    dense LM at deepseek-7b's width with its signature-kernel auxiliary loss,
    and the reduced generator's step on the card against the CPU.  Returns
    [(Goursat launch key, {run: launches}, lam)] for the generator's
    (lam = its dyadic refinement) and the LM's (lam = 0) launches."""
    import copy
    import torch
    from repro_torch.core import losses
    from repro_torch.data import TokenLM
    from repro_torch.models import build_model, get_config
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import make_train_step
    ex = load_gan_example()
    torch.cuda.empty_cache()
    reset_all()
    t_phase = time.time()

    # (a) the generator trainer, as the example's main loop runs it
    B, L, d, lam = GAN["batch"], GAN["length"], GAN["dim"], GAN["dyadic"]
    spec = ex.kernel_spec(lam)
    gen = ex.build_generator(ex.generator_config(True), d, ex.NOISE_DIM, device=dev)
    n_gen = sum(p.numel() for p in gen.parameters())
    opt = AdamW(gen.parameters(), lr=cosine_schedule(GAN["lr"], GAN["warmup"], GAN["steps"]),
                weight_decay=0.0)
    eval_noise, eval_real = ex.eval_set(L, d, dev)

    def eval_mmd():
        with torch.no_grad():
            return float(losses.mmd2(gen(eval_noise), eval_real, **spec))

    eval_first = eval_mmd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen_losses, gen_ms, gnorms = [], [], []
    for step in range(GAN["steps"]):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = ex.train_loss(gen, step, B, L, d, lam)
        loss.backward()
        gnorms.append(float(opt.step()["grad_norm"]))
        gen_losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        gen_ms.append((time.perf_counter() - t0) * 1e3)
    gen_peak = torch.cuda.max_memory_allocated()
    eval_last = eval_mmd()
    shapes_gen = kernel.launch_shapes()
    del gen, opt, eval_noise, eval_real
    torch.cuda.empty_cache()

    # (b) the dense LM at deepseek-7b's width, 2 layers, sig_loss on
    cfg = get_config("deepseek-7b").replace(n_layers=LM["layers"], sig_loss=True,
                                            sig_loss_dim=LM["sig_dim"])
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, seed=0, device=dev)
    n_lm = sum(p.numel() for p in model.parameters())
    train_step = make_train_step(model, AdamW(model.parameters(), lr=cosine_schedule(1e-3, 2, 50)),
                                 num_microbatches=LM["microbatches"])
    batch = TokenLM(vocab=cfg.vocab, seq=LM["seq"], batch=LM["batch"],
                    sig_target_dim=cfg.sig_loss_dim, device=dev).batch_at(0)
    lm_steps = []
    for _ in range(LM["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = train_step(batch)
        torch.cuda.synchronize()
        lm_steps.append({**{k: float(v) for k, v in met.items()},
                         "ms": (time.perf_counter() - t0) * 1e3})
    lm_peak = torch.cuda.max_memory_allocated()
    del model, train_step, batch
    torch.cuda.empty_cache()
    counts = kernel.launch_counts()
    shapes = kernel.launch_shapes()
    shapes_lm = {k: n - shapes_gen.get(k, 0) for k, n in shapes.items()
                 if n > shapes_gen.get(k, 0)}

    # (c) the reduced generator: one step's loss and gradients, card against CPU
    Bs, Ls, ds = GAN_SMALL
    gen_cpu = ex.build_generator(ex.generator_config(False), ds, ex.NOISE_DIM, seed=1,
                                 device="cpu")
    gen_card = copy.deepcopy(gen_cpu).to(dev)
    g = torch.Generator().manual_seed(3)
    noise = torch.randn((Bs, Ls, ex.NOISE_DIM), generator=g)
    real = torch.cumsum(torch.randn((Bs, Ls, ds), generator=g) * 0.1, dim=1)

    def loss_and_grads(m, dev_):
        v = losses.mmd2(m(noise.to(dev_)), real.to(dev_), **spec)
        return v, torch.autograd.grad(v, list(m.parameters()))

    v_card, g_card = loss_and_grads(gen_card, dev)
    v_cpu, g_cpu = loss_and_grads(gen_cpu, "cpu")
    card_vs_cpu = {"loss": rel_err(v_card.detach().cpu(), v_cpu.detach()),
                   "grads": max(rel_err(a.cpu(), b) for a, b in zip(g_card, g_cpu))}

    timed = gen_ms[-GAN["timed"]:]
    gen_row = {"params": n_gen, "batch": B, "length": L, "dim": d, "dyadic": lam,
               "time_aug": True, "steps": GAN["steps"], "ms_per_step": gen_ms,
               "ms_per_step_median_last": float(np.median(timed)),
               "paths_per_s": B / (float(np.median(timed)) / 1e3),
               "peak_memory_bytes": gen_peak, "train_mmd2": gen_losses, "grad_norm": gnorms,
               "eval_mmd2_first_last": [eval_first, eval_last]}
    lm_ms = float(np.median([r["ms"] for r in lm_steps[1:]]))
    lm_row = {"config": cfg.name, "params": n_lm, "d_model": cfg.d_model,
              "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
              "compute_dtype": cfg.compute_dtype,
              "reduced": "n_layers 30 -> 2 (float32 Adam state for 7B parameters does not "
                         "fit one card)",
              "seq": LM["seq"], "batch": LM["batch"], "microbatches": LM["microbatches"],
              "steps": lm_steps, "ms_per_step_median_after_first": lm_ms,
              "tokens_per_s": LM["batch"] * LM["seq"] / (lm_ms / 1e3),
              "peak_memory_bytes": lm_peak}
    emit({"train_path": {"generator": gen_row, "lm": lm_row, "card_vs_cpu_rel": card_vs_cpu},
          "launches": counts, "launches_by_shape": shape_rows(shapes),
          "seconds": round(time.time() - t_phase, 3), "card": name, "power_limit": power})

    check(all(np.isfinite(gen_losses + [eval_first, eval_last])),
          f"generator: non-finite losses {gen_losses} / eval {eval_first}, {eval_last}")
    check(eval_last < eval_first,
          f"generator: eval MMD² did not fall ({eval_first} -> {eval_last})")
    lm_losses = [r["loss"] for r in lm_steps]
    check(all(np.isfinite(lm_losses + [r["sig"] for r in lm_steps])),
          f"LM: non-finite loss or sig {lm_steps}")
    check(lm_losses[-1] < lm_losses[0], f"LM: the loss did not fall {lm_losses}")
    for what, err in card_vs_cpu.items():
        check(err <= TRAIN_CARD_CPU_REL,
              f"reduced generator {what}: card against CPU rel err {err:.3g}")
    for kname in TRAIN_PATH:
        check(counts[kname] > 0, f"train path never launched {kname}")
    check(counts["fwd_fused"] + counts["gram_fused"] > 0,
          "train path launched neither fused kernel")
    return ([(k, {"train_generator": n}, lam) for k, n in sorted(shapes_gen.items(), key=str)]
            + [(k, {"train_lm": n}, 0) for k, n in sorted(shapes_lm.items(), key=str)])


def bench_phase(reset_all, kernel, name, power) -> None:
    """Phase 13: the bench suite's smoke mode in-process on the card, the
    launch counts set to 0 just before it and read just after."""
    import torch
    from repro_torch.bench import compare, suite
    torch.cuda.empty_cache()
    t_phase = time.time()
    reset_all()
    doc = suite.run_suite("smoke", repeats=1, device="cuda")
    torch.cuda.synchronize()
    counts = kernel.launch_counts()
    seconds = time.time() - t_phase
    entries = doc["entries"]
    names = [e["name"] for e in entries]
    fp = doc["fingerprint"]
    regressions, _ = compare.compare_docs(doc, doc)
    skipped = [e["name"] for e in entries
               if e["kind"] == "check" and e["derived"].startswith("skipped")]
    emit({"bench_path": {"mode": doc["mode"], "entries": len(entries),
                         "timed": sum(e["kind"] == "time" for e in entries),
                         "checks": sum(e["kind"] == "check" for e in entries),
                         "skipped": skipped, "fingerprint": fp,
                         "suite_wall_seconds": round(doc["wall_seconds"], 3)},
          "launches": counts, "seconds": round(seconds, 3), "card": name,
          "power_limit": power})
    check(doc["schema"] == suite.SCHEMA, f"bench: schema {doc['schema']}")
    check(fp["platform"] == "cuda" and fp["device_kind"] == name
          and fp["power_limit"] == power,
          f"bench: fingerprint {fp} does not name the card {name}, {power}")
    check(len(names) == len(set(names)), "bench: duplicate entry names")
    for b in ("gpu", "gpu_fused"):
        check(f"smoke_gram_{b}" in names, f"bench: no smoke_gram_{b}")
    for want in ("dense_gpu", "dense_gpu_fused", "symmetric_gpu_fused"):
        check(any(n.startswith("table2_gram_") and n.endswith("_" + want) for n in names),
              f"bench: no Gram entry *_{want}")
    check(not skipped, f"bench: checks skipped {skipped}")
    check(regressions == [], f"bench: self-compare {regressions}")
    for kname in ("fwd", "fwd_cps", "bwd", "gram_fused", "fwd_fused"):
        check(counts[kname] > 0, f"bench path never launched {kname}")


def autotune_phase(rt, dev, rng, reset_all, kernel, sig_kernel, sig_ops, name,
                   power) -> list:
    """Phase 14: the autotune cache on a fresh temporary file, the launch
    counts set to 0 just before it and read just after.  Tunes the three
    ops, checks that ``backend="auto"`` takes each stored winner, measures
    both frontiers at the Table 2 Gram, and calls ``sigkernel_gram`` and
    ``mmd2`` (and its gradient) with each of :data:`BUDGETS`, each bit for
    bit the explicit call its resolved point names, with its error against
    the exact Gram.  B5 at the tuning batch is held exactly to its plain
    version here.  Returns ``(launch key, {"autotune": launches}, {(scheme,
    interior dtype)})`` for the Goursat kernels, each with what its launches
    ran at (``kernel.launch_variants()``)."""
    import torch
    from repro_torch.bench import autotune, timer
    from repro_torch.core import dispatch
    from repro_torch.core import transforms as tf
    os.environ[AUTOTUNE_ENV] = os.path.join(CACHE_DIR, "autotune.json")
    autotune.invalidate_memo()
    check(autotune.enabled() and not os.path.exists(os.environ[AUTOTUNE_ENV]),
          "autotune: the phase's cache is not fresh")
    torch.cuda.empty_cache()
    reset_all()
    t_phase = time.time()

    # -- tuning, then "auto" against the stored winner at each key
    tuned = []
    for op, shape in TUNE_SHAPES:
        t0 = time.time()
        winner = autotune.tune(op, shape, device=dev, force=True)
        entry = autotune.cache_entry(op, shape, device=dev)
        check(entry is not None and entry["backend"] == winner
              and entry["machine"] == timer.machine_key(dev), f"autotune {op}: entry {entry}")
        key = autotune.key_shape(op, shape)
        if op == "gram":
            Bx, By, nx, ny, d = key
            a = torch.from_numpy(random_paths(rng, Bx, nx + 1, d)).to(dev)
            b = torch.from_numpy(random_paths(rng, By, ny + 1, d)).to(dev)
            call = lambda be: rt.sigkernel_gram(a, b, backend=be, symmetric=False)
        elif op == "sigkernel":
            nx, ny, d = key
            a = torch.from_numpy(random_paths(rng, 8, nx + 1, d)).to(dev)
            b = torch.from_numpy(random_paths(rng, 8, ny + 1, d)).to(dev)
            call = lambda be: rt.sigkernel(a, b, backend=be)
        else:
            L, d, N = key
            a = torch.from_numpy(random_paths(rng, 8, L + 1, d)).to(dev)
            call = lambda be: rt.signature(a, N, backend=be)
        resolved = dispatch.resolve("auto", op=op, device=dev, shape=key,
                                    dtype=torch.float32, grid_cells=1)
        check(resolved == winner, f"autotune {op}: auto resolves to {resolved}, "
                                  f"the cache holds {winner}")
        auto_out = call("auto")
        check(torch.equal(auto_out, call(winner)),
              f"autotune {op}: backend='auto' differs from backend={winner!r}")
        tuned.append({"op": op, "key": list(key), "winner": winner,
                      "ms": {b_: round(t_ * 1e3, 4) for b_, t_ in entry["timings"].items()},
                      "seconds": round(time.time() - t0, 3)})
    # B5 at the tuning batch (the signature candidate "gpu"), exactly
    L, d, N = autotune.key_shape("signature", TUNE_SHAPES[2][1])
    z = tf.pipeline_increments(torch.from_numpy(random_paths(rng, 8, L + 1, d)).to(dev),
                               rt.TransformPipeline()).contiguous()
    got = sig_kernel.horner(z, N, *sig_ops.geometry(8, L, d, N))
    check(torch.equal(got, sig_kernel.horner_plain(z, N)),
          f"horner at (8, {L + 1}, {d}, {N}) differs from plain")

    # -- both frontiers at the Table 2 Gram
    B, Lp, d = BUDGET_GRAM
    fkey = autotune.key_shape("gram", (B, B, Lp - 1, Lp - 1, d))
    t0 = time.time()
    front = autotune.tune_frontier("gram", fkey, device=dev, force=True)
    front_s = time.time() - t0
    t0 = time.time()
    sfront = autotune.tune_scheme_frontier("gram", fkey, device=dev, force=True)
    sfront_s = time.time() - t0
    for e in (front, sfront):
        check(e["machine"] == timer.machine_key(dev), f"frontier stamp {e['machine']}")
        for p in e.get("frontier", []) + e.get("scheme_frontier", []):
            check(np.isfinite(p["rel_err"]) and p["seconds"] > 0, f"frontier point {p}")
    check(len(sfront["scheme_frontier"]) == len(autotune.scheme_points(fkey)),
          "scheme frontier: a point is missing")

    # -- the budgeted calls on Table 2 data, each against its explicit call
    X = torch.from_numpy(random_paths(rng, B, Lp, d)).to(dev)
    Y = torch.from_numpy(random_paths(rng, B, Lp, d)).to(dev)
    K_exact = rt.sigkernel_gram(X, Y)
    m_exact = rt.mmd2(X, Y, streaming=True)
    budgets = []
    for budget in BUDGETS:
        approx = dispatch.resolve_approx("gram", fkey, torch.float32, device=dev,
                                         error_budget=budget)
        point = None if approx else dispatch.resolve_scheme(
            "gram", fkey, torch.float32, device=dev, error_budget=budget)
        kw, step = {}, 1
        if approx:
            kw = {"features": rt.FeatureConfig(approx[0], rank=approx[1])}
        elif point:
            step = 1 << point[1]
            kw = {"grid": rt.GridConfig(scheme=point[0], interior_dtype=point[2])}
        rt.sigkernel_gram(X, Y, error_budget=budget)   # warm
        K, ms = synced_ms(lambda: rt.sigkernel_gram(X, Y, error_budget=budget))
        K_explicit = rt.sigkernel_gram(X[:, ::step], Y[:, ::step], **kw)
        m = rt.mmd2(X, Y, error_budget=budget)
        m_explicit = rt.mmd2(X[:, ::step], Y[:, ::step], streaming=True, **kw)
        g = grads(lambda a, b: rt.mmd2(a, b, error_budget=budget), X, Y)
        g_explicit = grads(
            lambda a, b: rt.mmd2(a[:, ::step], b[:, ::step], streaming=True, **kw), X, Y)
        what = f"error_budget={budget} -> {approx or point or 'exact'}"
        check(bool(torch.isfinite(K).all()) and bool(torch.isfinite(m)),
              f"{what}: non-finite")
        check(torch.equal(K, K_explicit), f"{what}: the Gram differs from its explicit call")
        check(torch.equal(m, m_explicit), f"{what}: mmd2 differs from its explicit call")
        # a coarsened point slices the paths in each of mmd2's three terms, the
        # explicit call once: the terms' gradients then meet at the full-size
        # leaf instead of at the slice, so float32 sums group differently
        g_err = max(rel_err(u, v) for u, v in zip(g, g_explicit))
        g_tol = 0.0 if step == 1 else GRAD_SLICE_REL
        check(g_err <= g_tol, f"{what}: the mmd2 gradient is {g_err:.3g} from its explicit "
                              f"call's (> {g_tol})")
        budgets.append({
            "budget": budget, "features": list(approx) if approx else None,
            "scheme_point": list(point) if point else None, "gram_ms": ms,
            "gram_rel_fro_err": float(torch.linalg.norm(K - K_exact)
                                      / torch.linalg.norm(K_exact)),
            "mmd2": float(m), "mmd2_exact": float(m_exact),
            "mmd2_rel_err": abs(float(m) - float(m_exact)) / abs(float(m_exact)),
            "values_bit_for_bit_vs_explicit": True, "grad_rel_err_vs_explicit": g_err})
    counts = kernel.launch_counts()
    shapes = kernel.launch_shapes()
    seconds = time.time() - t_phase
    for kname in ("fwd", "fwd_fused", "gram_fused"):
        check(counts[kname] > 0, f"autotune path never launched {kname}")
    check(sig_kernel.launch_counts()["horner"] > 0, "autotune path never launched horner")
    ms_of = lambda e, f: [{**{k: v for k, v in p.items() if k != "seconds"},
                           "ms": round(p["seconds"] * 1e3, 4)} for p in e[f]]
    emit({"autotune_path": {
        "tuned": tuned,
        "frontier": {"key": list(fkey), "exact_backend": front["exact_backend"],
                     "exact_ms": round(front["exact_seconds"] * 1e3, 4),
                     "points": ms_of(front, "frontier"), "seconds": round(front_s, 3)},
        "scheme_frontier": {"key": list(fkey), "exact_backend": sfront["exact_backend"],
                            "exact_ms": round(sfront["exact_seconds"] * 1e3, 4),
                            "points": ms_of(sfront, "scheme_frontier"),
                            "seconds": round(sfront_s, 3)},
        "budgets": budgets},
        "launches": {**counts, **sig_kernel.launch_counts()},
        "launches_by_shape": shape_rows(shapes), "seconds": round(seconds, 3),
        "card": name, "power_limit": power})
    os.environ[AUTOTUNE_ENV] = os.path.join(CACHE_DIR, "bench.json")
    ran_at = kernel.launch_variants()
    check(all(l1 == l2 == 0 for k in ran_at for l1, l2, _, _ in ran_at[k]),
          "autotune path launched a refined grid")
    return [(k, {"autotune": n}, {(s_, i_) for _, _, s_, i_ in ran_at[k]})
            for k, n in sorted(shapes.items(), key=str)]


def lm_param_count(cfg) -> int:
    """Parameters of the dense or hybrid LM of ``cfg``, from its shapes."""
    from repro_torch.models.api import padded_vocab
    from repro_torch.models.transformer import layer_kind
    d, hd, W = cfg.d_model, cfg.hd, cfg.lru_width
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    attn += hd * (cfg.n_heads + 2 * cfg.n_kv_heads) if cfg.qkv_bias else 0
    rec = 3 * d * W + 2 * W * W + 8 * W      # w_x, w_y, w_out; w_a, w_i; conv, biases, Λ
    mlp = (2 if cfg.act == "relu2" else 3) * d * cfg.d_ff
    layers = sum((rec if layer_kind(cfg, i) == "rec" else attn) + mlp + 2 * d
                 for i in range(cfg.n_layers))
    return layers + padded_vocab(cfg) * d * (1 if cfg.tie_embeddings else 2) + d


def serve_depth(cfg, free_bytes: int) -> int:
    """The most layers of ``cfg`` (whole pattern groups cut from the end)
    whose build and bf16 serving fit in ``free_bytes`` with
    :data:`SERVE_LM_HEADROOM` to spare: the build holds the float32 layers
    twice while it stacks them; serving, the float32 master and a bf16
    copy."""
    step = len(cfg.block_pattern) or 1
    n = cfg.n_layers
    while n > step:
        total = lm_param_count(cfg.replace(n_layers=n))
        layers = total - lm_param_count(cfg.replace(n_layers=0))
        if max(8 * layers + 4 * (total - layers), 6 * total) + SERVE_LM_HEADROOM <= free_bytes:
            break
        n -= step
    return n


def event_ms(fn):
    """(fn's result, its ms between CUDA events around it)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_profile(fn, steps: int = 1) -> dict:
    """fn under torch.profiler (CPU and CUDA activities), per step: host ms
    (a synchronise closes it), the kernels' device ms and launches, the
    device's busy share and the five kernels with the most device time.
    A trace that holds no device time gives ``None`` for the device
    numbers ("not measured")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    measured = busy_ms > 0
    return {"host_ms": host_ms / steps,
            "device_ms": busy_ms / steps if measured else None,
            "kernel_launches": sum(e.count for e in kernels) / steps if measured else None,
            "device_busy_share": busy_ms / host_ms if measured else None,
            "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3 / steps]
                               for e in top] if measured else None}


def serve_lm_model(spec, dev, name, power) -> dict:
    """One model of phase 15 at full width: bf16 serving (prefill, then
    greedy decode) timed, then the float32 prefill-against-decode check on
    the same parameters."""
    import gc
    import torch
    from repro_torch.models import build_model, get_config
    from repro_torch.models.api import Model, padded_vocab
    from repro_torch.models.params import tree_items
    from repro_torch.models.transformer import layer_kind
    from repro_torch.serve.step import compute_params, make_decode_step, make_prefill_step
    full = get_config(spec["arch"])
    gc.collect()
    torch.cuda.empty_cache()
    depth = serve_depth(full, torch.cuda.mem_get_info(dev)[0])
    cfg = full.replace(n_layers=depth)
    cut = (None if depth == full.n_layers else
           f"n_layers {full.n_layers} -> {depth} (the full depth does not fit beside what "
           f"the card holds)")
    if cut:
        print(f"serve_lm {cfg.name}: depth cut, {cut}")
    B, P, N = spec["batch"], spec["prompt"], spec["tokens"]
    S, k = spec["check"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    model = build_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    build_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == lm_param_count(cfg),
          f"serve_lm {cfg.name}: {n_params} parameters, the shapes say {lm_param_count(cfg)}")
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, max(P, S)), generator=g, device=dev)

    with torch.inference_mode():
        params = compute_params(model)
        w_bytes = sum(t.numel() * t.element_size() for _, t in tree_items(params))
        prefill = make_prefill_step(model, max_len=P + N + PROFILE_STEPS, params=params)
        decode = make_decode_step(model, params=params)
        _, first_prefill_ms = event_ms(lambda: prefill({"tokens": toks[:, :P]}))
        prefill_prof = device_profile(lambda: prefill({"tokens": toks[:, :P]}))
        (logits, caches), prefill_ms = event_ms(lambda: prefill({"tokens": toks[:, :P]}))
        cache_bytes = sum(t.numel() * t.element_size() for _, t in tree_items(caches))
        finite = [torch.isfinite(logits).all()]
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        out = [nxt]
        torch.cuda.synchronize()
        prefill_peak = torch.cuda.max_memory_allocated(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        events = []
        t_dec = time.perf_counter()
        for t in range(P, P + N):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            nxt, lg, caches = decode(caches, nxt, t)
            ev[1].record()
            events.append(ev)
            finite.append(torch.isfinite(lg).all())
            out.append(nxt)
        torch.cuda.synchronize()
        decode_wall_s = time.perf_counter() - t_dec
        decode_peak = torch.cuda.max_memory_allocated(dev) - held
        decode_ms = [a.elapsed_time(b) for a, b in events]

        def more_steps():
            nonlocal nxt, caches
            for t in range(P + N, P + N + PROFILE_STEPS):
                nxt, _, caches = decode(caches, nxt, t)
        decode_prof = device_profile(more_steps, PROFILE_STEPS)
        gen = torch.cat(out, dim=1)
        all_finite = bool(torch.stack(finite).all())
        in_vocab = bool(((gen >= 0) & (gen < cfg.vocab)).all())
        del params, prefill, decode, caches, logits, lg, out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

        # float32: S tokens at once against S - k then k decode steps
        m32 = Model(cfg.replace(compute_dtype="float32"), model.tree())
        check(m32.embed.table.data_ptr() == model.embed.table.data_ptr(),
              "serve_lm: the float32 model copied the parameters")
        (l_full, _), f32_prefill_ms = event_ms(
            lambda: m32.prefill({"tokens": toks[:, :S], "max_len": S}))
        _, c32 = m32.prefill({"tokens": toks[:, :S - k], "max_len": S})
        for t in range(S - k, S):
            l_dec, c32 = m32.decode(c32, toks[:, t:t + 1], t)
        V = cfg.vocab
        f32_rel = rel_err(l_dec[..., :V], l_full[..., :V])
        del m32, c32, l_full, l_dec
    peak = torch.cuda.max_memory_allocated(dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # bounds at H100 SXM peaks: a decode step reads the bf16 weights but
    # the input embedding table (B rows of it) and the cache slots it
    # attends over, once (the median step's position); the prefill's bf16
    # products at the tensor-core rate, its float32 attention / RG-LRU scan
    # products at the float32 rate
    vp, d = padded_vocab(cfg), cfg.d_model
    embed_bytes = vp * d * 2
    mid = P + N // 2
    kinds = [layer_kind(cfg, i) for i in range(cfg.n_layers)]
    step_bytes = w_bytes - embed_bytes + B * d * 2
    read_slots = {"dense": mid + 1, "attn": min(cfg.attn_window or mid + 1, mid + 1), "rec": 0}
    step_bytes += sum(2 * B * read_slots[kd] * cfg.n_kv_heads * cfg.hd * 2 for kd in kinds)
    step_bytes += sum(B * cfg.lru_width * 4 * 4 * 2 for kd in kinds if kd == "rec")
    decode_bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    layer_params = n_params - vp * d * (1 if cfg.tie_embeddings else 2)
    mm = 2 * B * P * layer_params + 2 * B * d * vp
    f32_ops = 0
    for kd in kinds:
        if kd == "rec":   # per chunk of 64: the (Q, Q, W) weights and their sum
            f32_ops += B * P * 64 * cfg.lru_width * 4
        else:             # QK and PV over the causal (windowed) triangle
            span = min(cfg.attn_window or P, P)
            f32_ops += 2 * 2 * B * cfg.n_heads * cfg.hd * P * span // 2
    prefill_ops_ms = (mm / BF16_FLOPS_PER_S + f32_ops / FP32_FLOPS_PER_S) * 1e3
    prefill_bytes_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    med = float(np.median(decode_ms))
    row = {"config": cfg.name, "family": cfg.family, "params": n_params,
           "n_layers": cfg.n_layers, "d_model": d, "reduced": cut, "compute_dtype": "bfloat16",
           "batch": B, "prompt": P, "decode_steps": N, "build_s": build_s,
           "bf16_weight_bytes": w_bytes, "cache_bytes": cache_bytes,
           "first_prefill_ms": first_prefill_ms, "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": B * P / (prefill_ms / 1e3),
           "prefill_bound_ms": max(prefill_ops_ms, prefill_bytes_ms),
           "prefill_bound_by": "operations" if prefill_ops_ms >= prefill_bytes_ms else "bytes",
           "decode_ms_per_token_median": med, "decode_ms_per_token": decode_ms,
           "decode_tokens_per_s": B / (med / 1e3),
           "decode_wall_tokens_per_s": B * N / decode_wall_s,
           "decode_bound_ms": decode_bound_ms, "decode_bound_by": "bytes",
           "prefill_profile": prefill_prof, "decode_profile_per_step": decode_prof,
           "build_peak_bytes": build_peak, "serve_peak_bytes": prefill_peak,
           "decode_peak_above_held_bytes": decode_peak, "float32_check_peak_bytes": peak,
           "sample": gen[0, :16].tolist(),
           "float32_check": {"S": S, "k": k, "rel_err": f32_rel, "prefill_ms": f32_prefill_ms},
           "card": name, "power_limit": power}
    check(all_finite, f"serve_lm {cfg.name}: non-finite bf16 logits")
    check(in_vocab and tuple(gen.shape) == (B, N + 1),
          f"serve_lm {cfg.name}: tokens {tuple(gen.shape)} outside the vocabulary")
    check(decode_peak <= DECODE_PEAK_SHARE * w_bytes,
          f"serve_lm {cfg.name}: decode took {decode_peak} bytes above what it held, more "
          f"than {DECODE_PEAK_SHARE} of the {w_bytes} bf16 weight bytes (a cast per step?)")
    check(f32_rel <= SERVE_LM_REL,
          f"serve_lm {cfg.name}: float32 prefill of {S} against {S - k} + {k} decode steps, "
          f"rel err {f32_rel:.3g} > {SERVE_LM_REL}")
    return row


def serve_lm_card_vs_cpu(dev) -> dict:
    """The reduced configs of both families (every layout), parameters
    drawn on the CPU in the JAX layout: prefill of 6 tokens and 9 decode
    steps (the hybrid's ring of 8 wraps) on the card against the CPU."""
    import copy
    import torch
    from repro_torch.models import build_model, get_config
    from repro_torch.models.params import tree_items
    out = {}
    for arch, kw in SERVE_LM_REDUCED:
        cfg = get_config(arch).reduced().replace(**kw)
        cpu = build_model(cfg, seed=3, device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        toks = torch.randint(0, cfg.vocab, (2, 15), generator=torch.Generator().manual_seed(4))

        def run(m, where):
            with torch.inference_mode():
                lg, c = m.prefill({"tokens": toks[:, :6].to(where), "max_len": 16})
                steps = [lg]
                for t in range(6, 15):
                    lg, c = m.decode(c, toks[:, t:t + 1].to(where), t)
                    steps.append(lg)
            return torch.cat(steps, dim=1), dict(tree_items(c))

        (a, ca), (b, cb) = run(card, dev), run(cpu, "cpu")
        errs = [rel_err(a.cpu(), b)]
        for leaf, v in cb.items():
            if v.is_floating_point():
                errs.append(rel_err(ca[leaf].cpu(), v))
            else:
                check(torch.equal(ca[leaf].cpu(), v), f"{arch} {kw}: cache {leaf} differs")
        what = f"{arch}{'' if not kw else ' ' + str(kw)}"
        out[what] = max(errs)
        check(out[what] <= SERVE_LM_CARD_CPU_REL,
              f"reduced {what}: card against CPU rel err {out[what]:.3g}")
    return out


def serve_lm_phase(dev, reset_all, kernel, sig_kernel, name, power) -> None:
    """Phase 15: LM serving at full width (:data:`SERVE_LM`), the launch
    counts set to 0 just before and read just after (the serving path
    reaches no hand-written kernel: the JAX package's reaches no Pallas
    kernel), and the reduced configs card against CPU."""
    import torch
    torch.cuda.empty_cache()
    reset_all()
    t_phase = time.time()
    rows = [serve_lm_model(spec, dev, name, power) for spec in SERVE_LM]
    counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
    card_vs_cpu = serve_lm_card_vs_cpu(dev)
    emit({"serve_lm_path": rows, "reduced_card_vs_cpu_rel": card_vs_cpu, "launches": counts,
          "seconds": round(time.time() - t_phase, 3), "card": name, "power_limit": power})


def example_module(name: str):
    """examples/<name>.py, imported by name (the examples directory on
    sys.path, which spawned ranks inherit)."""
    import importlib
    if EXAMPLES_DIR not in sys.path:
        sys.path.insert(0, EXAMPLES_DIR)
    return importlib.import_module(name)


def examples_rank(rank, world, device_type) -> dict:
    """Phase 16 on one rank: the distributed example's ``rank_main``, the
    launch counts set to 0 just before it and read just after."""
    import torch
    from repro_torch.kernels.sigkernel_pde import kernel
    from repro_torch.kernels.signature import kernel as sig_kernel
    ex = example_module("gram_matrix_distributed_torch")
    kernel.reset_launch_counts()
    sig_kernel.reset_launch_counts()
    out = ex.rank_main(rank, world, device_type)
    torch.cuda.synchronize()
    return {**out, "launches": {**kernel.launch_counts(), **sig_kernel.launch_counts()},
            "shapes": kernel.launch_shapes(), "variants": kernel.launch_variants(),
            "horner_shapes": sig_kernel.launch_shapes()}


def examples_phase(dev, reset_all, kernel, sig_kernel, name, power):
    """Phase 16: the four example scripts at their defaults, each's output
    printed; the in-process launch counts set to 0 just before the first
    and read after the third, the distributed example's in each rank (its
    ``rank_main`` under :func:`examples_rank`, then its ``report``).
    Returns ({Goursat key: ({run: launches}, {(lam1, lam2, scheme,
    interior dtype)})}, {Horner key: {run: launches}}) for the in-process
    examples and rank 0."""
    import contextlib
    import io
    import re
    import torch
    from repro_torch.launch import spawn_ranks
    mods = {n: example_module(n) for n in EXAMPLES}
    torch.cuda.empty_cache()
    runs = {}

    def run(n, fn):
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            res = fn()
        torch.cuda.synchronize()
        text = buf.getvalue()
        print(text, end="", flush=True)
        runs[n] = {"seconds": round(time.time() - t0, 3)}
        return res, text

    def errs_of(text):
        return [float(v) for v in re.findall(r"err: ([-+0-9.eE]+)", text)]

    reset_all()
    t_phase = time.time()
    toks, _ = run("serve_lm_torch", lambda: mods["serve_lm_torch"].main([]))
    _, quick = run("quickstart_torch", lambda: mods["quickstart_torch"].main([]))
    st, _ = run("serve_sig_features_torch", lambda: mods["serve_sig_features_torch"].main([]))
    counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
    shapes, variants = kernel.launch_shapes(), kernel.launch_variants()
    hshapes = sig_kernel.launch_shapes()
    world = torch.cuda.device_count()
    dist_ex = mods["gram_matrix_distributed_torch"]

    def distributed():
        outs = spawn_ranks(examples_rank, world, ("cuda",), backend="nccl", timeout=600)
        dist_ex.report(outs)
        return outs

    outs, dist_text = run("gram_matrix_distributed_torch", distributed)
    seconds = time.time() - t_phase
    r0 = outs[0]
    rank_counts = {k_: sum(o["launches"][k_] for o in outs) for k_ in r0["launches"]}
    emit({"examples_path": runs, "world": world, "launches": counts,
          "launches_ranks": rank_counts, "launches_by_shape": shape_rows(shapes),
          "launches_by_shape_rank0": shape_rows(r0["shapes"]),
          "horner_launches_by_shape": [{"shape": list(k_[:4]), "geometry": list(k_[4]),
                                        "launches": n} for k_, n in hshapes.items()],
          "seconds": round(seconds, 3), "card": name, "power_limit": power})

    check(tuple(toks.shape) == (4, 32) and bool(((toks >= 0) & (toks < 256)).all()),
          f"serve_lm_torch: tokens {tuple(toks.shape)}")
    qerr = errs_of(quick)
    check(len(qerr) == 6 and all(0 <= e < EXAMPLES_ERR for e in qerr),
          f"quickstart_torch: error lines {qerr}")
    check("ragged == truncated: True" in quick, "quickstart_torch: ragged != truncated")
    check(st["flushes"] == 64, f"serve_sig_features_torch: {st['flushes']} flushes")
    derr = errs_of(dist_text)
    check(len(derr) == 2 and all(0 <= e < EXAMPLES_ERR for e in derr)
          and all(o["asymmetry"] < EXAMPLES_ERR for o in outs),
          f"gram_matrix_distributed_torch: error lines {derr}")
    check("ranks agree: True" in dist_text and "match: True" in dist_text,
          "gram_matrix_distributed_torch: the ranks or the mmd2 engines disagree")
    for k_ in ("fwd", "fwd_cps", "bwd", "fwd_fused", "gram_fused", "horner"):
        check(counts[k_] > 0, f"examples path never launched {k_}")
    check(rank_counts["gram_fused"] > 0, "distributed example: no rank launched gram_fused")

    goursat = {}
    for log, vlog, run_name in ((shapes, variants, "examples"),
                                (r0["shapes"], r0["variants"], "examples_rank0")):
        for key, n in log.items():
            by_run, ran_at = goursat.setdefault(key, ({}, set()))
            by_run[run_name] = n
            ran_at.update(vlog[key])
    horner = {}
    for log, run_name in ((hshapes, "examples"), (r0["horner_shapes"], "examples_rank0")):
        for key, n in log.items():
            horner.setdefault(key, {})[run_name] = n
    return goursat, horner


def horner_shape_check(key, by_run, sig_kernel, dev, rng, name, power) -> None:
    """The Horner kernel at one shape and geometry it launched at, on fresh
    random increments, exactly against its plain version, timed beside its
    bound."""
    import torch
    B, L, d, N, geo = key
    z = torch.from_numpy(np.diff(random_paths(rng, B, L, d), axis=1)).to(dev).contiguous()
    got = sig_kernel.horner(z, N, *geo)
    want = sig_kernel.horner_plain(z, N)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"horner at {(B, L, d, N)} geometry {geo} differs from plain")
    nbytes = (z.numel() + got.numel()) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = B * (L - 1) * sig_kernel.horner_flops(d, N) / FP32_FLOPS_PER_S * 1e3
    emit({"timing_by_shape": "horner", "shape": [B, L, d, N], "geometry": list(geo),
          "launches": by_run, "max_abs_err": 0.0, "ms": time_ms(lambda: sig_kernel.horner(
              z, N, *geo), 5), "plain_ms": time_ms(lambda: sig_kernel.horner_plain(z, N), 2),
          "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
          else "operations", "card": name, "power_limit": power})


if __name__ == "__main__":
    if sys.argv[1:]:
        sys.exit(f"chip_smoke: takes no arguments, got {sys.argv[1:]}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_") as CACHE_DIR:
        sys.exit(main())
