#!/usr/bin/env python3
"""Drive the PyTorch port's signature and signature-kernel paths, forward and
gradient, its LM serving path, its example scripts, the MoE, SSM,
encoder-decoder and vlm families, the training driver and a device's share
of the multi-pod dry run, on one CUDA card.

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

17. ``moe_path``: the MoE family.  (a) qwen2-moe-a2.7b at its full 24
   layers (width 2048, 60 routed experts top-4 and 4 shared) and dbrx-132b
   (width 6144, 16 experts top-4) at the most layers whose float32 build
   fits (the cut printed), each built in float32 (the build's peak held
   to the tree, one layer and one leaf), cast in place to a bf16 master
   and served from it under ``torch.inference_mode``: 4 prompts of 512
   tokens, 32 greedy tokens.  Prints parameters, bf16 bytes, the build,
   cast and serving peaks, prefill and decode ms (CUDA events, median),
   tokens/s, profiles, the share of assignments prefill's capacity kept,
   each expert's load in the first layer, and the bounds: prefill by the
   bf16 products over the cap slots the dense dispatch computes; decode by
   the bytes of every expert's weights (the dense dispatch reads them all)
   and of the experts the logged steps' tokens routed to.  Checks as phase
   15's, the float32 check at S = 32, k = 8, where both prefills are
   dropless (at the serving shape capacity drops make prefill and decode
   differ by design).  (b) The MoE LM at qwen2-moe-a2.7b's width, 2 layers,
   ``sig_loss`` on: ``make_train_step``, two microbatches on
   ``TokenLM(vocab, 512, 4)``, 5 steps; the loss must fall, ``aux`` stay
   finite and positive, ``sig`` finite; B1-cps, B2 and a fused kernel must
   launch, and every Goursat shape and variant no earlier check took goes
   through ``shape_check``.  (c) The reduced configs (stacked with shared
   experts, per layer without), drawn on the CPU: prefill of 6 and 9
   decode steps, then the loss and every parameter gradient at B·S = 256
   with the routers sharpened (capacity drops), card against CPU within
   1e-4, every router margin >= 1e-4 (``tests/test_torch_moe.py``).

18. ``ssm_path``: the SSM family, mamba2-780m (48 Mamba-2 layers of width
   1536, SSD chunks of 128, 857,846,016 parameters, stacked).  (a) At full
   size in bf16 from the float32 master, as phase 15 serves: 4 prompts of
   2,048 tokens, 64 greedy tokens; phase 15's row fields, profiles and
   checks, with (c) the float32 prefill-against-decode check at S = 2,008,
   k = 8 (both prefills end in a padded chunk) within 1e-4.  (b) One prompt
   of 32,768 tokens (the JAX package's ``prefill_32k``), 32 greedy tokens:
   the decode cache's bytes must be (a)'s for one sequence and a decode
   step at most twice (a)'s (the state is O(1) in the context); its
   prefill is timed but not profiled.  (d) The LM
   at full size, ``sig_loss`` on, remat as configured, bf16 compute:
   ``make_train_step``, two microbatches on ``TokenLM(50280, 512, 4)``, 5
   steps; the loss must fall and ``sig`` stay finite; B1-cps, B2 and a
   fused kernel must launch, and every Goursat shape and variant no earlier
   check took goes through ``shape_check``.  (e) The reduced config per
   layer and stacked, drawn on the CPU: prefill of 13 tokens (chunk 8) and
   9 decode steps with every cache leaf, then the loss and every parameter
   gradient, card against CPU within 1e-4.  Serving must launch no kernel.

19. ``encdec_path``: the encoder-decoder family, whisper-large-v3 (32
   encoder and 32 decoder layers of width 1280, 20 heads of 64, the tied
   table of 51,968 rows, 1,954,370,560 parameters, stacked) at full size.
   (a) bf16 from the float32 master, as phase 15 serves: 4 streams of 1,500
   stub frames (0.1·N(0, 1); the encoder's blocked attention runs two KV
   chunks of 1,024, the second with 548 masked slots), a decoder prompt of
   64 tokens and 64 greedy steps (caches of 128 positions, inside Whisper's
   448); the encoder timed alone, phase 15's row fields, profiles and
   checks, and the prefill and decode bounds from the shapes
   (``encdec_bounds``).  (b) The float32 check at (S, k) = (64, 8) on the
   same frames within 1e-4.  (c) The trainer at full size, ``sig_loss`` on,
   remat, bf16: ``make_train_step``, two microbatches on ``TokenLM(51866,
   448, 4, n_frames=1500)``, 5 steps; the loss must fall and ``sig`` stay
   finite; B1-cps, B2 and a fused kernel must launch, and every Goursat
   shape and variant no earlier check took goes through ``shape_check``.
   (d) The reduced config per layer and stacked, at its 16 frames and at
   1,500, drawn on the CPU: prefill of 6 and 9 decode steps with every
   cache leaf, then the loss and every parameter gradient, card against
   CPU within 1e-4.  Serving must launch no kernel.

20. ``vlm_path``: the vlm family, internvl2-76b (80 dense layers of width
   8192, 64 heads and 8 KV heads of 128, d_ff 28,672, an untied table of
   128,256 rows, ``patch_proj`` (1024, 8192); 70,562,095,104 parameters,
   stacked) at full width, cut in depth.  (a) Built in float32 at the most
   layers whose build and in-place bf16 cast fit (the cut printed), cast to
   a bf16 master (``cast_master_``) and served from it under
   ``torch.inference_mode``: 4 sequences of 512 positions, the first 256
   (``n_patches``) stub patch embeddings (0.1·N(0, 1) of (4, 256, 1024) in
   bf16) projected in place of the tokens, then 32 greedy tokens; phase
   15's row fields and profiles, the build, cast and serving peaks, the
   prefill bound (the bf16 layer products, the patch projection and the
   float32 attention) and the decode bound (the bf16 weights but the input
   table and ``patch_proj``, and the KV slots), each on a line of its own
   beside the card's name and power limit.  (b) The float32
   prefill-against-decode check at (S, k) = (512, 8) on the same patches
   within 1e-4.  (c) The trainer at full width, cut to the layers whose
   weights, gradients, bf16 moments and AdamW temporaries fit (1), one
   microbatch (the JAX package gives a >= 30B-class model one sequence a
   device), ``sig_loss`` on, remat, bf16: ``make_train_step`` on
   ``TokenLM(128256, 512, 4, n_patches=256)``, 5 steps; the loss must fall,
   ``sig`` stay finite and ``patch_proj``'s gradient be finite and nonzero;
   B1-cps, B2 and a fused kernel must launch, and every Goursat shape and
   variant no earlier check took goes through ``shape_check``.  (d) The
   reduced config per layer and stacked, drawn on the CPU, 8 patches on a
   12-token prompt: prefill and 9 decode steps with every cache leaf, then
   the loss and every parameter gradient, card against CPU within 1e-4.
   Serving must launch no kernel.

21. ``driver_path``: the training driver, ``python -m
   repro_torch.launch.train``, at mamba2-780m's full size on phase 18 (d)'s
   cell (``--arch mamba2-780m --sig-loss --batch 4 --seq 512
   --microbatches 2 --steps 3 --ckpt-every 2``), its checkpoints under a
   temporary directory (the free space checked first).  (a) In-process
   (``train(argv)``): each step's ms, split by whether a checkpoint write
   was in flight when it began, the snapshots' ms, the writes' seconds,
   the checkpoint's bytes, the peak memory and each step's loss; B1-cps,
   B2 and a fused kernel must launch (counted by shape).  (b) The step-3
   checkpoint loaded into a fresh model and ``AdamW`` on the card and on
   the CPU: every leaf, ``count`` included, bit for bit the live state;
   this runs while (c)'s first subprocess trains beside it on the card.
   (c) The same command as a subprocess with ``--heartbeat``, SIGTERM once
   the heartbeat reports step >= 1: exit 0, the preemption line, the
   checkpoint at the step reached; the watchdog's ``scan`` reads the
   heartbeat and its ``main`` (timeout 1 s) reports HANG and exits 1; a
   second subprocess resumes to step 3, whose checkpoint, loaded into a
   fresh model on the card, must equal (a)'s live state (and so (a)'s
   checkpoint) bit for bit (the largest relative difference printed).  (d)
   ``quantize_int8`` / ``dequantize`` of the model's largest leaf on the
   card bit for bit the CPU's; ``psum_compressed_tree`` on NCCL groups of 1
   rank (2 and 4 where the cards exist) bit for bit the same arithmetic
   done locally.  Prints the peak bytes on disk.

22. ``dryrun_path``: the multi-pod dry run (``python -m
   repro_torch.launch.dryrun``).  (a) Three CPU subprocesses (started after
   phase 7's timing, niced, one thread each, ``CUDA_VISIBLE_DEVICES`` empty,
   waited for here within :data:`DRYRUN_TIMEOUT`) record mamba2-780m x
   decode_32k at 2x16x16 and 16x16 and sigkernel-workload x sig_gram at
   16x16 on fake devices; each record prints on a line of its own and must
   carry no error, positive flops and bytes, ``null`` in the XLA-only
   fields, collectives for mamba2 (its fsdp gathers) and none for the Gram,
   whose flops must be one device's pairwise products exactly.  (b) Rank
   0's share of mamba2-780m x decode_32k x 16x16 for real on the card, at
   full width (8 sequences: 128 do not split over 256 devices, so the SSM
   rules put the batch on ``data``): its shards zeros on the card, its
   collectives a fake group's (they move nothing); its cache bytes on the
   card and the decode step's flops (``FlopCounterMode``'s formulas, a
   device's share) must equal (a)'s record, and the step's ms (CUDA events,
   median) prints beside its byte bound with the card's name and power
   limit.  Then the same model with random weights (seed 0) at the 1 x 1
   mesh of a real one-rank NCCL group: its parameters, tokens and caches
   DTensors laid out by the sharding rules, a prefill of
   :data:`DRYRUN_PROMPT` tokens for the 8 sequences and one decode step
   run under the rules (the mesh path), held against the plain path on the
   same weights and tokens: the logits of both steps and every cache leaf
   within :data:`DRYRUN_RTOL` of the largest value (bf16 compute).  Serving
   launches no kernel.

23. ``streaming_guard_path``: the streaming-reduction guard
   (``repro_torch.core.gram``) on Table 2 "full" data, X (128, 256, 8) and
   Y (96, 256, 8).  (a) ``mmd2(X, Y, row_block=16)``, value and gradient,
   through ``gpu`` with the linear and the RBF lift and through
   ``gpu_fused`` with the linear lift (the fused kernels take no other):
   the guard passes; its trace seconds on the first call (keys not cached)
   and the host seconds of a second call (keys cached) print; value and
   gradient bit for bit the call without the guard, the Goursat launches by
   shape equal to its.  (b) ``assert_streaming_reduction(..., grad=True)``
   on ``SigKernel(backend="gpu_fused").gram(X, Y).sum()`` raises
   ``StreamingViolation`` naming (128, 96), the card's peak memory rising
   by less than 64 MB (the dense Δ stack it finds would take 6.39 GB in
   float64) and no kernel launching.  (c) ``torch.library.opcheck``
   (schema, fake implementation) of each Goursat op's CUDA implementation
   at one small shape.  Phase 3's streaming ``mmd2`` runs the guard too: it
   is timed, on a line of its own, before the phase's timed path.

Phases 8-23 run after phase 7's timing and before the ``kernels`` line;
each sets the launch counts to 0 just before it and reads them just after
(phase 11 and 16's distributed example in each rank).  ``python3
tools/serving_probe.py --phase 17`` (or 18, 19, 20, 21, 22, 23) runs that phase
alone with its shape checks.  Phase 4 also times the host build of the
``"brackets"`` basis change at d = 16, N = 4.  Every phase reads, and
phases 13 and 14 write, an autotune cache under a temporary directory the
script makes and removes (``REPRO_AUTOTUNE_CACHE``; phase 14 a fresh file),
never the home directory's.  The script takes no arguments.
"""

from __future__ import annotations

import contextlib
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
# phase 17: the MoE family.  (a) Serving at full width, bf16 from a bf16
# master cast in place; "check" as in phase 15, at (S, k) where both
# prefills are dropless (B·S <= 128) and groupable (ROADMAP C9): at the
# serving shape capacity drops make a prefill and decode differ by design
SERVE_MOE = ({"arch": "qwen2-moe-a2.7b", "batch": 4, "prompt": 512, "tokens": 32,
              "check": (32, 8)},
             {"arch": "dbrx-132b", "batch": 4, "prompt": 512, "tokens": 32, "check": (32, 8)})
#: untimed decode steps with the routing logged (the routed-expert bound)
MOE_LOG_STEPS = 4
#: (c) the reduced configs card against CPU: stacked with shared experts,
#: per layer without
MOE_REDUCED = (("qwen2-moe-a2.7b", {"scan_layers": True}), ("dbrx-132b", {}))
#: least gap between a token's k+1 largest router logits, relative
#: (tests/test_torch_moe.py's margin)
MOE_MARGIN = 1e-4
# phase 18: the SSM family.  (a) mamba2-780m at full size serves phase 15's
# recurrentgemma-2b cell; "check" as in phase 15, at (S, k) where both
# prefills (2,000 and 2,008 tokens) end in a padded SSD chunk of 128
SERVE_SSM = {"arch": "mamba2-780m", "batch": 4, "prompt": 2048, "tokens": 64,
             "check": (2008, 8)}
#: (b) one prompt at the JAX package's prefill_32k length
#: (src/repro/launch/shapes.py:25), then greedy steps
SSM_LONG_FULL = 32768
SSM_LONG = {"prompt": SSM_LONG_FULL, "tokens": 32}
#: (b)'s decode ms a token over (a)'s, at most (the SSM state is O(1) in the
#: context; (b) decodes one sequence, (a) four)
SSM_LONG_DECODE_FACTOR = 2.0
#: (e) the reduced config card against CPU, per layer and stacked, on a
#: prompt that ends in a padded chunk of 8
SSM_REDUCED = (("mamba2-780m", {}), ("mamba2-780m", {"scan_layers": True}))
SSM_REDUCED_PROMPT = 13
# phase 19: the encoder-decoder family.  (a) whisper-large-v3 at full size
# (src/repro/configs/whisper_large_v3.py): 1,500 stub frames a stream (the
# conv front end's output length), a decoder prompt and greedy steps well
# inside Whisper's native 448 positions; "check" as in phase 15, on the
# same frames
SERVE_ENCDEC = {"arch": "whisper-large-v3", "batch": 4, "frames": 1500, "prompt": 64,
                "tokens": 64, "check": (64, 8)}
#: (a) timed encoder calls after a first one
ENCODER_REPS = 3
#: (d) the reduced config card against CPU, per layer and stacked, at its
#: 16 frames and at 1,500 (the padded KV chunk of 1,024)
ENCDEC_REDUCED = tuple(("whisper-large-v3", {**layout, "n_audio_frames": F})
                       for layout in ({}, {"scan_layers": True}) for F in (16, 1500))
# phase 20: the vlm family.  (a) internvl2-76b (src/repro/configs/internvl2_76b.py)
# at full width, its depth cut to what the float32 build and the in-place
# bf16 cast fit; each sequence's first n_patches (256) positions are patch
# embeddings; "check" as in phase 15, at (S, k) with S - k >= the patches,
# so that the decoded steps are text
SERVE_VLM = {"arch": "internvl2-76b", "batch": 4, "prompt": 512, "tokens": 32,
             "check": (512, 8)}
#: (d) the reduced config card against CPU, per layer and stacked, its 8
#: patches on a 12-token prompt
VLM_REDUCED = (("internvl2-76b", {}), ("internvl2-76b", {"scan_layers": True}))
VLM_REDUCED_PROMPT = 12
# phase 16: the port's example scripts at their defaults, in this order
EXAMPLES_DIR = os.path.join(ROOT, "examples")
EXAMPLES = ("serve_lm_torch", "quickstart_torch", "serve_sig_features_torch",
            "gram_matrix_distributed_torch")
EXAMPLES_ERR = 1e-4              # every printed error line (the JAX quickstart's bar)
GAN = dict(batch=64, length=256, dim=8, dyadic=1, steps=30, timed=10, lr=1e-5, warmup=20)
LM = dict(layers=2, seq=512, batch=4, microbatches=2, steps=5, sig_dim=4)
#: phase 17 (b): the trainer at qwen2-moe-a2.7b's width, its depth cut, as phase 12's LM
MOE_TRAIN = {**LM, "arch": "qwen2-moe-a2.7b"}
#: phase 18 (d): the trainer at mamba2-780m's full size, as phase 12's LM
SSM_TRAIN = {**LM, "arch": "mamba2-780m", "layers": 48}
#: phase 19 (c): the trainer at whisper-large-v3's full size, 448 decoder
#: tokens (Whisper's native length) on 1,500 frames a sequence
ENCDEC_TRAIN = {**LM, "arch": "whisper-large-v3", "layers": 32, "seq": 448, "frames": 1500}
#: phase 20 (c): the trainer at internvl2-76b's width, 256 patches a sequence,
#: one microbatch (src/repro/launch/shapes.py:99-100: one sequence a device
#: for a >= 30B-class model; an accumulator would cost 8 more bytes a
#: parameter), its depth cut to 1: up to 16 bytes a parameter (the float32
#: master and gradient and bf16 moments, with the bf16 copy and its gradient
#: until the step) and AdamW's four float32 temporaries of a 128,256 x 8,192
#: table (17 GB) fit 2.97 G parameters beside what earlier phases hold (~8
#: GB) and the allocator's fragments, not 2 layers' 3.82 G
VLM_TRAIN = {**LM, "arch": "internvl2-76b", "layers": 1, "microbatches": 1, "patches": 256}
#: phase 21: the training driver (python -m repro_torch.launch.train) on
#: phase 18 (d)'s cell, mamba2-780m at full size; a checkpoint every 2 steps.
#: 3 steps, not 4: each 10.3 GB checkpoint takes ~5 s to copy to the host and
#: ~18 s to write, and the whole smoke must end inside its time limit
DRIVER_ARGV = ("--arch", "mamba2-780m", "--sig-loss", "--batch", "4", "--seq", "512",
               "--microbatches", "2", "--steps", "3", "--ckpt-every", "2", "--log-every", "1")
DRIVER_STEPS = 3
#: the most checkpoints on disk at once: (a)'s two beside the preempted run's
#: first, while (b) restores from (a)'s
DRIVER_DISK_CHECKPOINTS = 3
DRIVER_TIMEOUT = 600             # seconds a driver subprocess may take
DRIVER_COMPRESSION_WORLDS = (1, 2, 4)
#: (a)'s cells: (arch, shape, multi-pod)
DRYRUN_CELLS = (("mamba2-780m", "decode_32k", True), ("mamba2-780m", "decode_32k", False),
                ("sigkernel-workload", "sig_gram", False))
DRYRUN_SHARE = ("mamba2-780m", "decode_32k")   # (b): rank 0's share of its 16x16 record
DRYRUN_TIMEOUT = 600             # seconds from their start the CPU subprocesses may take
DRYRUN_REPS = 2                  # timed decode steps of (b)
DRYRUN_PROMPT = 256              # (b)'s value check: tokens prefilled before its decode step
DRYRUN_RTOL = 1e-2               # ... its logits' and caches' largest difference over the largest value
# phase 23: the streaming guard on Table 2 "full" data, mmd2's row block, the
# (backend, lift) runs, the peak-memory rise allowed while the guard traces
# a dense Gram, and the phase's budget in seconds
GUARD_X = (128, 256, 8)
GUARD_Y = (96, 256, 8)
GUARD_ROW_BLOCK = 16
GUARD_RUNS = (("gpu", "linear"), ("gpu", "rbf"), ("gpu_fused", "linear"))
GUARD_PEAK_BYTES = 64 << 20
GUARD_BUDGET_S = 20.0
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


@contextlib.contextmanager
def guard_timer():
    """``{"seconds", "traces"}`` the streaming guard spends tracing within
    (``gram._dense_intermediates`` timed)."""
    from repro_torch.core import gram
    spent = {"seconds": 0.0, "traces": 0}
    real = gram._dense_intermediates

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            spent["seconds"] += time.perf_counter() - t0
            spent["traces"] += 1

    gram._dense_intermediates = timed
    try:
        yield spent
    finally:
        gram._dense_intermediates = real


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
    # the streaming mmd2's guard, timed on its own: its keys are then cached
    # for the timed path
    with guard_timer() as spent, torch.no_grad():
        t0 = time.time()
        rt.mmd2(X, Y, row_block=16)
        torch.cuda.synchronize()
    # Kxx and Kyy, of one shape, share a key
    check(spent["traces"] >= 2, f"guard: {spent['traces']} traces for mmd2's terms")
    emit({"streaming_guard": "mmd2(X, Y, row_block=16) on (128, 256, 8) x (128, 256, 8)",
          "guard_seconds": spent["seconds"], "traces": spent["traces"],
          "call_seconds": time.time() - t0, "card": name, "power_limit": power})
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

    # phase 22 (a) runs on the CPU beside the card's phases, after the timed
    # kernel phases 2-7
    dryrun_procs = dryrun_start()
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

    # the MoE, SSM, encoder-decoder and vlm trainers' Goursat shapes at each
    # variant no earlier check took
    checked = {(k, 0, "order1", "float32") for k in seen}
    checked |= {(k, l1, s, i) for k, (_, ran) in goursat.items() for l1, _, s, i in ran}
    moe_shapes = moe_phase(dev, reset_all, kernel, sig_kernel, name, power)
    trainer_shape_checks("moe", moe_shapes, checked, kernel, dev, rng, name, power)
    ssm_shapes = ssm_phase(dev, reset_all, kernel, sig_kernel, name, power)
    trainer_shape_checks("ssm", ssm_shapes, checked, kernel, dev, rng, name, power)
    encdec_shapes = encdec_phase(dev, reset_all, kernel, sig_kernel, name, power)
    trainer_shape_checks("encdec", encdec_shapes, checked, kernel, dev, rng, name, power)
    vlm_shapes = vlm_phase(dev, reset_all, kernel, sig_kernel, name, power)
    trainer_shape_checks("vlm", vlm_shapes, checked, kernel, dev, rng, name, power)
    driver_shapes = driver_phase(dev, reset_all, kernel, sig_kernel, name, power)
    trainer_shape_checks("driver", driver_shapes, checked, kernel, dev, rng, name, power)
    dryrun_phase(dryrun_procs, reset_all, kernel, sig_kernel, name, power)
    guard_phase(rt, dev, rng, reset_all, kernel, name, power)

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
    from repro_torch.models import get_config
    from repro_torch.optim import AdamW, cosine_schedule
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
    n_lm, lm_steps, lm_peak = lm_train(cfg, LM, dev)
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


def lm_train(cfg, spec, dev, on_done=None):
    """``spec["steps"]`` steps of ``make_train_step`` (AdamW on a cosine
    schedule, ``spec["microbatches"]`` microbatches) of the LM of ``cfg``,
    built on the card, on one ``TokenLM`` batch of ``spec["batch"]`` ×
    ``spec["seq"]`` tokens (and ``spec["frames"]`` stub frames or
    ``spec["patches"]`` patch embeddings a sequence, where given), the Adam
    moments in ``cfg.moment_dtype``.  ``on_done(model)`` runs after the last
    step.  Returns (parameters, each step's metrics and ms, peak bytes)."""
    import torch
    from repro_torch.data import TokenLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import make_train_step
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(model.parameters(), lr=cosine_schedule(1e-3, 2, 50),
                moment_dtype=cfg.moment_dtype)
    train_step = make_train_step(model, opt, num_microbatches=spec["microbatches"])
    batch = TokenLM(vocab=cfg.vocab, seq=spec["seq"], batch=spec["batch"],
                    n_frames=spec.get("frames", 0), n_patches=spec.get("patches", 0),
                    d_model=cfg.d_model,
                    sig_target_dim=cfg.sig_loss_dim, device=dev).batch_at(0)
    steps = []
    for _ in range(spec["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = train_step(batch)
        torch.cuda.synchronize()
        steps.append({**{k: float(v) for k, v in met.items()},
                      "ms": (time.perf_counter() - t0) * 1e3})
    peak = torch.cuda.max_memory_allocated()
    if on_done:
        on_done(model)
    del model, train_step, opt, batch
    torch.cuda.empty_cache()
    return n_params, steps, peak


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


def layer_param_counts(cfg) -> list:
    """Parameters of each layer of the dense, MoE, SSM or hybrid LM of
    ``cfg``, from its shapes."""
    from repro_torch.models.transformer import layer_kind
    d, W = cfg.d_model, cfg.lru_width

    def mlp(width):
        return (2 if cfg.act == "relu2" else 3) * d * width

    def attn():
        hd = cfg.hd
        return (d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                + (hd * (cfg.n_heads + 2 * cfg.n_kv_heads) if cfg.qkv_bias else 0))

    def ssm():   # in_proj, conv weights and bias, A_log / D / dt_bias, gated norm, out_proj
        d_inner = cfg.ssm_expand * d
        H, N = d_inner // cfg.ssm_head_dim, cfg.ssm_state
        return (d * (2 * d_inner + 2 * N + H) + (cfg.ssm_conv + 1) * (d_inner + 2 * N) + 3 * H
                + d_inner + d_inner * d)

    def moe():   # router, experts, shared experts and their gate
        E, F, ns = cfg.n_experts, cfg.moe_d_ff, cfg.n_shared_experts
        return d * E + 3 * E * d * F + (mlp(ns * F) + d if ns else 0)

    block = {"ssm": lambda: ssm() + d,                       # one norm, no MLP
             "rec": lambda: 3 * d * W + 2 * W * W + 8 * W + mlp(cfg.d_ff) + 2 * d,
             "moe": lambda: attn() + moe() + 2 * d}          # rec: w_x, w_y, w_out; w_a, w_i
    return [block.get(layer_kind(cfg, i), lambda: attn() + mlp(cfg.d_ff) + 2 * d)()
            for i in range(cfg.n_layers)]


def lm_param_count(cfg) -> int:
    """Parameters of the dense, MoE, vlm, SSM or hybrid LM of ``cfg``, from
    its shapes (a vlm's ``patch_proj`` of (1024, d_model) among them)."""
    from repro_torch.models.api import padded_vocab
    d = cfg.d_model
    return (sum(layer_param_counts(cfg)) + padded_vocab(cfg) * d * (1 if cfg.tie_embeddings
                                                                   else 2) + d
            + (1024 * d if cfg.family == "vlm" else 0))


def largest_leaf(cfg) -> int:
    """Elements of the largest parameter of the dense, MoE or vlm LM of
    ``cfg``: an embedding table, a vlm's ``patch_proj``, or a layer's
    largest weight (attention's wq or wo, an MLP weight, the stacked
    experts), times the layer count where the layers are stacked."""
    from repro_torch.models.api import padded_vocab
    from repro_torch.models.transformer import _uniform
    d = cfg.d_model
    mlp = cfg.n_experts * cfg.moe_d_ff if cfg.n_experts else cfg.d_ff
    layer = max(d * cfg.hd * cfg.n_heads, d * mlp)
    return max(padded_vocab(cfg) * d, 1024 * d if cfg.family == "vlm" else 0,
               layer * (cfg.n_layers if _uniform(cfg) else 1))


def serve_depth(cfg, free_bytes: int, serve_bytes: int = 6) -> int:
    """The most layers of ``cfg`` (whole pattern groups cut from the end)
    whose build and bf16 serving fit in ``free_bytes`` with
    :data:`SERVE_LM_HEADROOM` to spare: the build holds the float32
    parameters once and one layer's draw; serving, ``serve_bytes`` a
    parameter (6: a float32 master and a bf16 copy; 2: a bf16 master, cast
    in place by :func:`cast_master_`, whose peak is the float32 tree and a
    bf16 copy of its largest leaf)."""
    step = len(cfg.block_pattern) or 1
    n = cfg.n_layers
    while n > step:
        c = cfg.replace(n_layers=n)
        total = lm_param_count(c)
        build = 4 * (total + max(layer_param_counts(c)))
        cast = 4 * total + 2 * largest_leaf(c) if serve_bytes == 2 else 0
        if max(build, cast, serve_bytes * total) + SERVE_LM_HEADROOM <= free_bytes:
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


def timed_serving(model, params, toks, P: int, N: int, max_len: int, dev,
                  profile_prefill: bool = True, extra=None) -> dict:
    """bf16 serving on the compute tree ``params``: a first prefill of
    ``toks[:, :P]`` (with ``extra``'s inputs, an encdec model's frames), one
    under torch.profiler (unless ``profile_prefill`` is
    false: the profiler's own processing of a 32k-token SSM prefill's
    ~350k launches takes minutes), one timed (CUDA events); N greedy decode
    steps, each timed, then PROFILE_STEPS more under the profiler.
    Returns the timings, peaks, tokens and cache bytes, with the
    steps, the caches, the last token and the next position (``prefill``,
    ``decode``, ``caches``, ``nxt``, ``pos``) for more steps."""
    import torch
    from repro_torch.models.params import tree_items
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    prefill = make_prefill_step(model, max_len=max_len, params=params)
    decode = make_decode_step(model, params=params)
    batch = {"tokens": toks[:, :P], **(extra or {})}
    _, first_prefill_ms = event_ms(lambda: prefill(batch))
    prefill_prof = device_profile(lambda: prefill(batch)) if profile_prefill else None
    (logits, caches), prefill_ms = event_ms(lambda: prefill(batch))
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
    run = {"prefill": prefill, "decode": decode, "caches": caches, "nxt": nxt, "pos": P + N}

    def more_steps():
        for t in range(run["pos"], run["pos"] + PROFILE_STEPS):
            run["nxt"], _, run["caches"] = decode(run["caches"], run["nxt"], t)
    run.update(decode_peak=torch.cuda.max_memory_allocated(dev) - held,
               decode_ms=[a.elapsed_time(b) for a, b in events], decode_wall_s=decode_wall_s,
               decode_profile=device_profile(more_steps, PROFILE_STEPS),
               first_prefill_ms=first_prefill_ms, prefill_ms=prefill_ms,
               prefill_profile=prefill_prof, prefill_peak=prefill_peak, cache_bytes=cache_bytes,
               gen=torch.cat(out, dim=1), all_finite=bool(torch.stack(finite).all()))
    run["pos"] += PROFILE_STEPS
    return run


def serving_row(run, B: int, P: int, N: int) -> dict:
    """The timings, throughputs, profiles and peaks of a ``timed_serving``
    run, as row fields."""
    med = float(np.median(run["decode_ms"]))
    return {"first_prefill_ms": run["first_prefill_ms"], "prefill_ms": run["prefill_ms"],
            "prefill_tokens_per_s": B * P / (run["prefill_ms"] / 1e3),
            "decode_ms_per_token_median": med, "decode_ms_per_token": run["decode_ms"],
            "decode_tokens_per_s": B / (med / 1e3),
            "decode_wall_tokens_per_s": B * N / run["decode_wall_s"],
            "prefill_profile": run["prefill_profile"],
            "decode_profile_per_step": run["decode_profile"],
            "serve_peak_bytes": run["prefill_peak"],
            "decode_peak_above_held_bytes": run["decode_peak"],
            "cache_bytes": run["cache_bytes"], "sample": run["gen"][0, :16].tolist()}


def float32_check(model, cfg, toks, S: int, k: int, extra=None):
    """float32 on the model's own parameters (no copy): the logits of a
    prefill of S tokens against those of a prefill of S - k then k decode
    steps (both prefills with ``extra``'s inputs).  Returns (their relative
    error, the full prefill's ms)."""
    m32 = type(model)(cfg.replace(compute_dtype="float32"), model.tree())
    check(m32.embed.table.data_ptr() == model.embed.table.data_ptr(),
          f"{cfg.name}: the float32 model copied the parameters")
    extra = extra or {}
    (l_full, _), ms = event_ms(lambda: m32.prefill({"tokens": toks[:, :S], "max_len": S,
                                                    **extra}))
    _, c32 = m32.prefill({"tokens": toks[:, :S - k], "max_len": S, **extra})
    for t in range(S - k, S):
        l_dec, c32 = m32.decode(c32, toks[:, t:t + 1], t)
    V = cfg.vocab
    return rel_err(l_dec[..., :V], l_full[..., :V]), ms


def serving_checks(what: str, run, w_bytes: int, f32_rel: float, B: int, N: int, S: int,
                   k: int, vocab: int) -> None:
    """:func:`bf16_checks` and the float32 check within SERVE_LM_REL."""
    bf16_checks(what, run, w_bytes, B, N, vocab)
    check(f32_rel <= SERVE_LM_REL,
          f"{what}: float32 prefill of {S} against {S - k} + {k} decode steps, rel err "
          f"{f32_rel:.3g} > {SERVE_LM_REL}")


def bf16_checks(what: str, run, w_bytes: int, B: int, N: int, vocab: int) -> None:
    """Finite bf16 logits, tokens in the vocabulary, decode's memory rise
    within DECODE_PEAK_SHARE of the bf16 weights."""
    gen = run["gen"]
    check(run["all_finite"], f"{what}: non-finite bf16 logits")
    check(bool(((gen >= 0) & (gen < vocab)).all()) and tuple(gen.shape) == (B, N + 1),
          f"{what}: tokens {tuple(gen.shape)} outside the vocabulary")
    check(run["decode_peak"] <= DECODE_PEAK_SHARE * w_bytes,
          f"{what}: decode took {run['decode_peak']} bytes above what it held, more than "
          f"{DECODE_PEAK_SHARE} of the {w_bytes} bf16 weight bytes (a cast per step?)")


def serve_lm_model(spec, dev, name, power) -> dict:
    """One model of phase 15 at full width: bf16 serving (prefill, then
    greedy decode) timed, then the float32 prefill-against-decode check on
    the same parameters."""
    import gc
    import torch
    from repro_torch.models import build_model, get_config
    from repro_torch.models.params import tree_items
    from repro_torch.serve.step import compute_params
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
        run = timed_serving(model, params, toks, P, N, P + N + PROFILE_STEPS, dev)
        del params, run["prefill"], run["decode"], run["caches"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        f32_rel, f32_prefill_ms = float32_check(model, cfg, toks, S, k)
    peak = torch.cuda.max_memory_allocated(dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    row = {"config": cfg.name, "family": cfg.family, "params": n_params,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "reduced": cut,
           "compute_dtype": "bfloat16", "batch": B, "prompt": P, "decode_steps": N,
           "build_s": build_s, "bf16_weight_bytes": w_bytes, **serving_row(run, B, P, N),
           **serving_bounds(cfg, w_bytes, n_params, B, P, N), "build_peak_bytes": build_peak,
           "float32_check_peak_bytes": peak,
           "float32_check": {"S": S, "k": k, "rel_err": f32_rel, "prefill_ms": f32_prefill_ms},
           "card": name, "power_limit": power}
    serving_checks(f"serve_lm {cfg.name}", run, w_bytes, f32_rel, B, N, S, k, cfg.vocab)
    return row


def serving_bounds(cfg, w_bytes: int, n_params: int, B: int, P: int, N: int,
                   patches: int = 0) -> dict:
    """The prefill and decode bounds of serving ``cfg`` in bf16 (weights of
    ``w_bytes``), B prompts of P positions (the first ``patches`` of them a
    vlm's patch embeddings) then N steps, at H100 SXM peaks.  A decode step
    reads the bf16 weights but the input embedding table (B rows of it) and
    a vlm's ``patch_proj``, and, once, the cache it attends over (the median
    step's KV slots) or carries (the RG-LRU and SSM states and conv windows,
    read and written).  The prefill's bf16 products (the patch projection's
    among them) run at the tensor-core rate, its float32 attention, RG-LRU
    scan and SSD products at the float32 rate."""
    from repro_torch.models.api import padded_vocab
    from repro_torch.models.ssm import ssd_dims
    from repro_torch.models.transformer import layer_kind
    vp, d = padded_vocab(cfg), cfg.d_model
    mid = P + N // 2
    proj = 1024 * d if cfg.family == "vlm" else 0      # patch_proj's parameters
    step_bytes = w_bytes - vp * d * 2 - proj * 2 + B * d * 2
    f32_ops = 0
    for kd in (layer_kind(cfg, i) for i in range(cfg.n_layers)):
        if kd == "ssm":   # a chunk of Q: C·Bᵀ, the (Q, Q, H) weights by x, C·S, the state update
            d_inner, H, N_ = ssd_dims(cfg)
            Q, P_ = min(cfg.ssm_chunk, P), cfg.ssm_head_dim
            step_bytes += 2 * B * (H * N_ * P_ + (cfg.ssm_conv - 1) * (d_inner + 2 * N_)) * 4
            f32_ops += -(-P // Q) * 2 * B * Q * (Q * N_ + Q * H * P_ + 2 * N_ * H * P_)
        elif kd == "rec":   # per chunk of 64: the (Q, Q, W) weights and their sum
            step_bytes += B * cfg.lru_width * 4 * 4 * 2
            f32_ops += B * P * 64 * cfg.lru_width * 4
        else:             # QK and PV over the causal (windowed) triangle
            slots = mid + 1 if kd == "dense" else min(cfg.attn_window or mid + 1, mid + 1)
            step_bytes += 2 * B * slots * cfg.n_kv_heads * cfg.hd * 2
            span = min(cfg.attn_window or P, P)
            f32_ops += 2 * 2 * B * cfg.n_heads * cfg.hd * P * span // 2
    layer_params = n_params - vp * d * (1 if cfg.tie_embeddings else 2) - proj
    mm = 2 * B * P * layer_params + 2 * B * d * vp + 2 * B * patches * proj
    prefill_ops_ms = (mm / BF16_FLOPS_PER_S + f32_ops / FP32_FLOPS_PER_S) * 1e3
    prefill_bytes_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    return {"prefill_bound_ms": max(prefill_ops_ms, prefill_bytes_ms),
            "prefill_bound_by": "operations" if prefill_ops_ms >= prefill_bytes_ms else "bytes",
            "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3, "decode_bound_by": "bytes"}


def reduced_inputs(cfg, B: int, seed: int) -> dict:
    """An encdec config's stub frames on the CPU, {"frames": 0.1·N(0, 1) of
    (B, n_audio_frames, d_model)}, or a vlm config's patch embeddings,
    {"patches": 0.1·N(0, 1) of (B, n_patches, 1024)}; {} for the other
    families."""
    import torch
    g = torch.Generator().manual_seed(seed)
    if cfg.family == "encdec":
        return {"frames": 0.1 * torch.randn((B, cfg.n_audio_frames, cfg.d_model), generator=g)}
    if cfg.family == "vlm":
        return {"patches": 0.1 * torch.randn((B, cfg.n_patches, 1024), generator=g)}
    return {}


def serve_lm_card_vs_cpu(dev, reduced=SERVE_LM_REDUCED, prompt: int = 6) -> dict:
    """The reduced configs ``reduced`` ((arch, config changes) pairs; by
    default both phase 15 families, every layout), parameters drawn on the
    CPU in the JAX layout: prefill of ``prompt`` tokens (and an encdec
    config's frames or a vlm config's patches) and 9 decode steps (at 6, the hybrid's ring of 8
    wraps) on the card against the CPU, the logits and every cache leaf."""
    import copy
    import torch
    from repro_torch.models import build_model, get_config
    from repro_torch.models.params import tree_items
    out = {}
    for arch, kw in reduced:
        cfg = get_config(arch).reduced().replace(**kw)
        cpu = build_model(cfg, seed=3, device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        toks = torch.randint(0, cfg.vocab, (2, prompt + 9),
                             generator=torch.Generator().manual_seed(4))
        frames = reduced_inputs(cfg, 2, 5)

        def run(m, where):
            with torch.inference_mode():
                lg, c = m.prefill({"tokens": toks[:, :prompt].to(where), "max_len": prompt + 10,
                                   **{k_: v.to(where) for k_, v in frames.items()}})
                steps = [lg]
                for t in range(prompt, prompt + 9):
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


@contextlib.contextmanager
def routing_log():
    """Wrap ``repro_torch.models.moe.route`` while a MoE model runs: yields a
    list that gets, for every call (one MoE layer), its router margin
    (``moe.router_margin``) and each expert's kept assignments and
    assignments, (E,) tensors on the call's device."""
    from repro_torch.models import moe
    log, route = [], moe.route

    def logged(p, xg, cfg):
        r = route(p, xg, cfg)
        log.append({"margin": moe.router_margin(r.logits, cfg.n_experts_per_tok),
                    "kept": r.keep.sum((0, 1)), "assigned": r.onehot.sum((0, 1, 2))})
        return r

    moe.route = logged
    try:
        yield log
    finally:
        moe.route = route


def cast_master_(model, dtype) -> None:
    """Each parameter cast to ``dtype`` in place, one at a time (its
    float32 storage freed before the next is cast): the peak is the
    float32 tree and one cast leaf, not two trees."""
    import torch
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.to(dtype)


def build_bf16_master(full, dev, what: str):
    """``full`` at the most layers whose float32 build and in-place bf16 cast
    fit the card (:func:`serve_depth` with ``serve_bytes=2``; the cut
    printed), built on the card in float32 (the build's peak held to the
    tree, one layer and one leaf) and cast in place to a bf16 master
    (:func:`cast_master_`; its peak held to the float32 tree and a bf16 copy
    of the largest leaf).  Returns (the config, the cut or None, the model,
    its parameter count, the build and cast row fields)."""
    import gc
    import torch
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    depth = serve_depth(full, free, serve_bytes=2)
    cfg = full.replace(n_layers=depth, param_dtype="bfloat16")
    cut = (None if depth == full.n_layers else
           f"n_layers {full.n_layers} -> {depth} (the float32 build and in-place bf16 cast of "
           f"more layers do not fit the {free} free bytes)")
    if cut:
        print(f"{what} {cfg.name}: depth cut, {cut}", flush=True)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    model = build_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    build_peak = torch.cuda.max_memory_allocated(dev) - base
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == lm_param_count(cfg),
          f"{what} {cfg.name}: {n_params} parameters, the shapes say {lm_param_count(cfg)}")
    leaf = max(p.numel() for p in model.parameters())
    check(leaf == largest_leaf(cfg),
          f"{what} {cfg.name}: largest leaf {leaf}, the shapes say {largest_leaf(cfg)}")
    build_bound = 4 * (n_params + max(layer_param_counts(cfg)) + leaf)
    check(build_peak <= build_bound,
          f"{what} {cfg.name}: the build peaked at {build_peak} bytes, above the float32 tree, "
          f"one layer and one leaf ({build_bound})")
    torch.cuda.reset_peak_memory_stats(dev)
    cast_master_(model, getattr(torch, cfg.param_dtype))
    torch.cuda.synchronize()
    cast_peak = torch.cuda.max_memory_allocated(dev) - base
    check(cast_peak <= 4 * n_params + 2 * leaf + (64 << 20),
          f"{what} {cfg.name}: the cast to bf16 peaked at {cast_peak} bytes")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return cfg, cut, model, n_params, {"build_s": build_s, "build_peak_bytes": build_peak,
                                       "build_bound_bytes": build_bound,
                                       "cast_peak_bytes": cast_peak}


def serve_moe_model(spec, dev, name, power) -> dict:
    """One model of phase 17 at full width: built in float32 and cast in
    place to a bf16 master (:func:`build_bf16_master`), served from it in
    bf16 (prefill, greedy decode; routing logged on untimed steps), then the
    float32 prefill-against-decode check on the same parameters."""
    import gc
    import torch
    from repro_torch.models import get_config
    from repro_torch.models.api import padded_vocab
    from repro_torch.models.moe import capacity, group_size
    from repro_torch.models.params import tree_items
    from repro_torch.serve.step import compute_params
    cfg, cut, model, n_params, built = build_bf16_master(get_config(spec["arch"]), dev, "moe")
    B, P, N = spec["batch"], spec["prompt"], spec["tokens"]
    S, k = spec["check"]
    E, F_, d, L_ = cfg.n_experts, cfg.moe_d_ff, cfg.d_model, cfg.n_layers
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, max(P, S)), generator=g, device=dev)

    with torch.inference_mode():
        params = compute_params(model)
        check(params["embed"]["table"] is model.embed.table,
              f"moe {cfg.name}: compute_params copied the bf16 master")
        w_bytes = sum(t.numel() * t.element_size() for _, t in tree_items(params))
        run = timed_serving(model, params, toks, P, N, P + N + PROFILE_STEPS + MOE_LOG_STEPS,
                            dev)
        # untimed, with the routing logged: decode steps (the experts each
        # layer's tokens route to), then a prefill (what capacity kept)
        with routing_log() as dec_log:
            for t in range(run["pos"], run["pos"] + MOE_LOG_STEPS):
                run["nxt"], _, run["caches"] = run["decode"](run["caches"], run["nxt"], t)
        used = [int((r["kept"] > 0).sum()) for r in dec_log]
        with routing_log() as pre_log:
            run["prefill"]({"tokens": toks[:, :P]})
        del params, run["prefill"], run["decode"], run["caches"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        # both prefills dropless (B·S <= 128 tokens a group)
        with routing_log() as f32_log:
            f32_rel, f32_prefill_ms = float32_check(model, cfg, toks, S, k)
    peak = torch.cuda.max_memory_allocated(dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    kept_by_layer = [float(r["kept"].sum()) / float(r["assigned"].sum()) for r in pre_log]
    kept = sum(float(r["kept"].sum()) for r in pre_log)
    assigned = sum(float(r["assigned"].sum()) for r in pre_log)
    f32_dropless = all(torch.equal(r["kept"], r["assigned"]) for r in f32_log)
    f32_margin = min(r["margin"] for r in f32_log)

    # bounds at H100 SXM peaks.  Decode by bytes, two ways: the bf16 weights
    # the dense dispatch reads (every expert; not the input embedding, B rows
    # of it) with the KV slots at the median step; and the same with only the
    # experts the logged steps' tokens routed to.  Prefill by operations: the
    # bf16 products over the cap slots the dispatch computes (and its one-hot
    # dispatch / combine products), the float32 attention products
    vp = padded_vocab(cfg)
    expert_bytes = 3 * d * F_ * 2
    mid = P + N // 2
    step_bytes = (w_bytes - vp * d * 2 + B * d * 2
                  + L_ * 2 * B * (mid + 1) * cfg.n_kv_heads * cfg.hd * 2)
    decode_bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    used_per_step = [sum(used[i:i + L_]) for i in range(0, len(used), L_)]
    routed_bytes = step_bytes - L_ * E * expert_bytes + float(np.mean(used_per_step)) * expert_bytes
    routed_bound_ms = routed_bytes / HBM_BYTES_PER_S * 1e3
    T_ = B * P
    g_ = group_size(T_)
    cap = capacity(g_, cfg.n_experts_per_tok, E)
    slots = (T_ // g_) * E * cap
    attn_p = d * cfg.hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    shared = 3 * d * cfg.n_shared_experts * F_ + d if cfg.n_shared_experts else 0
    per_layer = (2 * T_ * (attn_p + d * E + shared) + 2 * slots * 3 * d * F_
                 + 2 * 2 * T_ * E * cap * d)
    mm = L_ * per_layer + 2 * B * d * vp
    f32_ops = L_ * 2 * 2 * B * cfg.n_heads * cfg.hd * P * P // 2
    prefill_ops_ms = (mm / BF16_FLOPS_PER_S + f32_ops / FP32_FLOPS_PER_S) * 1e3
    prefill_bytes_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    first = pre_log[0]
    row = {"config": cfg.name, "family": cfg.family, "params": n_params, "n_layers": L_,
           "d_model": d, "n_experts": E, "experts_per_token": cfg.n_experts_per_tok,
           "n_shared_experts": cfg.n_shared_experts, "reduced": cut,
           "master_dtype": cfg.param_dtype, "compute_dtype": "bfloat16", "batch": B,
           "prompt": P, "decode_steps": N, "bf16_weight_bytes": w_bytes,
           **serving_row(run, B, P, N),
           "prefill_bound_ms": max(prefill_ops_ms, prefill_bytes_ms),
           "prefill_bound_by": "operations" if prefill_ops_ms >= prefill_bytes_ms else "bytes",
           "prefill_capacity": cap, "prefill_slots": slots,
           "prefill_assignments": T_ * cfg.n_experts_per_tok,
           "prefill_kept_share": kept / assigned, "prefill_kept_share_by_layer": kept_by_layer,
           "first_layer_load": {"kept": first["kept"].tolist(),
                                "assigned": first["assigned"].tolist()},
           "decode_bound_ms": decode_bound_ms, "decode_bound_by": "bytes",
           "decode_routed_bound_ms": routed_bound_ms,
           "decode_experts_routed_per_step": used_per_step, **built,
           "float32_check_peak_bytes": peak,
           "float32_check": {"S": S, "k": k, "rel_err": f32_rel, "dropless": f32_dropless,
                             "router_margin": f32_margin, "prefill_ms": f32_prefill_ms},
           "card": name, "power_limit": power}
    check(len(pre_log) == L_ and 0 < kept <= assigned == T_ * cfg.n_experts_per_tok * L_,
          f"moe {cfg.name}: prefill routed {kept} of {assigned} assignments")
    check(f32_dropless, f"moe {cfg.name}: the float32 check's prefills dropped assignments")
    serving_checks(f"moe {cfg.name} (float32 router margin {f32_margin:.3g})", run, w_bytes,
                   f32_rel, B, N, S, k, cfg.vocab)
    return row


def moe_train(dev) -> dict:
    """Phase 17 (b): the MoE LM at qwen2-moe-a2.7b's width, its depth cut,
    ``sig_loss`` on, trained as phase 12 trains the dense LM."""
    from repro_torch.models import get_config
    full = get_config(MOE_TRAIN["arch"])
    cfg = full.replace(n_layers=MOE_TRAIN["layers"], sig_loss=True,
                       sig_loss_dim=MOE_TRAIN["sig_dim"])
    n_params, steps, peak = lm_train(cfg, MOE_TRAIN, dev)
    ms = float(np.median([r["ms"] for r in steps[1:]]))
    return {"config": cfg.name, "params": n_params, "d_model": cfg.d_model,
            "n_experts": cfg.n_experts, "compute_dtype": cfg.compute_dtype,
            "reduced": f"n_layers {full.n_layers} -> {cfg.n_layers} (float32 Adam state for "
                       f"14 B parameters does not fit one card)",
            "seq": MOE_TRAIN["seq"], "batch": MOE_TRAIN["batch"],
            "microbatches": MOE_TRAIN["microbatches"], "steps": steps,
            "ms_per_step_median_after_first": ms,
            "tokens_per_s": MOE_TRAIN["batch"] * MOE_TRAIN["seq"] / (ms / 1e3),
            "peak_memory_bytes": peak}


def sharpen_(model, seed: int) -> None:
    """Routers ×50 and one offset on every embedding row (a direction all
    tokens share), so that a group of 256 overflows its experts."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        table = model.embed.table
        table += (torch.randn(table.shape[1], generator=g) * 0.02).to(table.device)
        for pname, p in model.named_parameters():
            if pname.endswith("moe.router"):
                p *= 50


def moe_card_vs_cpu(dev) -> dict:
    """Phase 17 (c): the reduced MoE configs (stacked with shared experts,
    per layer without), parameters drawn on the CPU: prefill of 6 tokens and
    9 decode steps, then, with the routers sharpened, the loss and every
    parameter gradient at B·S = 256 (capacity drops), card against CPU.
    Every MoE block's router logits must keep the margin."""
    import copy
    import torch
    from repro_torch.models import build_model, get_config
    with routing_log() as log:
        out = {f"serve {k}": v for k, v in serve_lm_card_vs_cpu(dev, MOE_REDUCED).items()}
    margins = [r["margin"] for r in log]
    for arch, kw in MOE_REDUCED:
        cfg = get_config(arch).reduced().replace(**kw)
        cpu = build_model(cfg, seed=3, device="cpu")
        sharpen_(cpu, 6)
        card = copy.deepcopy(cpu).to(dev)
        toks = torch.randint(0, cfg.vocab, (2, 129), generator=torch.Generator().manual_seed(7))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

        def loss_and_grads(m, where):
            with routing_log() as lg_:
                loss, met = m.loss({k_: v.to(where) for k_, v in batch.items()})
            grads = torch.autograd.grad(loss, list(m.parameters()))
            return loss.detach(), met["aux"].detach(), grads, lg_

        la, aa, ga, log_a = loss_and_grads(card, dev)
        lb, ab, gb, log_b = loss_and_grads(cpu, "cpu")
        what = f"train {arch}{'' if not kw else ' ' + str(kw)}"
        out[what] = max([rel_err(la.cpu(), lb), rel_err(aa.cpu(), ab)]
                        + [rel_err(a.cpu(), b) for a, b in zip(ga, gb)])
        kept = [float(r["kept"].sum()) for r in log_b]
        assigned = [float(r["assigned"].sum()) for r in log_b]
        check(all(a < b for a, b in zip(kept, assigned)),
              f"reduced {what}: no capacity drop ({kept} of {assigned})")
        margins += [r["margin"] for r in log_a + log_b]
        check(out[what] <= SERVE_LM_CARD_CPU_REL,
              f"reduced {what}: card against CPU rel err {out[what]:.3g}")
    out["least_router_margin"] = min(margins)
    check(min(margins) >= MOE_MARGIN,
          f"reduced MoE: a near tie in the router logits, margin {min(margins):.3g}")
    return out


def trainer_shape_checks(what: str, shapes, checked: set, kernel, dev, rng, name,
                         power) -> None:
    """shape_check of every (Goursat key, refinement, scheme, interior
    dtype) a phase ran (``shapes``, as :func:`moe_phase` returns them) that
    is not in ``checked``; adds each to ``checked``."""
    for key, by_run, ran_at in shapes:
        for lam1, lam2, scheme, idt in sorted(ran_at):
            check(lam1 == lam2, f"{what}: {key} launched at refinement ({lam1}, {lam2})")
            if (key, lam1, scheme, idt) not in checked:
                shape_check(key, by_run, kernel, fwd_cps, dev, rng, name, power, lam=lam1,
                            variants=((scheme, idt),))
                checked.add((key, lam1, scheme, idt))


def moe_phase(dev, reset_all, kernel, sig_kernel, name, power) -> list:
    """Phase 17: the MoE family served at full width (:data:`SERVE_MOE`),
    trained at qwen2-moe-a2.7b's width (:data:`MOE_TRAIN`) and held card
    against CPU on the reduced configs; the launch counts set to 0 just
    before and read just after (serving reaches no hand-written kernel, the
    trainer's signature-kernel auxiliary loss the Goursat kernels).
    Returns [(Goursat launch key, {run: launches}, the (λ1, λ2, scheme,
    interior dtype) it ran at)]."""
    import torch
    torch.cuda.empty_cache()
    reset_all()
    t_phase = time.time()
    rows = [serve_moe_model(spec, dev, name, power) for spec in SERVE_MOE]
    serve_counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
    train = moe_train(dev)
    card_vs_cpu = moe_card_vs_cpu(dev)
    counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
    shapes, ran_at = kernel.launch_shapes(), kernel.launch_variants()
    emit({"moe_path": {"serve": rows, "train": train, "reduced_card_vs_cpu_rel": card_vs_cpu},
          "serve_launches": serve_counts, "launches": counts,
          "launches_by_shape": shape_rows(shapes), "seconds": round(time.time() - t_phase, 3),
          "card": name, "power_limit": power})
    losses = [r["loss"] for r in train["steps"]]
    check(all(np.isfinite(losses + [r["sig"] for r in train["steps"]])),
          f"moe LM: non-finite loss or sig {train['steps']}")
    check(all(np.isfinite(r["aux"]) and r["aux"] > 0 for r in train["steps"]),
          f"moe LM: aux not finite and positive {train['steps']}")
    check(losses[-1] < losses[0], f"moe LM: the loss did not fall {losses}")
    check(not any(serve_counts.values()), f"moe serving launched a kernel {serve_counts}")
    for kname in TRAIN_PATH:
        check(counts[kname] > 0, f"moe path never launched {kname}")
    check(counts["fwd_fused"] + counts["gram_fused"] > 0, "moe path launched neither fused kernel")
    return [(k, {"moe_train": n}, ran_at[k]) for k, n in sorted(shapes.items(), key=str)]


def serve_ssm_long(spec, base: dict, dev, name, power) -> dict:
    """Phase 18 (b): mamba2-780m at full size, one prompt of
    ``spec["prompt"]`` tokens then ``spec["tokens"]`` greedy steps, as
    phase 15 serves (bf16 on one compute copy) but with no profile of the
    prefill.  The state does not grow
    with the prompt: the decode cache's bytes must be (a)'s (``base``) for
    one sequence, and a decode step at most SSM_LONG_DECODE_FACTOR of
    (a)'s."""
    import gc
    import torch
    from repro_torch.models import build_model, get_config
    from repro_torch.models.params import tree_items
    from repro_torch.serve.step import compute_params
    cfg = get_config(SERVE_SSM["arch"])
    B, P, N = 1, spec["prompt"], spec["tokens"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    model = build_model(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab, (B, P), generator=torch.Generator(device=dev).manual_seed(2),
                         device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        params = compute_params(model)
        w_bytes = sum(t.numel() * t.element_size() for _, t in tree_items(params))
        run = timed_serving(model, params, toks, P, N, P + N + PROFILE_STEPS, dev,
                            profile_prefill=False)
        del params, run["prefill"], run["decode"], run["caches"]
    n_params = sum(p.numel() for p in model.parameters())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    row = {"config": cfg.name, "family": cfg.family, "params": n_params,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "reduced": (None if P == SSM_LONG_FULL else
                       f"prompt {SSM_LONG_FULL} -> {P} (the {SSM_LONG_FULL}-token prefill took "
                       f"over 30 s)"),
           "compute_dtype": "bfloat16", "batch": B, "prompt": P, "decode_steps": N,
           "bf16_weight_bytes": w_bytes, **serving_row(run, B, P, N),
           **serving_bounds(cfg, w_bytes, n_params, B, P, N),
           "seconds": time.time() - t0, "card": name, "power_limit": power}
    bf16_checks(f"ssm {cfg.name} prompt {P}", run, w_bytes, B, N, cfg.vocab)
    check(row["cache_bytes"] * base["batch"] == base["cache_bytes"] * B,
          f"ssm {cfg.name}: the decode cache holds {row['cache_bytes']} bytes after {P} "
          f"tokens, not {base['cache_bytes']} / {base['batch']} as after {base['prompt']}")
    ratio = row["decode_ms_per_token_median"] / base["decode_ms_per_token_median"]
    row["decode_ms_over_a"] = ratio
    check(ratio <= SSM_LONG_DECODE_FACTOR,
          f"ssm {cfg.name}: a decode step after {P} tokens took {ratio:.3g}x one after "
          f"{base['prompt']} (the state is O(1) in the context)")
    return row


def ssm_train(dev) -> dict:
    """Phase 18 (d): the SSM LM at mamba2-780m's full size, ``sig_loss``
    on, trained as phase 12 trains the dense LM."""
    from repro_torch.models import get_config
    full = get_config(SSM_TRAIN["arch"])
    cfg = full.replace(n_layers=SSM_TRAIN["layers"], sig_loss=True,
                       sig_loss_dim=SSM_TRAIN["sig_dim"])
    n_params, steps, peak = lm_train(cfg, SSM_TRAIN, dev)
    ms = float(np.median([r["ms"] for r in steps[1:]]))
    return {"config": cfg.name, "params": n_params, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
            "reduced": None if cfg.n_layers == full.n_layers else
            f"n_layers {full.n_layers} -> {cfg.n_layers}",
            "seq": SSM_TRAIN["seq"], "batch": SSM_TRAIN["batch"],
            "microbatches": SSM_TRAIN["microbatches"], "steps": steps,
            "ms_per_step_median_after_first": ms,
            "tokens_per_s": SSM_TRAIN["batch"] * SSM_TRAIN["seq"] / (ms / 1e3),
            "peak_memory_bytes": peak}


def family_card_vs_cpu(dev, reduced, prompt: int) -> dict:
    """Phases 18 (e), 19 (d) and 20 (d): the reduced configs ``reduced``
    ((arch, config changes) pairs), parameters drawn on the CPU: prefill of
    ``prompt`` tokens and 9 decode steps, every cache leaf compared
    (:func:`serve_lm_card_vs_cpu`), then the loss and every parameter
    gradient on as many tokens (and an encdec config's frames or a vlm
    config's patches), card against CPU."""
    import copy
    import torch
    from repro_torch.models import build_model, get_config
    out = {f"serve {k}": v for k, v in serve_lm_card_vs_cpu(dev, reduced, prompt).items()}
    for arch, kw in reduced:
        cfg = get_config(arch).reduced().replace(**kw)
        cpu = build_model(cfg, seed=3, device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        toks = torch.randint(0, cfg.vocab, (2, prompt + 1),
                             generator=torch.Generator().manual_seed(8))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], **reduced_inputs(cfg, 2, 9)}

        def loss_and_grads(m, where):
            loss, _ = m.loss({k_: v.to(where) for k_, v in batch.items()})
            return loss.detach(), torch.autograd.grad(loss, list(m.parameters()))

        (la, ga), (lb, gb) = loss_and_grads(card, dev), loss_and_grads(cpu, "cpu")
        what = f"train {arch}{'' if not kw else ' ' + str(kw)}"
        out[what] = max([rel_err(la.cpu(), lb)] + [rel_err(a.cpu(), b) for a, b in zip(ga, gb)])
        check(all(bool(torch.isfinite(g).all()) for g in ga), f"reduced {what}: NaN gradients")
        check(out[what] <= SERVE_LM_CARD_CPU_REL,
              f"reduced {what}: card against CPU rel err {out[what]:.3g}")
    return out


def ssm_phase(dev, reset_all, kernel, sig_kernel, name, power) -> list:
    """Phase 18: the SSM family.  mamba2-780m served at full size
    (:data:`SERVE_SSM`, with its float32 check) and on one long prompt
    (:data:`SSM_LONG`), trained at full size (:data:`SSM_TRAIN`) and held
    card against CPU on the reduced config in both layouts; the launch
    counts set to 0 just before and read just after (serving reaches no
    hand-written kernel, the trainer's signature-kernel auxiliary loss the
    Goursat kernels).  Returns [(Goursat launch key, {run: launches}, the
    (λ1, λ2, scheme, interior dtype) it ran at)]."""
    import torch
    torch.cuda.empty_cache()
    reset_all()
    t_phase = time.time()
    serve = serve_lm_model(SERVE_SSM, dev, name, power)
    long_row = serve_ssm_long(SSM_LONG, serve, dev, name, power)
    serve_counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
    train = ssm_train(dev)
    card_vs_cpu = family_card_vs_cpu(dev, SSM_REDUCED, SSM_REDUCED_PROMPT)
    counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
    shapes, ran_at = kernel.launch_shapes(), kernel.launch_variants()
    emit({"ssm_path": {"serve": serve, "long": long_row, "train": train,
                       "reduced_card_vs_cpu_rel": card_vs_cpu},
          "serve_launches": serve_counts, "launches": counts,
          "launches_by_shape": shape_rows(shapes), "seconds": round(time.time() - t_phase, 3),
          "card": name, "power_limit": power})
    losses = [r["loss"] for r in train["steps"]]
    check(all(np.isfinite(losses + [r["sig"] for r in train["steps"]])),
          f"ssm LM: non-finite loss or sig {train['steps']}")
    check(losses[-1] < losses[0], f"ssm LM: the loss did not fall {losses}")
    check(not any(serve_counts.values()), f"ssm serving launched a kernel {serve_counts}")
    for kname in TRAIN_PATH:
        check(counts[kname] > 0, f"ssm path never launched {kname}")
    check(counts["fwd_fused"] + counts["gram_fused"] > 0, "ssm path launched neither fused kernel")
    return [(k, {"ssm_train": n}, ran_at[k]) for k, n in sorted(shapes.items(), key=str)]


def encdec_param_count(cfg) -> int:
    """Parameters of the encoder-decoder of ``cfg``, from its shapes: the
    encoder's layers (attention, the gated MLP, two LayerNorms of scale and
    bias), the decoder's (a cross-attention and a third LayerNorm more),
    the tied table, ``ln_enc`` and ``ln_out`` (and ``sig_proj`` under
    ``sig_loss``)."""
    from repro_torch.models.api import padded_vocab
    d = cfg.d_model
    attn = d * cfg.hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp = 3 * d * cfg.d_ff
    return (cfg.n_enc_layers * (attn + mlp + 4 * d) + cfg.n_layers * (2 * attn + mlp + 6 * d)
            + padded_vocab(cfg) * d + 4 * d + (d * cfg.sig_loss_dim if cfg.sig_loss else 0))


def encdec_bounds(cfg, w_bytes: int, B: int, F: int, P: int, N: int) -> dict:
    """The encoder, prefill and decode bounds of serving ``cfg`` in bf16
    (weights of ``w_bytes``): B streams of F frames, a prompt of P tokens,
    then N steps, at H100 SXM peaks.  The prefill's bf16 products (the
    encoder's layers, the cross K/V over the frames, the decoder's layers
    on the prompt, the last position's logits) run at the tensor-core
    rate, its float32 attention products (the encoder's F × F, the
    decoder's causal P × P and its P × F cross) at the float32 rate.  A
    decode step reads the bf16 weights it uses (each decoder layer but its
    cross wk and wv, the tied table, ``ln_out``), the cross K/V and the
    self-attention KV slots at the median step."""
    from repro_torch.models.api import padded_vocab
    vp, d, hd, H, KV = padded_vocab(cfg), cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    attn, mlp = d * hd * (2 * H + 2 * KV), 3 * d * cfg.d_ff
    kv_proj = 2 * d * hd * KV                    # a layer's cross wk and wv
    enc_mm = 2 * B * F * ne * (attn + mlp)
    enc_f32 = 4 * B * H * hd * F * F * ne
    dec_mm = 2 * B * P * nd * (2 * attn - kv_proj + mlp) + 2 * B * F * nd * kv_proj + 2 * B * d * vp
    dec_f32 = 4 * B * H * hd * nd * (P * P // 2 + P * F)
    enc_ms = (enc_mm / BF16_FLOPS_PER_S + enc_f32 / FP32_FLOPS_PER_S) * 1e3
    prefill_ops_ms = enc_ms + (dec_mm / BF16_FLOPS_PER_S + dec_f32 / FP32_FLOPS_PER_S) * 1e3
    prefill_bytes_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    mid = P + N // 2
    step_bytes = (2 * (nd * (2 * attn - kv_proj + mlp + 6 * d) + vp * d + 2 * d)
                  + 2 * 2 * nd * B * (F + mid + 1) * KV * hd)
    return {"encoder_bound_ms": enc_ms, "encoder_bound_by": "operations",
            "prefill_bound_ms": max(prefill_ops_ms, prefill_bytes_ms),
            "prefill_bound_by": "operations" if prefill_ops_ms >= prefill_bytes_ms else "bytes",
            "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3, "decode_bound_by": "bytes",
            "decode_step_bytes": step_bytes}


def serve_encdec_model(spec, dev, name, power) -> dict:
    """Phase 19 (a) and (b): whisper-large-v3 at full size, bf16 on one
    compute copy: the encoder timed alone, then serving (prefill, greedy
    decode) as phase 15 times it, on ``spec["frames"]`` stub frames a
    stream; then the float32 prefill-against-decode check on the same
    parameters and frames."""
    import gc
    import torch
    from repro_torch.models import build_model, get_config
    from repro_torch.models.params import tree_items
    from repro_torch.serve.step import compute_params
    cfg = get_config(spec["arch"])
    B, F, P, N = spec["batch"], spec["frames"], spec["prompt"], spec["tokens"]
    S, k = spec["check"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    model = build_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    build_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == encdec_param_count(cfg),
          f"encdec {cfg.name}: {n_params} parameters, the shapes say {encdec_param_count(cfg)}")
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, max(P, S)), generator=g, device=dev)
    frames = {"frames": 0.1 * torch.randn((B, F, cfg.d_model), generator=g, device=dev)}

    with torch.inference_mode():
        params = compute_params(model)
        w_bytes = sum(t.numel() * t.element_size() for _, t in tree_items(params))
        enc, first_encoder_ms = event_ms(lambda: model.encode(frames, params))
        check(tuple(enc.shape) == (B, F, cfg.d_model) and enc.dtype == torch.bfloat16
              and bool(torch.isfinite(enc).all()),
              f"encdec {cfg.name}: encoder states {tuple(enc.shape)} {enc.dtype}, or not finite")
        del enc
        encoder_ms = [event_ms(lambda: model.encode(frames, params))[1]
                      for _ in range(ENCODER_REPS)]
        run = timed_serving(model, params, toks, P, N, P + N + PROFILE_STEPS, dev,
                            extra=frames)
        del params, run["prefill"], run["decode"], run["caches"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        f32_rel, f32_prefill_ms = float32_check(model, cfg, toks, S, k, extra=frames)
    peak = torch.cuda.max_memory_allocated(dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    row = {"config": cfg.name, "family": cfg.family, "params": n_params,
           "n_enc_layers": cfg.n_enc_layers, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "reduced": None, "compute_dtype": "bfloat16", "batch": B, "frames": F, "prompt": P,
           "decode_steps": N, "build_s": build_s, "bf16_weight_bytes": w_bytes,
           "first_encoder_ms": first_encoder_ms,
           "encoder_ms_median": float(np.median(encoder_ms)), "encoder_ms": encoder_ms,
           **serving_row(run, B, P, N), **encdec_bounds(cfg, w_bytes, B, F, P, N),
           "build_peak_bytes": build_peak, "float32_check_peak_bytes": peak,
           "float32_check": {"S": S, "k": k, "rel_err": f32_rel, "prefill_ms": f32_prefill_ms},
           "card": name, "power_limit": power}
    serving_checks(f"encdec {cfg.name}", run, w_bytes, f32_rel, B, N, S, k, cfg.vocab)
    return row


def encdec_train(dev) -> dict:
    """Phase 19 (c): the encoder-decoder at whisper-large-v3's full size,
    ``sig_loss`` on, trained as phase 12 trains the dense LM on
    ``ENCDEC_TRAIN["frames"]`` stub frames a sequence (both stacks cut to
    ``ENCDEC_TRAIN["layers"]`` where that is below the full depth)."""
    from repro_torch.models import get_config
    full = get_config(ENCDEC_TRAIN["arch"])
    depth = ENCDEC_TRAIN["layers"]
    cfg = full.replace(n_layers=depth, n_enc_layers=depth, sig_loss=True,
                       sig_loss_dim=ENCDEC_TRAIN["sig_dim"])
    n_params, steps, peak = lm_train(cfg, ENCDEC_TRAIN, dev)
    check(n_params == encdec_param_count(cfg),
          f"encdec trainer: {n_params} parameters, the shapes say {encdec_param_count(cfg)}")
    ms = float(np.median([r["ms"] for r in steps[1:]]))
    return {"config": cfg.name, "params": n_params, "n_enc_layers": cfg.n_enc_layers,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
            "reduced": None if depth == full.n_layers else
            f"n_layers and n_enc_layers {full.n_layers} -> {depth}",
            "seq": ENCDEC_TRAIN["seq"], "frames": ENCDEC_TRAIN["frames"],
            "batch": ENCDEC_TRAIN["batch"], "microbatches": ENCDEC_TRAIN["microbatches"],
            "steps": steps, "ms_per_step_median_after_first": ms,
            "tokens_per_s": ENCDEC_TRAIN["batch"] * ENCDEC_TRAIN["seq"] / (ms / 1e3),
            "frames_per_s": ENCDEC_TRAIN["batch"] * ENCDEC_TRAIN["frames"] / (ms / 1e3),
            "peak_memory_bytes": peak}


def encdec_phase(dev, reset_all, kernel, sig_kernel, name, power) -> list:
    """Phase 19: the encoder-decoder family.  whisper-large-v3 served at
    full size (:data:`SERVE_ENCDEC`, with its float32 check), trained at
    full size (:data:`ENCDEC_TRAIN`) and held card against CPU on the
    reduced config in both layouts at 16 and 1,500 frames; the launch
    counts set to 0 just before and read just after (serving reaches no
    hand-written kernel, the trainer's signature-kernel auxiliary loss the
    Goursat kernels).  Returns [(Goursat launch key, {run: launches}, the
    (λ1, λ2, scheme, interior dtype) it ran at)]."""
    import torch
    torch.cuda.empty_cache()
    reset_all()
    t_phase = time.time()
    serve = serve_encdec_model(SERVE_ENCDEC, dev, name, power)
    serve_counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
    train = encdec_train(dev)
    card_vs_cpu = family_card_vs_cpu(dev, ENCDEC_REDUCED, 6)
    counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
    shapes, ran_at = kernel.launch_shapes(), kernel.launch_variants()
    emit({"encdec_path": {"serve": serve, "train": train, "reduced_card_vs_cpu_rel": card_vs_cpu},
          "serve_launches": serve_counts, "launches": counts,
          "launches_by_shape": shape_rows(shapes), "seconds": round(time.time() - t_phase, 3),
          "card": name, "power_limit": power})
    losses = [r["loss"] for r in train["steps"]]
    check(all(np.isfinite(losses + [r["sig"] for r in train["steps"]])),
          f"encdec: non-finite loss or sig {train['steps']}")
    check(losses[-1] < losses[0], f"encdec: the loss did not fall {losses}")
    check(not any(serve_counts.values()), f"encdec serving launched a kernel {serve_counts}")
    for kname in TRAIN_PATH:
        check(counts[kname] > 0, f"encdec path never launched {kname}")
    check(counts["fwd_fused"] + counts["gram_fused"] > 0,
          "encdec path launched neither fused kernel")
    return [(k, {"encdec_train": n}, ran_at[k]) for k, n in sorted(shapes.items(), key=str)]


def vlm_lines(row, name, power) -> None:
    """Phase 20 (a)'s numbers, a few to a line, each line with the card's
    name and power limit."""
    tag = f"[{name}, {power}]"
    cfg = row["config"]
    prof = row["decode_profile_per_step"]
    gb = 1e9
    print(f"vlm {cfg}: {row['params']} parameters in {row['n_layers']} layers; cut: "
          f"{row['reduced'] or 'none'} {tag}")
    print(f"vlm {cfg}: peaks: build {row['build_peak_bytes'] / gb:.2f} GB, cast "
          f"{row['cast_peak_bytes'] / gb:.2f} GB, serving {row['serve_peak_bytes'] / gb:.2f} GB "
          f"(bf16 weights {row['bf16_weight_bytes'] / gb:.2f} GB) {tag}")
    print(f"vlm {cfg}: prefill of {row['batch']} x ({row['patches']} patches + "
          f"{row['prompt'] - row['patches']} tokens) {row['prefill_ms']:.2f} ms (the first "
          f"{row['first_prefill_ms']:.2f}), bound {row['prefill_bound_ms']:.2f} ms by "
          f"{row['prefill_bound_by']} {tag}")
    print(f"vlm {cfg}: decode {row['decode_ms_per_token_median']:.2f} ms a token (median of "
          f"{row['decode_steps']}), {prof['kernel_launches']} launches a token, device busy "
          f"share {prof['device_busy_share']}, bound {row['decode_bound_ms']:.3f} ms by "
          f"{row['decode_bound_by']} {tag}")
    print(f"vlm {cfg}: {row['decode_tokens_per_s']:.1f} decode tokens/s, "
          f"{row['prefill_tokens_per_s']:.0f} prefill positions/s {tag}", flush=True)


def serve_vlm_model(spec, dev, name, power) -> dict:
    """Phase 20 (a) and (b): internvl2-76b at full width, built in float32
    at the most layers whose build and in-place cast fit and cast to a bf16
    master (:func:`build_bf16_master`), served from it (prefill of
    ``n_patches`` patch embeddings and the rest of the prompt in text, then
    greedy decode) as phase 15 times it; then the float32
    prefill-against-decode check on the same parameters and patches."""
    import gc
    import torch
    from repro_torch.models import get_config
    from repro_torch.models.params import tree_items
    from repro_torch.serve.step import compute_params
    cfg, cut, model, n_params, built = build_bf16_master(get_config(spec["arch"]), dev, "vlm")
    B, P, N, Pn = spec["batch"], spec["prompt"], spec["tokens"], cfg.n_patches
    S, k = spec["check"]
    check(S - k >= Pn, f"vlm {cfg.name}: the float32 check decodes patch positions")
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, max(P, S)), generator=g, device=dev)
    patches = {"patches": 0.1 * torch.randn((B, Pn, 1024), generator=g, device=dev,
                                            dtype=torch.bfloat16)}

    with torch.inference_mode():
        params = compute_params(model)
        check(params["patch_proj"] is model.patch_proj,
              f"vlm {cfg.name}: compute_params copied the bf16 master")
        w_bytes = sum(t.numel() * t.element_size() for _, t in tree_items(params))
        run = timed_serving(model, params, toks, P, N, P + N + PROFILE_STEPS, dev,
                            extra=patches)
        del params, run["prefill"], run["decode"], run["caches"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        f32_rel, f32_prefill_ms = float32_check(model, cfg, toks, S, k, extra=patches)
    peak = torch.cuda.max_memory_allocated(dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    row = {"config": cfg.name, "family": cfg.family, "params": n_params,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "reduced": cut,
           "master_dtype": cfg.param_dtype, "compute_dtype": "bfloat16", "batch": B,
           "prompt": P, "patches": Pn, "decode_steps": N, "bf16_weight_bytes": w_bytes,
           **serving_row(run, B, P, N),
           **serving_bounds(cfg, w_bytes, n_params, B, P, N, patches=Pn), **built,
           "float32_check_peak_bytes": peak,
           "float32_check": {"S": S, "k": k, "rel_err": f32_rel, "prefill_ms": f32_prefill_ms},
           "card": name, "power_limit": power}
    serving_checks(f"vlm {cfg.name}", run, w_bytes, f32_rel, B, N, S, k, cfg.vocab)
    vlm_lines(row, name, power)
    return row


def vlm_train(dev) -> dict:
    """Phase 20 (c): the vlm LM at internvl2-76b's width, its depth cut,
    ``sig_loss`` on, one microbatch with ``VLM_TRAIN["patches"]`` patch
    embeddings a sequence, trained as phase 12 trains the dense LM.
    ``patch_proj``'s gradient after the last step must be finite and
    nonzero."""
    import gc
    import torch
    from repro_torch.models import get_config
    full = get_config(VLM_TRAIN["arch"])
    cfg = full.replace(n_layers=VLM_TRAIN["layers"], sig_loss=True,
                       sig_loss_dim=VLM_TRAIN["sig_dim"])
    check(cfg.n_patches == VLM_TRAIN["patches"] <= VLM_TRAIN["seq"],
          f"vlm trainer: {VLM_TRAIN['patches']} patches against the config's {cfg.n_patches}")
    grad = {}

    def patch_grad(model):
        gp = model.patch_proj.grad
        grad.update(finite=bool(torch.isfinite(gp).all()), abs_max=float(gp.abs().max()))

    gc.collect()
    torch.cuda.empty_cache()
    n_params, steps, peak = lm_train(cfg, VLM_TRAIN, dev, on_done=patch_grad)
    check(n_params == lm_param_count(cfg) + cfg.d_model * cfg.sig_loss_dim,
          f"vlm trainer: {n_params} parameters, the shapes say "
          f"{lm_param_count(cfg) + cfg.d_model * cfg.sig_loss_dim}")
    ms = float(np.median([r["ms"] for r in steps[1:]]))
    return {"config": cfg.name, "params": n_params, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
            "moment_dtype": cfg.moment_dtype,
            "reduced": f"n_layers {full.n_layers} -> {cfg.n_layers} (the float32 master and "
                       f"gradient, bf16 moments, the bf16 copy and its gradient, up to 16 bytes "
                       f"a parameter, and AdamW's float32 temporaries fit one layer on one card)",
            "seq": VLM_TRAIN["seq"], "patches": VLM_TRAIN["patches"],
            "batch": VLM_TRAIN["batch"], "microbatches": VLM_TRAIN["microbatches"],
            "steps": steps, "ms_per_step_median_after_first": ms,
            "tokens_per_s": VLM_TRAIN["batch"] * VLM_TRAIN["seq"] / (ms / 1e3),
            "patch_proj_grad": grad, "peak_memory_bytes": peak}


def vlm_phase(dev, reset_all, kernel, sig_kernel, name, power) -> list:
    """Phase 20: the vlm family.  internvl2-76b served at full width cut in
    depth (:data:`SERVE_VLM`, with its float32 check), trained at full width
    cut to one layer (:data:`VLM_TRAIN`) and held card against CPU on the
    reduced config in both layouts; the launch counts set to 0 just before
    and read just after (serving reaches no hand-written kernel, the
    trainer's signature-kernel auxiliary loss the Goursat kernels).  Returns
    [(Goursat launch key, {run: launches}, the (λ1, λ2, scheme, interior
    dtype) it ran at)]."""
    import torch
    torch.cuda.empty_cache()
    reset_all()
    t_phase = time.time()
    serve = serve_vlm_model(SERVE_VLM, dev, name, power)
    serve_counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
    train = vlm_train(dev)
    card_vs_cpu = family_card_vs_cpu(dev, VLM_REDUCED, VLM_REDUCED_PROMPT)
    counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
    shapes, ran_at = kernel.launch_shapes(), kernel.launch_variants()
    emit({"vlm_path": {"serve": serve, "train": train, "reduced_card_vs_cpu_rel": card_vs_cpu},
          "serve_launches": serve_counts, "launches": counts,
          "launches_by_shape": shape_rows(shapes), "seconds": round(time.time() - t_phase, 3),
          "card": name, "power_limit": power})
    tag = f"[{name}, {power}]"
    print(f"vlm trainer: {train['params']} parameters, cut {train['reduced']}; "
          f"{train['ms_per_step_median_after_first']:.1f} ms a step, "
          f"{train['tokens_per_s']:.0f} positions/s, peak {train['peak_memory_bytes'] / 1e9:.2f} "
          f"GB {tag}", flush=True)
    losses = [r["loss"] for r in train["steps"]]
    check(all(np.isfinite(losses + [r["sig"] for r in train["steps"]])),
          f"vlm LM: non-finite loss or sig {train['steps']}")
    check(losses[-1] < losses[0], f"vlm LM: the loss did not fall {losses}")
    check(train["patch_proj_grad"]["finite"] and train["patch_proj_grad"]["abs_max"] > 0,
          f"vlm LM: patch_proj's gradient {train['patch_proj_grad']}")
    check(not any(serve_counts.values()), f"vlm serving launched a kernel {serve_counts}")
    for kname in TRAIN_PATH:
        check(counts[kname] > 0, f"vlm path never launched {kname}")
    check(counts["fwd_fused"] + counts["gram_fused"] > 0, "vlm path launched neither fused kernel")
    return [(k, {"vlm_train": n}, ran_at[k]) for k, n in sorted(shapes.items(), key=str)]


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (floats compared as integers)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return torch.equal(a, b)


class DiskPeak:
    """The most bytes of files under ``root`` at once, sampled on a thread
    every ``interval`` seconds while the context is open."""

    def __init__(self, root: str, interval: float = 0.2):
        self.root, self.interval, self.peak = root, interval, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def sample(self) -> int:
        total = 0
        for top, _, files in os.walk(self.root):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(top, f))
                except FileNotFoundError:     # removed by the keep-last-k collection
                    pass
        self.peak = max(self.peak, total)
        return total

    def _run(self):
        while not self._stop.wait(self.interval):
            self.sample()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.sample()


def driver_in_process(argv):
    """Phase 21 (a): ``repro_torch.launch.train.train(argv)`` in this
    process, each step timed between CUDA synchronisations with whether a
    checkpoint write was in flight when it began.  Returns (model,
    optimizer, the steps' rows, the checkpoint manager's timings)."""
    import torch
    from repro_torch.launch import train as drv
    rows, managers = [], []
    make, manager = drv.make_train_step, drv.CheckpointManager

    def timed_make(model, opt, **kw):
        step_fn = make(model, opt, **kw)

        def step(batch):
            writing = any(t.name.startswith("checkpoint-writer") and t.is_alive()
                          for t in threading.enumerate())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = step_fn(batch)
            torch.cuda.synchronize()
            rows.append({"ms": (time.perf_counter() - t0) * 1e3, "write_in_flight": writing,
                         **{k: float(v) for k, v in met.items()}})
            return met
        return step

    class Recorded(manager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            managers.append(self)

    drv.make_train_step, drv.CheckpointManager = timed_make, Recorded
    try:
        model, opt = drv.train(list(argv))
    finally:
        drv.make_train_step, drv.CheckpointManager = make, manager
    return model, opt, rows, managers[0].timings


def zeros_model(cfg, device):
    """A fresh model of ``cfg`` on ``device`` with every parameter zero:
    the parameter tree's shapes come from the initialiser under
    ``FakeTensorMode`` (no draws)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.api import EncDecModel, Model, init_params
    from repro_torch.models.params import tree_map
    with FakeTensorMode():
        fake = init_params(torch.Generator().manual_seed(0), cfg)
    tree = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), fake)
    return (EncDecModel if cfg.family == "encdec" else Model)(cfg, tree)


def restore_into_fresh(cfg, ckpt_dir: str, step: int, live: dict, device) -> dict:
    """Phase 21 (b) and (c): the checkpoint of ``step`` loaded into a fresh
    (zero) model and ``AdamW`` on ``device``; every leaf against ``live``
    ({name: tensor} of a live state), bit for bit, with the largest
    relative difference (of the live leaf's largest magnitude) where a leaf
    differs."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.params import tree_items
    from repro_torch.optim import AdamW
    t0 = time.time()
    fresh = zeros_model(cfg, device)
    opt = AdamW(fresh.parameters(), lr=lambda step: 0.0, moment_dtype=cfg.moment_dtype)
    (params, state), got_step = CheckpointManager(ckpt_dir).restore(
        step, (fresh.tree(), opt.state_tree(fresh.tree())), device=device)
    with torch.no_grad():
        for (_, p), (_, v) in zip(tree_items(fresh.tree()), tree_items(params)):
            p.copy_(v)
    opt.load_state_tree(fresh.tree(), state)
    del params, state
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.time() - t0
    st = opt.state_tree(fresh.tree())
    loaded = {**{f"0/{k}": v for k, v in tree_items(fresh.tree())},
              **{f"1/{k}": v for k, v in tree_items(st)}}
    differ, worst = [], 0.0
    for k, v in live.items():
        got, want = loaded[k].detach(), v.detach().to(loaded[k].device)
        if not same_bits(got, want):
            differ.append(k)
            worst = max(worst, rel_err(got.double(), want.double()))
    out = {"device": str(device), "step": got_step, "seconds": seconds, "leaves": len(loaded),
           "count": int(st["count"]), "differing_leaves": len(differ),
           "first_differing": differ[:5], "max_rel_diff": worst}
    del fresh, opt, st, loaded
    return out


def compression_rank(rank, world, seed, shape) -> dict:
    """Phase 21 (d) on one NCCL rank (``cuda:rank``): ``psum_compressed_tree``
    of this rank's gradient and error-feedback trees (the largest leaf of
    ``shape``, a vector and a scalar, drawn on the card from (seed, rank))
    against the same arithmetic done locally over every rank's inputs:
    each rank's dequantised int8, summed in rank order, over n."""
    import torch
    from repro_torch.optim import dequantize, psum_compressed_tree, quantize_int8
    dev = torch.device("cuda", rank)

    def inputs(r):
        g = torch.Generator(device=dev).manual_seed(seed * 1000 + r)
        shapes = {"largest": tuple(shape), "vector": (shape[-1],), "scalar": ()}
        grads = {k: torch.randn(s, generator=g, device=dev) for k, s in shapes.items()}
        ef = {k: 1e-3 * torch.randn(s, generator=g, device=dev) for k, s in shapes.items()}
        return grads, ef

    grads, ef = inputs(rank)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, ef_new = psum_compressed_tree(grads, ef)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out = {"ms": ms, "equal": {}}
    for k in grads:
        deq, mine = [], None
        for r in range(world):
            g_r, e_r = (grads, ef) if r == rank else inputs(r)
            x = g_r[k] + e_r[k]
            d = dequantize(*quantize_int8(x))
            deq.append(d)
            if r == rank:
                mine = x - d
            del g_r, e_r, x
        want = torch.stack(deq).sum(dim=0) / world
        out["equal"][k] = same_bits(mean[k], want) and same_bits(ef_new[k], mine)
        del deq, want, mine
    return out


def preempted_run(cmd, env, hb: str) -> dict:
    """Phase 21 (c)'s first subprocess: ``cmd`` started, sent SIGTERM once
    its heartbeat ``hb`` reports step >= 1, and waited for.  Returns its
    output, exit code, and the seconds to the signal and to its end."""
    import signal
    from repro_torch.launch import watchdog
    t0 = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env=env)
    try:
        deadline = time.monotonic() + DRIVER_TIMEOUT
        while not any(b["step"] >= 1 for b in watchdog.scan(hb)):
            if proc.poll() is not None:
                raise SmokeFailure("driver: the run ended before step 1: "
                                   + "".join(proc.communicate()))
            check(time.monotonic() < deadline, "driver: no heartbeat at step >= 1")
            time.sleep(0.05)
        t_signal = time.time() - t0
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=DRIVER_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return {"stdout": stdout, "stderr": stderr, "returncode": proc.returncode,
            "signal_after_s": t_signal, "seconds": time.time() - t0}


def driver_phase(dev, reset_all, kernel, sig_kernel, name, power) -> list:
    """Phase 21: the training driver at mamba2-780m's full size on phase 18
    (d)'s cell (:data:`DRIVER_ARGV`).  (a) In-process, the launch counts set
    to 0 just before and read just after, a checkpoint every 2 steps into a
    temporary directory; (b) the last checkpoint restored into a fresh
    model and AdamW on the card and on the CPU, bit for bit; (c) the same
    command as a subprocess with a heartbeat, SIGTERM once it reports step
    >= 1, the watchdog on its heartbeat, then a resume to the last step in a second
    subprocess, its checkpoint against (a)'s; (d) int8 compression on the
    card against the CPU, and ``psum_compressed_tree`` on NCCL groups.
    Returns [(Goursat launch key, {run: launches}, the (λ1, λ2, scheme,
    interior dtype) it ran at)]."""
    import contextlib
    import io
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from repro_torch.launch import spawn_ranks, watchdog
    from repro_torch.launch.train import parser
    from repro_torch.models import get_config
    from repro_torch.models.params import tree_items
    from repro_torch.optim import dequantize, quantize_int8
    torch.cuda.empty_cache()
    t_phase = time.time()
    args = parser().parse_args(list(DRIVER_ARGV))
    cfg = get_config(args.arch)
    cfg = (cfg.reduced() if args.reduced else cfg).replace(sig_loss=args.sig_loss)
    n_params = lm_param_count(cfg) + cfg.d_model * cfg.sig_loss_dim
    ckpt_bytes = 3 * 4 * n_params + 4
    root = tempfile.mkdtemp(prefix="chip_smoke_driver_")
    out = {"config": cfg.name, "params": n_params, "argv": list(DRIVER_ARGV)}
    try:
        free = shutil.disk_usage(root).free
        need = DRIVER_DISK_CHECKPOINTS * ckpt_bytes
        print(f"driver: {free / 1e9:.2f} GB free under {root}, {need / 1e9:.2f} GB needed "
              f"({DRIVER_DISK_CHECKPOINTS} checkpoints of {ckpt_bytes / 1e9:.3f} GB)", flush=True)
        check(free >= need, f"driver: {free} bytes free under {root}, {need} needed "
              f"({DRIVER_DISK_CHECKPOINTS} checkpoints of {ckpt_bytes} bytes)")
        dir_a, dir_c = os.path.join(root, "a"), os.path.join(root, "c")
        with DiskPeak(root) as disk:
            # (a) the driver in this process
            t0 = time.time()
            torch.cuda.reset_peak_memory_stats()
            reset_all()
            model, opt, steps, timings = driver_in_process(
                list(DRIVER_ARGV) + ["--ckpt-dir", dir_a])
            counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
            shapes, ran_at = kernel.launch_shapes(), kernel.launch_variants()
            peak = torch.cuda.max_memory_allocated()
            last = os.path.join(dir_a, f"step_{DRIVER_STEPS}")
            on_disk = sum(os.path.getsize(os.path.join(last, f)) for f in os.listdir(last))
            largest = tuple(max(model.parameters(), key=lambda p: p.numel()).shape)
            out["train"] = {
                "seconds": time.time() - t0, "steps": steps,
                "ms_with_write_in_flight": [r["ms"] for r in steps if r["write_in_flight"]],
                "ms_without_write": [r["ms"] for r in steps if not r["write_in_flight"]],
                "saves": timings, "checkpoint_bytes_on_disk": on_disk,
                "checkpoint_bytes_predicted": ckpt_bytes, "peak_memory_bytes": peak,
                "largest_leaf": list(largest), "steps_on_disk": sorted(os.listdir(dir_a))}
            check(sum(p.numel() for p in model.parameters()) == n_params,
                  f"driver: {sum(p.numel() for p in model.parameters())} parameters, "
                  f"{n_params} from the shapes")
            check(opt.state["count"] == DRIVER_STEPS, f"driver: count {opt.state['count']}")
            check(all(r["write_s"] is not None for r in timings), f"driver: saves {timings}")

            # (b) restore on the card and on the CPU, bit for bit, while (c)'s
            # first subprocess trains to its preemption beside it on the card
            torch.cuda.empty_cache()
            live = {**{f"0/{k}": v for k, v in tree_items(model.tree())},
                    **{f"1/{k}": v for k, v in tree_items(opt.state_tree(model.tree()))}}
            env = {**os.environ, "PYTHONPATH": SRC}
            hb = os.path.join(root, "heartbeat.json")
            cmd = [sys.executable, "-m", "repro_torch.launch.train", *DRIVER_ARGV,
                   "--ckpt-dir", dir_c, "--heartbeat", hb]
            with ThreadPoolExecutor(max_workers=1) as pool:
                first = pool.submit(preempted_run, cmd, env, hb)
                out["restore"] = [restore_into_fresh(cfg, dir_a, DRIVER_STEPS, live, d)
                                  for d in (dev, "cpu")]
                run = first.result()
            shutil.rmtree(dir_a)
            torch.cuda.empty_cache()

            # (c) the preempted run, the watchdog, the resumed run
            print(run["stdout"], end="", flush=True)
            check(run["returncode"] == 0, f"driver: the preempted run exited "
                  f"{run['returncode']}:\n" + run["stderr"][-4000:])
            check("signal 15: writing preemption checkpoint" in run["stdout"]
                  and "done" not in run["stdout"], "driver: no preemption line")
            beats = watchdog.scan(hb)
            check(len(beats) == 1 and beats[0]["process"] == 0, f"driver: heartbeats {beats}")
            reached = beats[0]["step"] + 1
            from repro_torch.checkpoint import CheckpointManager
            latest = CheckpointManager(dir_c).latest_step()
            check(latest == reached and 2 <= reached < DRIVER_STEPS,
                  f"driver: preempted at step {reached}, latest checkpoint {latest}")
            while time.time() - beats[0]["time"] <= 1.5:
                time.sleep(0.1)
            log = io.StringIO()
            code = None
            with contextlib.redirect_stdout(log):
                try:
                    watchdog.main(["--pattern", hb, "--timeout", "1", "--interval", "0.1"])
                except SystemExit as e:
                    code = e.code
            check(code == 1 and "HANG detected (1 stale heartbeats)" in log.getvalue(),
                  f"driver: watchdog exited {code}: {log.getvalue()}")
            t0 = time.time()
            resumed = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, env=env,
                                     timeout=DRIVER_TIMEOUT)
            resume_s = time.time() - t0
            print(resumed.stdout, end="", flush=True)
            check(resumed.returncode == 0, f"driver: the resumed run exited "
                  f"{resumed.returncode}:\n" + resumed.stderr[-4000:])
            check(resumed.stdout.startswith(f"resumed from step {reached}\n")
                  and resumed.stdout.rstrip().endswith("done"),
                  f"driver: the resumed run printed {resumed.stdout!r}")
            # the resumed run's checkpoint against (a)'s live state, which (b)
            # showed equal to (a)'s checkpoint
            cmp = restore_into_fresh(cfg, dir_c, DRIVER_STEPS, live, dev)
            out["preemption"] = {
                "signal_after_s": run["signal_after_s"], "preempted_run_s": run["seconds"],
                "reached": reached,
                "heartbeat": beats[0], "watchdog": log.getvalue().strip(),
                "resumed_run_s": resume_s, "compare": cmp}
            del live, model, opt
            shutil.rmtree(dir_c)
            torch.cuda.empty_cache()
        out["peak_disk_bytes"] = disk.peak

        # (d) compression on the card
        t0 = time.time()
        xc = torch.randn(largest, generator=torch.Generator(device=dev).manual_seed(21),
                         device=dev)
        x = xc.cpu()
        q, s = quantize_int8(x)
        qc, sc = quantize_int8(xc)
        comp = {"shape": list(largest),
                "quantize_equal": same_bits(q, qc.cpu()) and same_bits(s, sc.cpu()),
                "dequantize_equal": same_bits(dequantize(q, s), dequantize(qc, sc).cpu()),
                "quantize_ms": time_ms(lambda: quantize_int8(xc), 3)}
        del x, xc, q, s, qc, sc
        torch.cuda.empty_cache()
        comp["groups"] = {}
        for world in (w for w in DRIVER_COMPRESSION_WORLDS if w <= torch.cuda.device_count()):
            ranks = spawn_ranks(compression_rank, world, (21, largest),
                                backend="nccl", timeout=600)
            comp["groups"][world] = ranks
        comp["seconds"] = time.time() - t0
        out["compression"] = comp
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"driver_path": out, "launches": counts, "launches_by_shape": shape_rows(shapes),
          "seconds": round(time.time() - t_phase, 3), "card": name, "power_limit": power})
    tr = out["train"]
    print(f"driver: {tr['seconds']:.1f} s for {DRIVER_STEPS} steps, "
          f"ms a step {[round(r['ms'], 1) for r in tr['steps']]} (write in flight "
          f"{[r['write_in_flight'] for r in tr['steps']]}), snapshots "
          f"{[round(r['snapshot_s'] * 1e3, 1) for r in tr['saves']]} ms, writes "
          f"{[round(r['write_s'], 2) for r in tr['saves']]} s, "
          f"{tr['checkpoint_bytes_on_disk']} bytes a checkpoint, peak memory "
          f"{tr['peak_memory_bytes'] / 1e9:.2f} GB, peak disk {out['peak_disk_bytes'] / 1e9:.2f} "
          f"GB; resume max rel diff {out['preemption']['compare']['max_rel_diff']:.3g} "
          f"[{name}, {power}]", flush=True)
    losses = [r["loss"] for r in tr["steps"]]
    sigs = [r["sig"] for r in tr["steps"]]
    check(len(losses) == DRIVER_STEPS and all(np.isfinite(losses + sigs)),
          f"driver: losses {tr['steps']}")
    for kname in TRAIN_PATH:
        check(counts[kname] > 0, f"driver path never launched {kname}")
    check(counts["fwd_fused"] + counts["gram_fused"] > 0,
          "driver path launched neither fused kernel")
    for r in out["restore"]:
        check(r["step"] == r["count"] == DRIVER_STEPS and r["differing_leaves"] == 0,
              f"driver: restore on {r['device']}: {r}")
    pre = out["preemption"]["compare"]
    check(pre["step"] == pre["count"] == DRIVER_STEPS and pre["differing_leaves"] == 0,
          f"driver: the resumed step-{DRIVER_STEPS} checkpoint differs from the uninterrupted "
          f"run's state in {pre['differing_leaves']} leaves {pre['first_differing']}, max rel "
          f"{pre['max_rel_diff']:.3g}")
    comp = out["compression"]
    check(comp["quantize_equal"] and comp["dequantize_equal"],
          f"driver: int8 compression on the card differs from the CPU's {comp}")
    check(1 in comp["groups"], "driver: no 1-rank NCCL group ran")
    for world, ranks in comp["groups"].items():
        for r, o in enumerate(ranks):
            check(all(o["equal"].values()), f"driver: psum_compressed_tree, {world} ranks, "
                  f"rank {r}: {o['equal']}")
    return [(k, {"driver": n}, ran_at[k]) for k, n in sorted(shapes.items(), key=str)]


def dryrun_start() -> list:
    """Phase 22 (a)'s dry-run subprocesses, one a cell of :data:`DRYRUN_CELLS`,
    each writing its record under :data:`CACHE_DIR`: [(cell, Popen, out path,
    start time)].  Stopped at exit if still running."""
    import atexit
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, mp in DRYRUN_CELLS:
        out = os.path.join(CACHE_DIR, f"dryrun_{arch}_{shape}_{int(mp)}.json")
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                "--shape", shape, "--out", out] + (["--multipod"] if mp else [])
        p = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             preexec_fn=lambda: os.nice(10))
        procs.append(((arch, shape, mp), p, out, time.time()))

    def stop():
        for _, p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    atexit.register(stop)
    return procs


def dryrun_phase(procs, reset_all, kernel, sig_kernel, name, power) -> None:
    """Phase 22: (a) the dry-run records of :func:`dryrun_start`'s
    subprocesses, printed and checked; (b) rank 0's share of
    :data:`DRYRUN_SHARE` at 16x16 run on the card, its cache bytes and
    flops held to (a)'s record, its decode step timed against its byte
    bound."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.launch.shapes import SIG_SHAPES as GRAM_CELLS
    from repro_torch.models import get_config
    t_phase = time.time()
    records = {}
    for (arch, shape, mp), p, out, t0 in procs:
        try:
            log, _ = p.communicate(timeout=max(1.0, DRYRUN_TIMEOUT - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
            raise SmokeFailure(f"dryrun: {arch} x {shape} took more than {DRYRUN_TIMEOUT} s")
        check(p.returncode == 0, f"dryrun: {arch} x {shape} exited {p.returncode}: "
              f"{log[-2000:]}")
        with open(out) as f:
            rec, = json.load(f)
        emit({"dryrun_record": rec, "cpu_seconds_since_start": round(time.time() - t0, 1)})
        mesh = "2x16x16" if mp else "16x16"
        check("error" not in rec and "skipped" not in rec, f"dryrun: {arch} x {shape} x "
              f"{mesh}: {rec.get('error') or rec.get('skipped')}")
        check(rec["mesh"] == mesh and rec["n_chips"] == (512 if mp else 256),
              f"dryrun: {rec['mesh']} / {rec['n_chips']} chips for {mesh}")
        check(rec["flops"] > 0 and rec["hlo_dot_flops"] > 0 and rec["argument_bytes"] > 0
              and rec["output_bytes"] > 0, f"dryrun: {arch} x {shape} x {mesh}: {rec}")
        check(all(rec[k] is None for k in dryrun.NULL_FIELDS),
              f"dryrun: an XLA-only field is not null: {rec}")
        n_coll = sum(c["count"] for c in rec["collectives"].values())
        if arch == "sigkernel-workload":
            # a device's (B/16) x (B/16) tile of pairs, Δ 2·(L-1)²·d flops a pair
            cell = GRAM_CELLS[shape]
            b = cell.batch // 16
            check(n_coll == 0, f"dryrun: the Gram's local tiles issued {n_coll} collectives")
            pairs_flops = 2 * b * b * (cell.seq - 1) ** 2 * 8
            check(rec["hlo_dot_flops"] == pairs_flops, f"dryrun: sig_gram flops "
                  f"{rec['hlo_dot_flops']} != {pairs_flops}")
        else:
            check(n_coll > 0, f"dryrun: {arch} x {mesh} issued no collective")
        records[(arch, shape, mesh)] = rec

    # (b) rank 0's share on the card
    arch, shape = DRYRUN_SHARE
    want = records[(arch, shape, "16x16")]
    torch.cuda.empty_cache()
    reset_all()
    real = dryrun.run_cell(get_config(arch), SHAPES[shape], (16, 16), ("data", "model"),
                           arch=arch, mesh_name="16x16", device="cuda", repeats=DRYRUN_REPS)
    counts = {**kernel.launch_counts(), **sig_kernel.launch_counts()}
    ms = float(np.median(real["ms"]))
    gathered = real["collectives"]["all-gather"]["out_bytes"]
    moved = real["argument_bytes"] + real["output_bytes"] - real["alias_bytes"] + gathered
    bound = moved / HBM_BYTES_PER_S * 1e3
    emit({"dryrun_share": {"cell": f"{arch} x {shape} x 16x16", "rank": 0,
                           "sequences": SHAPES[shape].batch // 16, "ms": real["ms"],
                           "ms_median": ms, "bound_ms": bound, "bytes": moved,
                           "gathered_bytes": gathered, "cache_bytes": real["cache_bytes"],
                           "flops": real["flops"], "record_flops": want["flops"],
                           "record_cache_bytes": want["alias_bytes"],
                           "trace_s": real["compile_s"], "launches": counts},
          "card": name, "power_limit": power})
    print(f"dryrun: {arch} x {shape}, rank 0 of 16x16 on the card: {ms:.1f} ms a decode "
          f"step (median of {DRYRUN_REPS}) against a {bound:.3f} ms byte bound "
          f"({moved / 1e9:.3f} GB: its shards, outputs and gathered weights); "
          f"{real['flops']:.6g} flops, {real['cache_bytes']} cache bytes; phase "
          f"{time.time() - t_phase:.1f} s [{name}, {power}]", flush=True)
    check(real["cache_bytes"] == want["alias_bytes"],
          f"dryrun: the card's cache bytes {real['cache_bytes']} != the record's "
          f"{want['alias_bytes']}")
    check(real["flops"] == want["flops"] and real["hlo_dot_flops"] == want["hlo_dot_flops"],
          f"dryrun: the card's decode step counts {real['flops']} flops, the record "
          f"{want['flops']}")
    check(real["argument_bytes"] == want["argument_bytes"],
          f"dryrun: argument bytes {real['argument_bytes']} != {want['argument_bytes']}")
    check(all(np.isfinite(real["ms"])) and ms > 0, f"dryrun: step times {real['ms']}")
    reset_all()
    errs = mesh_against_plain(get_config(arch), SHAPES[shape].batch // 16)
    counts = {k: counts.get(k, 0) + n for k, n in {**kernel.launch_counts(),
                                                   **sig_kernel.launch_counts()}.items()}
    emit({"dryrun_mesh_values": {"cell": f"{arch}, 1 x 1 mesh, real NCCL group of 1",
                                 "sequences": SHAPES[shape].batch // 16,
                                 "prompt": DRYRUN_PROMPT, "rel_err": errs, "rtol": DRYRUN_RTOL},
          "card": name, "power_limit": power})
    print(f"dryrun: {arch} mesh path against the plain path on the card: largest relative "
          f"difference {max(errs.values()):.3g} ({max(errs, key=errs.get)}); phase "
          f"{time.time() - t_phase:.1f} s [{name}, {power}]", flush=True)
    for what, err in errs.items():
        check(err <= DRYRUN_RTOL, f"dryrun: the mesh path's {what} differs from the plain "
              f"path's by {err:.3g} > {DRYRUN_RTOL}")
    check(sum(counts.values()) == 0, f"dryrun: serving launched kernels {counts}")


def mesh_against_plain(cfg, B: int) -> dict:
    """Phase 22 (b)'s value check: ``cfg``'s model (random weights, seed 0)
    prefills :data:`DRYRUN_PROMPT` tokens of ``B`` sequences and decodes
    one, on the plain path and on the mesh path (rank 0 of a real one-rank
    NCCL group at the 1 x 1 mesh, every parameter, token and cache a
    DTensor laid out by the sharding rules).  {output: largest difference
    over the largest value}, for both steps' logits and every cache leaf."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.shapes import ShapePreset, cache_shape_for
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_items
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.api import logical_rules
    from repro_torch.serve.step import compute_params
    dev = torch.device("cuda", 0)
    P = DRYRUN_PROMPT
    model = build_model(cfg, seed=0, device=dev)
    compute = compute_params(model)
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (B, P + 1), generator=g, device=dev)
    plain = {}
    logits, caches = model.prefill({"tokens": toks[:, :P], "max_len": P + 1}, params=compute)
    plain["prefill logits"] = logits
    logits, caches = model.decode(caches, toks[:, P:], P, params=compute)
    plain["decode logits"] = logits
    plain.update((f"cache {k}", v) for k, v in tree_items(caches))
    del caches

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    mesh_out = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        dparams = SH.distribute(compute, SH.param_shardings(compute, cfg, mesh, False), mesh)
        meta = cache_shape_for(cfg, ShapePreset("share", "decode", P + 1, B))
        caches = SH.distribute(model.cache_init(B, P + 1),
                               SH.cache_shardings(meta, cfg, mesh, False), mesh)

        def tokens(t):
            return SH.distribute({"tokens": t}, SH.batch_shardings({"tokens": t}, cfg, mesh,
                                                                   False), mesh)["tokens"]

        with logical_rules(SH.rules_for(cfg, False)), implicit_replication():
            logits, caches = model.prefill({"tokens": tokens(toks[:, :P]), "max_len": P + 1},
                                           params=dparams, caches=caches)
            check(isinstance(logits, DTensor), "dryrun: the mesh path's prefill gave no DTensor")
            mesh_out["prefill logits"] = whole(logits)
            logits, caches = model.decode(caches, tokens(toks[:, P:]), P, params=dparams)
            mesh_out["decode logits"] = whole(logits)
            mesh_out.update((f"cache {k}", whole(v)) for k, v in tree_items(caches))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    check(set(mesh_out) == set(plain), f"dryrun: mesh outputs {sorted(mesh_out)}")
    return {k: float((mesh_out[k].float() - v.float()).abs().max()
                     / v.float().abs().max().clamp_min(1e-30)) for k, v in plain.items()}


def guard_phase(rt, dev, rng, reset_all, kernel, name, power) -> None:
    """Phase 23: the streaming guard on the card, (a)-(c) of the module
    docstring."""
    import torch
    from repro_torch.core import gram
    from repro_torch.kernels.sigkernel_pde import ops
    t_phase = time.time()
    X = torch.from_numpy(random_paths(rng, *GUARD_X)).to(dev)
    Y = torch.from_numpy(random_paths(rng, *GUARD_Y)).to(dev)
    bx, by = GUARD_X[0], GUARD_Y[0]

    def run(backend, static, guarded):
        """mmd2 and its gradient, the launch counts set to 0 just before and
        read just after; ``guarded=False`` takes the guard out."""
        real = gram._guard_reduce
        if not guarded:
            gram._guard_reduce = lambda *args, **kw: None
        try:
            reset_all()
            t0 = time.time()
            a, b = X.clone().requires_grad_(), Y.clone().requires_grad_()
            v = rt.mmd2(a, b, row_block=GUARD_ROW_BLOCK, backend=backend,
                        static_kernel=static)
            ga, gb = torch.autograd.grad(v, (a, b))
            torch.cuda.synchronize()
            secs = time.time() - t0
        finally:
            gram._guard_reduce = real
        return (v, ga, gb), kernel.launch_counts(), kernel.launch_shapes(), secs

    runs = []
    for backend, lift in GUARD_RUNS:
        static = rt.RBF(1.0) if lift == "rbf" else None
        gram._stream_checked.clear()
        with guard_timer() as first:
            out, counts, shapes, first_s = run(backend, static, True)
        with guard_timer() as second:
            again, _, shapes_again, cached_s = run(backend, static, True)
        plain, counts_plain, shapes_plain, plain_s = run(backend, static, False)
        tag = f"guard {backend}/{lift}"
        check(first["traces"] >= 3 and second["traces"] == 0,
              f"{tag}: traces {first['traces']} first, {second['traces']} cached")
        check(all(torch.equal(p, q) and torch.equal(p, r)
                  for p, q, r in zip(out, again, plain)),
              f"{tag}: value or gradient differs from the unguarded call")
        check(shapes == shapes_again == shapes_plain and counts == counts_plain,
              f"{tag}: launches by shape differ from the unguarded call")
        need = ("fwd_cps", "bwd") + (("fwd_fused", "gram_fused") if backend == "gpu_fused"
                                     else ())
        check(all(counts[k] > 0 for k in need), f"{tag}: launched {counts}")
        runs.append({"backend": backend, "lift": lift, "mmd2": float(out[0].detach()),
                     "guard_seconds": first["seconds"], "first_call_seconds": first_s,
                     "cached_call_seconds": cached_s, "unguarded_call_seconds": plain_s,
                     "launches": counts, "launches_by_shape": shape_rows(shapes)})

    # (b) the dense Gram, traced on fake tensors: nothing allocated, no launch
    sk = rt.SigKernel(backend="gpu_fused")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_all()
    t0 = time.time()
    message = None
    try:
        gram.assert_streaming_reduction(lambda a, b: sk.gram(a, b).sum(), X, Y,
                                        gram_shape=(bx, by), grad=True)
    except gram.StreamingViolation as e:
        message = str(e)
    dense_s = time.time() - t0
    rise = torch.cuda.max_memory_allocated() - base
    check(message is not None and f"({bx}, {by})" in message,
          f"guard: the dense Gram passed ({message})")
    check(rise < GUARD_PEAK_BYTES, f"guard: peak memory rose by {rise} bytes")
    check(not any(kernel.launch_counts().values()), "guard: the fake trace launched")
    stack_bytes = bx * by * (GUARD_X[1] - 1) * (GUARD_Y[1] - 1) * 8

    # (c) each Goursat op's CUDA implementation: schema and fake implementation
    g = torch.Generator().manual_seed(5)

    def r(*shape, scale=0.1):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    delta, lam, T = r(3, 20, 17), (1, 0), 8
    geo = tuple(ops.geometry(20, 17, *lam, scheme="order2", T=T))
    _, cps = ops.goursat_fwd_cps(delta, T, *geo, *lam, "order2", "float32")
    dx, dy = r(3, 20, 4, scale=0.3), r(3, 17, 4, scale=0.3)
    cases = {
        "goursat_fwd": (delta, *ops.geometry(20, 17, *lam, scheme="order2"), *lam, "order2",
                        "float32"),
        "goursat_fwd_cps": (delta, T, *geo, *lam, "order2", "float32"),
        "goursat_bwd": (delta, cps, r(3, scale=1.0), T, *lam, "order2", "float32"),
        "goursat_fwd_fused": (dx, dy, ops.choose_T(20, 17, 0, 0, 3, d=4), 0, 0, "order1",
                              "bfloat16"),
        "goursat_gram_fused": (dx, dy[:2], ops.choose_T(20, 17, 0, 0, 6, d=4), 0, 0,
                               "order1", "float32"),
    }
    opcheck = {}
    for op_name, args in cases.items():
        res = torch.library.opcheck(getattr(ops, op_name), args,
                                    test_utils=("test_schema", "test_faketensor"))
        opcheck[op_name] = res
        check(set(res.values()) == {"SUCCESS"}, f"guard: opcheck {op_name}: {res}")
    secs = time.time() - t_phase
    emit({"streaming_guard_path": runs, "dense_gram": {
        "raised": message[:240], "seconds": dense_s, "peak_rise_bytes": rise,
        "dense_delta_stack_bytes_f64": stack_bytes}, "opcheck": opcheck,
        "seconds": round(secs, 3), "within_budget": secs <= GUARD_BUDGET_S,
        "card": name, "power_limit": power})


if __name__ == "__main__":
    if sys.argv[1:]:
        sys.exit(f"chip_smoke: takes no arguments, got {sys.argv[1:]}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_") as CACHE_DIR:
        sys.exit(main())
