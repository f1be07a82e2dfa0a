#!/usr/bin/env python3
"""Measurements of the port's CUDA kernels that chip_smoke.py does not take.

    python3 tools/kernel_bench.py ablate  --old DIR [--set original|redesign] [--out FILE]
    python3 tools/kernel_bench.py ablate-horner --old DIR [--out FILE]
    python3 tools/kernel_bench.py ablate-fused --old DIR [--out FILE]
    python3 tools/kernel_bench.py compare --old DIR [--out FILE]

``DIR`` holds a version of the kernel sources (``sigkernel_pde.cu`` and,
for ``ablate-horner``, ``signature.cu``, e.g. ``git show <commit>:<path>``
of each, copied into a git-ignored directory such as ``build/old``).  Each command needs one CUDA
card and nvcc; it prints one JSON object per measurement and writes them
all to ``--out`` (default ``build/kernel_bench/<command>.json``).

``ablate`` times variants of the Goursat backward kernel of ``DIR`` at the
gradient path's shape, Δ (128, 1023, 1023) at strip height 512: the kernel
as it is, and copies with one part disabled (the dΔ store, the workspace
write and read, either sweep).  ``--set original`` patches the first
port's backward (one dΔ store per lane and step, the workspace staged
through registers), ``--set redesign`` the redesigned one (``--old
src/repro_torch/kernels/sigkernel_pde/csrc``).  The variants are made by
text patches of the source into ``build/kernel_bench/`` and are never part
of the package.  It also prints the ``-Xptxas -v`` report of the kernels
built as they are.

``ablate-horner`` times variants of the split Horner kernel of ``DIR`` (its
per-step rows, its top level, their Horner chains or their entries
skipped) at the paper's Table 1 shapes, and sweeps its prefix length and
row chunk width around the wrapper's choice.

``ablate-fused`` times variants of the fused kernels of ``DIR`` (``--old
src/repro_torch/kernels/sigkernel_pde/csrc``) at the main paths' shapes:
the band built without the tensor cores (each lane's float64 FMAs), no band
built at all (the wavefront and the band hand-over alone, wrong values),
dx and dy staged as float64, other producer warp counts, 80 registers a
thread, and a 16-step band.

``compare`` times the Goursat kernels of ``DIR`` (the parent's
``sigkernel_pde.cu``, whose C interfaces it calls; built under another
library name) against the repo's, in turns (old, new, new, old): the fused
kernels B4 and B3 at every main-path shape they launch at
(``FUSED_SHAPES``), and B1, B1-cps and B2 at Δ (128, 1023, 1023), and
checks that old and new agree within 1e-4 (relative to the largest value).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
WORK = ROOT / "build" / "kernel_bench"

#: Δ of the gradient path (chip_smoke.py: sigkernel on (128, 1024, 32) paths)
B2_SHAPE = (128, 1024, 32)
B2_T = 512
#: the paper's Table 1 / Table 3 "full" cells, (B, L, d, N)
SIG_SHAPES = ((128, 256, 4, 6), (128, 512, 8, 5), (128, 1024, 16, 4))


def _patch(src: str, old: str, new: str, after: str = "") -> str:
    """Replace the first ``old`` after the anchor ``after``; fail if absent."""
    at = src.index(after) if after else 0
    i = src.index(old, at)
    return src[:i] + new + src[i + len(old):]


def _no_dd(src):
    return _patch(src, "else if (row < Lx)\n",
                  "else if (row < Lx && v == 1.2345e-30f)  // ablation: no dΔ store\n")


def _no_ws(src):
    src = _patch(src, "wsb[(int64_t)t * T + r] = cur;", "(void)0;  // ablation: no ws write")
    return _patch(src, "kreg[q] = t >= 0 ? ws[(int64_t)t * T + r] : 0.0f;",
                  "kreg[q] = t >= 0 ? 1.0f : 0.0f;  // ablation: constant k̂")


def _no_reverse(src):
    return _patch(src, "g0 >= 0; g0 -= kGroup)", "g0 >= 0 && Lx < 0; g0 -= kGroup)",
                  after="reverse adjoint sweep, 3.")


def _no_recompute(src):
    return _patch(src, "t0 < steps; t0 += kGroup)", "t0 < steps && Lx < 0; t0 += kGroup)",
                  after="1. recompute the strip into ws")


# the redesigned backward: dΔ through shared tiles, ws rows by bulk copies
def _no_dd_new(src):
    return _patch(src, "if (row < Lx) ddprob[", "if (row < Lx && Lx < 0) ddprob[")


def _no_tiles_new(src):
    src = _patch(src, "        bwd_flush(h - 1,", "        if (Lx < 0) bwd_flush(h - 1,")
    src = _patch(src, "h <= h_last; ++h)", "h <= h_last && Lx < 0; ++h)")
    return _patch(src, "else\n              tile[", "else if (Lx < 0)\n              tile[")


def _no_ws_new(src):
    src = _patch(src, "wsb[(int64_t)t * TS + r] = cur;", "(void)0;  // ablation: no ws write")
    return _patch(src, "(uint32_t)(n * TS * 4), bar);", "0u, bar);  // ablation: no copy")


def _no_reverse_new(src):
    return _patch(src, "gi < n_groups; ++gi)", "gi < n_groups && Lx < 0; ++gi)")


VARIANTS = {
    "original": {
        "as_is": (),
        "no_dd_store": (_no_dd,),
        "no_ws": (_no_ws,),
        "no_dd_store_no_ws": (_no_dd, _no_ws),
        "recompute_only": (_no_reverse,),
        "reverse_only": (_no_recompute,),
        "reverse_only_no_dd_store_no_ws": (_no_recompute, _no_dd, _no_ws),
    },
    "redesign": {
        "as_is": (),
        "no_dd_store": (_no_dd_new,),
        "no_dd_tiles": (_no_tiles_new,),
        "no_ws": (_no_ws_new,),
        "no_dd_tiles_no_ws": (_no_tiles_new, _no_ws_new),
        "recompute_only": (_no_reverse_new,),
        "reverse_only": (_no_recompute,),
        "reverse_only_no_dd_tiles_no_ws": (_no_recompute, _no_tiles_new, _no_ws_new),
    },
}


def _nvcc_all(jobs):
    """Build {name: (source path, library path)} with one nvcc each, all at
    once; return {name: ptxas report lines}."""
    from repro_torch.kernels import _build
    procs = {}
    for name, (src, lib) in jobs.items():
        cmd = [_build.nvcc(src), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    reports = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        reports[name] = [ln.strip() for ln in out.splitlines()
                         if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return reports


def _time_ms(fn, reps: int) -> list:
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _emit(rows, obj):
    rows.append(obj)
    print(json.dumps(obj), flush=True)


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _goursat(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.sigkernel_pde_fwd_cps.argtypes = [p, p, p, ll, i, i, i, i, i, i, i, ll, p]
    lib.sigkernel_pde_bwd.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, i, ll, p]
    lib.sigkernel_pde_fwd_cps.restype = lib.sigkernel_pde_bwd.restype = ctypes.c_int
    return lib


def _bwd_smem(T, ny, original):
    """smem_bytes_bwd of the original source (order 1), or of the repo's."""
    if original:
        return 4 * ((ny + T + 1) + 3 * T + 2 * (ny + 2) + 6 * T + T + 9 * T)
    from repro_torch.kernels.sigkernel_pde import kernel
    return kernel.smem_bytes_bwd("order1", T, ny, 0, 0)


def _b2_inputs():
    import torch
    from repro_torch.core.sigkernel import delta_matrix
    from chip_smoke import random_paths
    rng = np.random.default_rng(0)
    x = torch.from_numpy(random_paths(rng, *B2_SHAPE)).cuda()
    y = torch.from_numpy(random_paths(rng, *B2_SHAPE)).cuda()
    delta = delta_matrix(x, y).contiguous()
    gbar = torch.from_numpy(rng.normal(size=B2_SHAPE[0]).astype(np.float32)).cuda()
    return delta, gbar


def _bwd_call(lib, delta, gbar, T, original):
    """A closure that runs the backward of ``lib`` (its own checkpoint
    forward first, once) and returns dΔ; ``original``: the original
    source's workspace and shared memory, else the repo's."""
    import torch
    B, Lx, Ly = delta.shape
    W = Ly + T + 1
    S = -(-Lx // T)
    stream = torch.cuda.current_stream().cuda_stream
    k = torch.empty(B, device=delta.device)
    cps = torch.empty(B, S, W, device=delta.device)
    smem_f = 4 * (W + 3 * T)
    err = lib.sigkernel_pde_fwd_cps(delta.data_ptr(), k.data_ptr(), cps.data_ptr(), B, Lx,
                                    Ly, T, 0, 0, 0, 0, smem_f, stream)
    assert err == 0, err
    ws = torch.zeros(B * (Ly + T - 1) * max(T, 4), device=delta.device)
    dd = torch.zeros_like(delta)
    smem = _bwd_smem(T, Ly, original)

    def run():
        e = lib.sigkernel_pde_bwd(delta.data_ptr(), cps.data_ptr(), gbar.data_ptr(),
                                  ws.data_ptr(), dd.data_ptr(), B, Lx, Ly, T, 0, 0, 0, 0,
                                  smem, stream)
        assert e == 0, e
        return dd
    return run


def ablate(old: Path, out: Path, which: str):
    import torch
    rows = []
    card = _card()
    print(f"card: {card}", flush=True)
    base = (old / "sigkernel_pde.cu").read_text()
    jobs = {}
    variants = VARIANTS[which]
    for name, patches in variants.items():
        src = base
        for f in patches:
            src = f(src)
        d = WORK / f"ablate_{which}" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "sigkernel_pde.cu").write_text(src)
        jobs[name] = (d / "sigkernel_pde.cu", d / f"libsigkernel_pde_{name}.so")
    if (old / "signature.cu").exists():
        jobs["horner"] = (old / "signature.cu", WORK / f"ablate_{which}" / "libsignature.so")
    reports = _nvcc_all(jobs)
    for name in ("as_is", "horner"):
        if name in reports:
            _emit(rows, {"ptxas": name, "report": reports[name]})

    delta, gbar = _b2_inputs()
    runs = {name: _bwd_call(_goursat(jobs[name][1]), delta, gbar, B2_T, which == "original")
            for name in variants}
    ref = runs["as_is"]().clone()
    times = {name: [] for name in runs}
    for turn in range(4):
        order = list(runs) if turn % 2 == 0 else list(reversed(runs))
        for name in order:
            times[name] += _time_ms(runs[name], 3)
    for name, ts in times.items():
        _emit(rows, {"ablation": name, "source": which, "shape": list(delta.shape), "T": B2_T,
                     "ms_median": float(np.median(ts)), "ms_min": float(np.min(ts)),
                     "ms": ts, "card": card})
    got = runs["as_is"]()
    torch.cuda.synchronize()
    _emit(rows, {"as_is_repeatable": bool(torch.equal(got, ref))})
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))


# the split Horner kernel: its per-step rows, its top level, or both skipped
def _no_rows(src):
    return _patch(src, "if (kind != 0) {  // ---- the thread's row item",
                  "if (kind != 0 && n_steps < 0) {  // ---- the thread's row item")


def _no_top(src):
    src = _patch(src, "if (step > 0) top_step(", "if (step > 0 && n_steps < 0) top_step(")
    return _patch(src, "top_step(U + ((step - 1) & 1) * tiles * kTile);\n    float* top",
                  "if (n_steps < 0) top_step(U + ((step - 1) & 1) * tiles * kTile);\n"
                  "    float* top")


def _no_chain(src):
    return _patch(src, "if (k >= 3) {", "if (k >= 3 && n_steps < 0) {", after="Horner chain from z/k")


def _no_entries(src):
    return _patch(src, "if (i >= w) continue;", "if (i >= w || n_steps > 0) continue;")


HORNER_VARIANTS = {"as_is": (), "no_rows": (_no_rows,), "no_top": (_no_top,),
                   "no_rows_no_top": (_no_rows, _no_top), "no_chain": (_no_chain,),
                   "no_entries": (_no_entries,)}


def ablate_horner(src_dir: Path, out: Path):
    """Variants of the split Horner kernel at the three SIG_SHAPES, at the
    wrapper's geometry and at prefixes and length blocks around it."""
    import torch
    from repro_torch.core import transforms as tf
    from repro_torch.kernels.signature import kernel as sig_kernel
    from repro_torch.kernels.signature import ops as sig_ops
    from chip_smoke import random_paths
    rows = []
    card = _card()
    print(f"card: {card}", flush=True)
    base = (src_dir / "signature.cu").read_text()
    jobs = {}
    for name, patches in HORNER_VARIANTS.items():
        src = base
        for f in patches:
            src = f(src)
        d = WORK / "ablate_horner" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "signature.cu").write_text(src)
        jobs[name] = (d / "signature.cu", d / f"libsignature_{name}.so")
    reports = _nvcc_all(jobs)
    for name in jobs:
        _emit(rows, {"ptxas": name, "report": [ln for ln in reports[name]
                                               if "Compiling" not in ln]})
    libs = {}
    for name in jobs:
        lib = ctypes.CDLL(str(jobs[name][1]))
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.signature_horner.argtypes = [p, p, ll, i, i, i, i, i, i, i, i, ll, p]
        lib.signature_horner.restype = ctypes.c_int
        libs[name] = lib
    rng = np.random.default_rng(1)
    identity = __import__("repro_torch").TransformPipeline()
    for B, L, d, N in SIG_SHAPES:
        z = tf.pipeline_increments(torch.from_numpy(random_paths(rng, B, L, d)).cuda(),
                                   identity).contiguous()
        n = z.shape[1]
        res = torch.empty(B, sig_kernel.sig_dim(d, N), device=z.device)

        def run(name, p_, cw_, S_):
            th = sig_kernel.threads_needed(d, N, p_, d, cw_)
            smem = sig_kernel.smem_bytes(d, N, p_, cw_, S_, th)
            return lambda: libs[name].signature_horner(
                z.data_ptr(), res.data_ptr(), B, n, d, N, p_, d, cw_, S_, th, smem,
                torch.cuda.current_stream().cuda_stream)
        p0, _, cw0, S0, _ = sig_ops.geometry(B, n, d, N)
        times = {name: float(np.median(_time_ms(run(name, p0, cw0, S0), 5))) for name in libs}
        sweep = {}
        for p_ in range(max(0, p0 - 1), min(N - 1, p0 + 1) + 1):
            for cw_ in (1, 2, 4):
                th = sig_kernel.threads_needed(d, N, p_, d, cw_)
                if th <= sig_kernel.MAX_THREADS and \
                        sig_kernel.smem_bytes(d, N, p_, cw_, S0, th) <= sig_kernel.SMEM_LIMIT:
                    sweep[f"p={p_} cw={cw_} threads={th}"] = round(float(np.median(
                        _time_ms(run("as_is", p_, cw_, S0), 3))), 4)
        _emit(rows, {"horner_ablation": [B, L, d, N], "p": p0, "cw": cw0, "S": S0,
                     "ms": times, "sweep_ms": sweep, "card": card})
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))


# the fused kernels' Δ band (FUSED_SHAPES): tensor cores, staging, band length
def _no_mma(src):
    """The same band and data flow, each 16 x 8 x 8 product by the lanes'
    own float64 FMAs (operands gathered by warp shuffles) instead of the
    tensor cores."""
    mma = ('  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "\n'
           '      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"\n'
           '      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])\n'
           '      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));')
    return _patch(src, mma, """  const int l = threadIdx.x & 31;  // ablation: no tensor cores
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // A[r, k] sits in lane 4 (r % 8) + k % 4, a[(r / 8) + 2 (k / 4)]
    const int src = (l & ~3) + (k & 3), hi = 2 * (k >> 2);
    const double a0 = __shfl_sync(0xffffffffu, a[hi], src);
    const double a1 = __shfl_sync(0xffffffffu, a[hi + 1], src);
    const double b0 = __shfl_sync(0xffffffffu, b[k >> 2], 8 * (l & 3) + (k & 3));
    const double b1 = __shfl_sync(0xffffffffu, b[k >> 2], 8 * (l & 3) + 4 + (k & 3));
    c[0] = fma(a0, b0, c[0]);
    c[1] = fma(a0, b1, c[1]);
    c[2] = fma(a1, b0, c[2]);
    c[3] = fma(a1, b1, c[3]);
  }""")


def _no_band(src):
    """Producers build nothing: the wavefront and the band hand-over alone
    (wrong values; timing only)."""
    return _patch(src, "        build_band(band + (n & 1) * R * gm.BS,",
                  "        if (Lx < 0) build_band(band + (n & 1) * R * gm.BS,")


def _double_staging(src):
    """dx rows and the dy ring staged as float64: no conversion at the tile
    operand loads, twice the shared memory."""
    return _patch(src, "using Stage = float;", "using Stage = double;")


def _warps(expr):
    return lambda src: _patch(src, "{ return T >= 256 ? 16 : (T >= 128 ? 4 : 2); }",
                              "{ return %s; }" % expr)


def _registers_80(src):
    """A launch bound of 768 threads: up to 80 registers a thread."""
    return _patch(src, "constexpr int kFusedThreads = 1024;",
                  "constexpr int kFusedThreads = 768;")


def _band(n):
    return lambda src: _patch(src, "constexpr int kBand = 32;", "constexpr int kBand = %d;" % n)


FUSED_VARIANTS = {"as_is": (), "no_mma": (_no_mma,), "no_band": (_no_band,),
                  "double_staging": (_double_staging,),
                  "warps_half": (_warps("T >= 256 ? 8 : (T >= 128 ? 2 : 1)"),),
                  "warps_more": (_warps("T >= 256 ? 16 : (T >= 128 ? 8 : 4)"),),
                  "regs_80": (_registers_80,), "band_16": (_band(16),)}


def ablate_fused(src_dir: Path, out: Path):
    """Variants of the fused kernels of ``DIR`` at FUSED_SHAPES, at the
    wrappers' strip height, in turns; each variant's shared memory is its own
    library's ``sigkernel_pde_smem_bytes``."""
    import torch
    from repro_torch.kernels.sigkernel_pde import ops
    rows = []
    card = _card()
    print(f"card: {card}", flush=True)
    base = (src_dir / "sigkernel_pde.cu").read_text()
    jobs = {}
    for name, patches in FUSED_VARIANTS.items():
        src = base
        for f in patches:
            src = f(src)
        d = WORK / "ablate_fused" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "sigkernel_pde.cu").write_text(src)
        jobs[name] = (d / "sigkernel_pde.cu", d / f"libsigkernel_pde_{name}.so")
    reports = _nvcc_all(jobs)
    for name in jobs:
        _emit(rows, {"ptxas": name, "report": [ln for ln in reports[name]
                                               if "fused" in ln or "registers" in ln
                                               or "spill" in ln]})
    libs = {}
    for name in jobs:
        lib = _fused_lib(jobs[name][1])
        lib.sigkernel_pde_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.sigkernel_pde_smem_bytes.restype = ctypes.c_longlong
        libs[name] = lib
    rng = np.random.default_rng(3)
    for which, B, Lpx, Lpy, d in FUSED_SHAPES:
        dx, dy = _fused_inputs(rng, which, B, Lpx, Lpy, d)
        n = B[0] * B[1] if which == "gram_fused" else B
        Lx, Ly = dx.shape[1], dy.shape[1]
        T = ops.choose_T(Lx, Ly, 0, 0, n, d=d)
        mode = 2 if which == "gram_fused" else 1
        runs = {name: _fused_call(lib, which, dx, dy, T,
                                  lib.sigkernel_pde_smem_bytes(mode, 0, T, Ly, 0, 0, d))
                for name, lib in libs.items()
                if lib.sigkernel_pde_smem_bytes(mode, 0, T, Ly, 0, 0, d) <= 232448}
        ref = runs["as_is"]().clone()
        errs = {}
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            errs[name] = float((got - ref).abs().max() / ref.abs().max())
        times = {name: [] for name in runs}
        for turn in range(4):
            for name in (list(runs) if turn % 2 == 0 else list(reversed(runs))):
                times[name] += _time_ms(runs[name], 3)
        _emit(rows, {"fused_ablation": which, "shape": [B, Lx, Ly, d], "T": T,
                     "ms_median": {k: float(np.median(v)) for k, v in times.items()},
                     "rel_vs_as_is": errs, "card": card})
        del dx, dy
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))


#: the fused kernels' launch shapes on the main paths: (kernel, problems or
#: (Bx, By), Lx + 1 points, Ly + 1 points, d) -- sigkernel(x, y, backend=
#: "gpu_fused") on (128, 1024, 32) paths, one 4,096-pair chunk of the
#: symmetric Gram on (128, 256, 8), the dense Gram on (128, 256, 8) and the
#: trainer's (64 x 64) Gram on (64, 256, 8)
FUSED_SHAPES = (("fwd_fused", 128, 1024, 1024, 32), ("fwd_fused", 4096, 256, 256, 8),
                ("gram_fused", (128, 128), 256, 256, 8), ("gram_fused", (64, 64), 256, 256, 8))


def _old_fused_smem(T, ny, d):
    """smem_bytes of the parent's fused kernels (order 1, lam = 0): dx rows
    and a dy ring of T + 8 rows as float64 at odd stride."""
    return 4 * ((ny + T + 1) + 3 * T) + 8 * (T + T + 8) * (d | 1)


def _fused_inputs(rng, which, B, Lpx, Lpy, d):
    import torch
    from chip_smoke import random_paths
    Bx, By = B if which == "gram_fused" else (B, B)
    dx = torch.from_numpy(np.diff(random_paths(rng, Bx, Lpx, d), axis=1)).cuda().contiguous()
    dy = torch.from_numpy(np.diff(random_paths(rng, By, Lpy, d), axis=1)).cuda().contiguous()
    return dx, dy


def _fused_call(lib, which, dx, dy, T, smem):
    """A closure that launches ``lib``'s fused kernel on dx, dy (order 1,
    float32 interiors, lam = 0) and returns its output."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    Bx, Lx, d = dx.shape
    By, Ly = dy.shape[:2]
    gram = which == "gram_fused"
    out = torch.empty((Bx, By) if gram else (Bx,), device=dx.device)

    def run():
        if gram:
            e = lib.sigkernel_pde_gram_fused(dx.data_ptr(), dy.data_ptr(), out.data_ptr(), Bx,
                                             By, Lx, Ly, d, T, 0, 0, 0, 0, smem, stream)
        else:
            e = lib.sigkernel_pde_fwd_fused(dx.data_ptr(), dy.data_ptr(), out.data_ptr(), Bx,
                                            Lx, Ly, d, T, 0, 0, 0, 0, smem, stream)
        assert e == 0, e
        return out
    return run


def _fused_lib(lib_path):
    lib = _goursat(lib_path)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.sigkernel_pde_fwd_fused.argtypes = [p, p, p, ll, i, i, i, i, i, i, i, i, ll, p]
    lib.sigkernel_pde_gram_fused.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, i, i, ll, p]
    lib.sigkernel_pde_fwd.argtypes = [p, p, ll, i, i, i, i, i, i, i, ll, p]
    for fn in (lib.sigkernel_pde_fwd_fused, lib.sigkernel_pde_gram_fused, lib.sigkernel_pde_fwd):
        fn.restype = ctypes.c_int
    return lib


def _turns(rows, card, what, old_run, new_run, reps=5, **info):
    """Time old and new in turns (old, new, new, old), check they agree
    (relative to the largest old value, 1e-4) and emit one row."""
    import torch
    want, got = old_run().clone(), new_run().clone()
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    times = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        times[who] += _time_ms(old_run if who == "old" else new_run, reps)
    _emit(rows, {"kernel": what, **info, "old_ms": float(np.median(times["old"])),
                 "new_ms": float(np.median(times["new"])), "old_all": times["old"],
                 "new_all": times["new"], "new_vs_old_rel": err,
                 "new_equals_old": bool(torch.equal(got, want)), "card": card})
    if not err <= 1e-4:
        raise SystemExit(f"{what} {info}: new and old disagree by {err:.3g}")


def compare(old: Path, out: Path):
    """Old (DIR's sigkernel_pde.cu, the parent's) against new (the repo's),
    in turns (old, new, new, old): the fused kernels B4 and B3 at the main
    paths' shapes (FUSED_SHAPES) at the wrappers' strip height, and the
    kernels that read a precomputed Δ (B1, B1-cps, B2) at Δ (128, 1023,
    1023), T = 512, which should not move."""
    import torch
    from repro_torch.kernels.sigkernel_pde import kernel, ops
    rows = []
    card = _card()
    print(f"card: {card}", flush=True)
    d_old = WORK / "old"
    d_old.mkdir(parents=True, exist_ok=True)
    jobs = {"goursat": (old / "sigkernel_pde.cu", d_old / "libsigkernel_pde_old.so")}
    news = threading.Thread(target=kernel.build)
    news.start()
    reports = _nvcc_all(jobs)
    news.join()
    _emit(rows, {"ptxas_old": reports["goursat"]})
    _emit(rows, {"ptxas_new": [
        ln.strip() for ln in (kernel.build().parent / "nvcc.log").read_text().splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln]})
    lib_old = _fused_lib(jobs["goursat"][1])
    lib_new = kernel.library()

    rng = np.random.default_rng(3)
    for which, B, Lpx, Lpy, d in FUSED_SHAPES:
        dx, dy = _fused_inputs(rng, which, B, Lpx, Lpy, d)
        n = B[0] * B[1] if which == "gram_fused" else B
        Lx, Ly = dx.shape[1], dy.shape[1]
        T = ops.choose_T(Lx, Ly, 0, 0, n, d=d)
        # the parent's choose_T: cap 64 above 4 x 132 problems, else 512, at
        # most the rows rounded up, halved until its float64 staging fits
        T_old = min(64 if n > 4 * 132 else 512, 1 << (Lx - 1).bit_length())
        while _old_fused_smem(T_old, Ly, d) > kernel.SMEM_LIMIT:
            T_old //= 2
        old_run = _fused_call(lib_old, which, dx, dy, T_old, _old_fused_smem(T_old, Ly, d))
        new_run = _fused_call(lib_new, which, dx, dy, T,
                              kernel.smem_bytes(True, "order1", T, Ly, 0, 0, d))
        _turns(rows, card, which, old_run, new_run, shape=[B, Lx, Ly, d], T_old=T_old, T=T)
        del dx, dy

    delta, gbar = _b2_inputs()
    B, Lx, Ly = delta.shape
    stream = torch.cuda.current_stream().cuda_stream
    smem_f = kernel.smem_bytes(False, "order1", B2_T, Ly, 0, 0)

    def delta_call(lib, with_cps):
        res = torch.empty(B, device=delta.device)
        cps = torch.empty(B, -(-Lx // B2_T), Ly + B2_T + 1, device=delta.device)

        def run():
            if with_cps:
                e = lib.sigkernel_pde_fwd_cps(delta.data_ptr(), res.data_ptr(), cps.data_ptr(),
                                              B, Lx, Ly, B2_T, 0, 0, 0, 0, smem_f, stream)
            else:
                e = lib.sigkernel_pde_fwd(delta.data_ptr(), res.data_ptr(), B, Lx, Ly, B2_T,
                                          0, 0, 0, 0, smem_f, stream)
            assert e == 0, e
            return cps if with_cps else res
        return run
    for what, with_cps in (("fwd", False), ("fwd_cps", True)):
        _turns(rows, card, what, delta_call(lib_old, with_cps), delta_call(lib_new, with_cps),
               shape=[B, Lx, Ly], T=B2_T)
    _turns(rows, card, "bwd", _bwd_call(lib_old, delta, gbar, B2_T, False),
           _bwd_call(lib_new, delta, gbar, B2_T, False), shape=[B, Lx, Ly], T=B2_T)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("command", choices=("ablate", "ablate-horner", "ablate-fused", "compare"))
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--set", choices=tuple(VARIANTS), default="original",
                    help="ablate: which source's variants (DIR must hold that source)")
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: CUDA is not available", file=sys.stderr)
        return 1
    name = f"ablate_{a.set}" if a.command == "ablate" else a.command.replace("-", "_")
    out = a.out or WORK / f"{name}.json"
    if a.command == "ablate":
        ablate(a.old, out, a.set)
    elif a.command == "ablate-horner":
        ablate_horner(a.old, out)
    elif a.command == "ablate-fused":
        ablate_fused(a.old, out)
    else:
        compare(a.old, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
