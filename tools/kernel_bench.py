#!/usr/bin/env python3
"""Measurements of the port's CUDA kernels that chip_smoke.py does not take.

    python3 tools/kernel_bench.py ablate  --old DIR [--set original|redesign] [--out FILE]
    python3 tools/kernel_bench.py ablate-horner --old DIR [--out FILE]
    python3 tools/kernel_bench.py compare --old DIR [--out FILE]

``DIR`` holds a version of the kernel sources (``sigkernel_pde.cu`` and
``signature.cu``, e.g. ``git show <commit>:<path>`` of each, copied into a
git-ignored directory such as ``build/old``).  Each command needs one CUDA
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

``compare`` times the Goursat backward and the Horner kernel of ``DIR``
(the first port's, whose C interfaces it calls; built under another
library name) against the repo's kernels at the main paths' shapes, in
turns (old, new, new, old), and checks that old and new agree: the Horner
kernels bit for bit, the backwards within 1e-4.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("command", choices=("ablate", "ablate-horner", "compare"))
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
    else:
        compare(a.old, out)
    return 0


def _old_horner(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.signature_horner.argtypes = [p, p, ll, i, i, i, i, i, ll, p]
    lib.signature_horner.restype = ctypes.c_int
    return lib


def _old_horner_geometry(n, d, N):
    """The old wrapper's length block and threads (its choose_lb and
    choose_threads with their defaults): (S, threads, smem bytes)."""
    def smem(S):
        m = sum(d ** k for k in range(1, N)) + S * d + (N - 1) * d
        m += 2 * d ** (N - 2) if N >= 4 else 0
        m += S * d ** (N - 1) if N >= 2 else 0
        return 4 * m
    S = max(1, min(64, n))
    while S > 1 and smem(S) > 232448 - 8 * 17:
        S -= 1
    threads = max(32, min(1024, 1 << max(0, d ** (N - 1) - 1).bit_length()))
    return S, threads, smem(S)


def compare(old: Path, out: Path):
    """Old against new, in turns (old, new, new, old), at the main paths'
    shapes: B2 at Δ (128, 1023, 1023), B5 at the three SIG_SHAPES."""
    import threading
    import torch
    from repro_torch.core import transforms as tf
    from repro_torch.kernels.sigkernel_pde import kernel, ops
    from repro_torch.kernels.signature import kernel as sig_kernel
    from repro_torch.kernels.signature import ops as sig_ops
    from chip_smoke import random_paths
    rows = []
    card = _card()
    print(f"card: {card}", flush=True)
    d_old = WORK / "old"
    d_old.mkdir(parents=True, exist_ok=True)
    jobs = {"goursat": (old / "sigkernel_pde.cu", d_old / "libsigkernel_pde_old.so"),
            "horner": (old / "signature.cu", d_old / "libsignature_old.so")}
    built = {}
    news = [threading.Thread(target=lambda m=m: built.setdefault(m, m.build()))
            for m in (kernel, sig_kernel)]
    for th in news:
        th.start()
    _nvcc_all(jobs)
    for th in news:
        th.join()
    for m, lib in built.items():
        _emit(rows, {"ptxas_new": lib.name, "report": [
            ln.strip() for ln in (lib.parent / "nvcc.log").read_text().splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]})

    # ---- B2 ----------------------------------------------------------------
    delta, gbar = _b2_inputs()
    old_run = _bwd_call(_goursat(jobs["goursat"][1]), delta, gbar, B2_T, True)
    cps = kernel.fwd_cps(delta, B2_T, 0, 0, "order1", "float32")[1]
    new_run = lambda: kernel.bwd(delta, cps, gbar, B2_T, 0, 0, "order1", "float32")
    want, got = old_run().clone(), new_run()
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    times = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        times[who] += _time_ms(old_run if who == "old" else new_run, 5)
    _emit(rows, {"kernel": "bwd", "shape": list(delta.shape), "T": B2_T,
                 "old_ms": float(np.median(times["old"])),
                 "new_ms": float(np.median(times["new"])), "old_all": times["old"],
                 "new_all": times["new"], "new_vs_old_rel": err, "card": card})
    if err > 1e-4:
        raise SystemExit(f"bwd: new and old disagree by {err:.3g}")
    del delta, cps, got, want
    torch.cuda.empty_cache()

    # ---- B5 ----------------------------------------------------------------
    lib = _old_horner(jobs["horner"][1])
    rng = np.random.default_rng(1)
    identity = __import__("repro_torch").TransformPipeline()
    for B, L, d, N in SIG_SHAPES:
        z = tf.pipeline_increments(torch.from_numpy(random_paths(rng, B, L, d)).cuda(),
                                   identity).contiguous()
        n = z.shape[1]
        S_old, th_old, smem_old = _old_horner_geometry(n, d, N)
        res_old = torch.empty(B, sig_kernel.sig_dim(d, N), device=z.device)

        def old_run():
            e = lib.signature_horner(z.data_ptr(), res_old.data_ptr(), B, n, d, N, S_old,
                                     th_old, smem_old, torch.cuda.current_stream().cuda_stream)
            assert e == 0, e
            return res_old
        geo = sig_ops.geometry(B, n, d, N)
        new_run = lambda: sig_kernel.horner(z, N, *geo)
        a, b = old_run().clone(), new_run()
        torch.cuda.synchronize()
        times = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            times[who] += _time_ms(old_run if who == "old" else new_run, 5)
        _emit(rows, {"kernel": "horner", "shape": [B, L, d, N],
                     "old_geometry": {"S": S_old, "threads": th_old},
                     "new_geometry": dict(zip(("p", "jw", "cw", "S", "threads"), geo)),
                     "old_ms": float(np.median(times["old"])),
                     "new_ms": float(np.median(times["new"])), "old_all": times["old"],
                     "new_all": times["new"], "new_equals_old": bool(torch.equal(a, b)),
                     "card": card})
        if not torch.equal(a, b):
            raise SystemExit(f"horner {(B, L, d, N)}: new and old differ")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    sys.exit(main())
