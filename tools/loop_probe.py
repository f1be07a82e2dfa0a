#!/usr/bin/env python3
"""Measure, on one CUDA card, what the bench suite's budget estimates: the
host cost of its two plain-loop baselines, Table 2's row scan
(``solve_goursat``) and autograd through it, on 128 pairs of (L, 8) paths at
L = 33, 65, 129 (seconds a call, the minimum of 2 after a warm-up, and that
over the eager ops ``repro_torch.bench.workloads`` counts for it); and the
peak memory of autograd through the direct-algorithm signature
(``signature_direct``) at (128, 64, 8, 5) and (32, 128, 16, 4).  Prints
one JSON object.

    python3 tools/loop_probe.py
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("loop_probe: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.bench import timer
    from repro_torch.bench import workloads as w
    from repro_torch.core.sigkernel import delta_matrix, solve_goursat
    from repro_torch.core.signature import signature_direct
    dev = torch.device("cuda")
    out = {"card": timer.fingerprint(dev)["device_kind"], "power_limit": timer.power_limit()}

    def scan(a, b):
        return solve_goursat(delta_matrix(a, b))

    for L in (33, 65, 129):
        x = w._paths(0, 128, L, 8, 0.1, dev)
        y = w._paths(1, 128, L, 8, 0.1, dev)
        cells = (L - 1) ** 2
        row = {}
        for suffix, fn in (("_fwd_rowscan", scan), ("_bwd_autodiff", w._grad(scan))):
            t = timer.bench(fn, x, y, repeats=2, warmup=1)
            row[suffix.lstrip("_")] = {"seconds": t, "seconds_per_op":
                                       t / (cells * w._LOOP_OPS_PER_CELL[suffix])}
        out[f"L{L}"] = row
    for (B, L, d, N) in ((128, 64, 8, 5), (32, 128, 16, 4)):
        p = w._paths(0, B, L, d, 0.2, dev).requires_grad_()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        torch.autograd.grad(signature_direct(p, N).sum(), p)
        out[f"direct_autodiff_B{B}_L{L}_d{d}_N{N}_peak_bytes"] = \
            torch.cuda.max_memory_allocated() - base
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
