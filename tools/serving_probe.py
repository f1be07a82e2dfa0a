#!/usr/bin/env python3
"""Run chip_smoke.py's phases 15 (LM serving at full size) and 16 (the
``_torch`` examples) alone on one CUDA card, with phase 16's shape checks:
both kernel libraries are built first, as the smoke builds them, and every
line the phases print is the smoke's own.  A quicker way than the whole
smoke to measure the serving path again.

    python3 tools/serving_probe.py
"""

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("serving_probe: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.sigkernel_pde import kernel
    from repro_torch.kernels.signature import kernel as sig_kernel
    cs.build_all((kernel, sig_kernel))
    card = cs.card_line()
    name, power = [s.strip() for s in card.split(",", 1)]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")

    def reset_all():
        kernel.reset_launch_counts()
        sig_kernel.reset_launch_counts()

    rng = np.random.default_rng(0)
    cs.serve_lm_phase(dev, reset_all, kernel, sig_kernel, name, power)
    goursat, horner = cs.examples_phase(dev, reset_all, kernel, sig_kernel, name, power)
    for key, (by_run, ran_at) in sorted(goursat.items(), key=str):
        for lam1, _, scheme, idt in sorted(ran_at):
            cs.shape_check(key, by_run, kernel, cs.fwd_cps, dev, rng, name, power, lam=lam1,
                           variants=((scheme, idt),))
    for key, by_run in sorted(horner.items(), key=str):
        cs.horner_shape_check(key, by_run, sig_kernel, dev, rng, name, power)
    print(card)
    return 0


if __name__ == "__main__":
    with tempfile.TemporaryDirectory(prefix="serving_probe_autotune_") as cache_dir:
        cs.CACHE_DIR = cache_dir
        os.environ[cs.AUTOTUNE_ENV] = os.path.join(cache_dir, "bench.json")
        sys.exit(main())
