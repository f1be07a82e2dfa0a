#!/usr/bin/env python3
"""Run chip_smoke.py's phases 15 (LM serving at full size) and 16 (the
``_torch`` examples), or phase 17 (the MoE family), 18 (the SSM family), 19
(the encoder-decoder family), 20 (the vlm family), 21 (the training
driver), 22 (the dry run: its CPU records and a device's share on the
card) or 23 (the streaming-reduction guard), alone on one CUDA card, with their shape checks: both kernel
libraries are built first, as the smoke builds them, and every line the
phases print is the smoke's own.
A quicker way than the whole smoke to measure the serving path again.

    python3 tools/serving_probe.py              # phases 15 and 16
    python3 tools/serving_probe.py --phase 17   # phase 17 alone
    python3 tools/serving_probe.py --phase 18   # phase 18 alone
    python3 tools/serving_probe.py --phase 19   # phase 19 alone
    python3 tools/serving_probe.py --phase 20   # phase 20 alone
    python3 tools/serving_probe.py --phase 21   # phase 21 alone
    python3 tools/serving_probe.py --phase 22   # phase 22 alone
    python3 tools/serving_probe.py --phase 23   # phase 23 alone
"""

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", type=int, action="append",
                    choices=(15, 16, 17, 18, 19, 20, 21, 22),
                    help="the phases to run (repeatable; default 15 and 16)")
    phases = ap.parse_args(argv).phase or [15, 16]
    if not torch.cuda.is_available():
        print("serving_probe: CUDA is not available", file=sys.stderr)
        return 1
    dryrun_procs = cs.dryrun_start() if 22 in phases else None
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
    checked = set()
    if 15 in phases:
        cs.serve_lm_phase(dev, reset_all, kernel, sig_kernel, name, power)
    if 16 in phases:
        goursat, horner = cs.examples_phase(dev, reset_all, kernel, sig_kernel, name, power)
        for key, (by_run, ran_at) in sorted(goursat.items(), key=str):
            for lam1, _, scheme, idt in sorted(ran_at):
                cs.shape_check(key, by_run, kernel, cs.fwd_cps, dev, rng, name, power,
                               lam=lam1, variants=((scheme, idt),))
        for key, by_run in sorted(horner.items(), key=str):
            cs.horner_shape_check(key, by_run, sig_kernel, dev, rng, name, power)
    if 17 in phases:
        moe_shapes = cs.moe_phase(dev, reset_all, kernel, sig_kernel, name, power)
        cs.trainer_shape_checks("moe", moe_shapes, checked, kernel, dev, rng, name, power)
    if 18 in phases:
        ssm_shapes = cs.ssm_phase(dev, reset_all, kernel, sig_kernel, name, power)
        cs.trainer_shape_checks("ssm", ssm_shapes, checked, kernel, dev, rng, name, power)
    if 19 in phases:
        encdec_shapes = cs.encdec_phase(dev, reset_all, kernel, sig_kernel, name, power)
        cs.trainer_shape_checks("encdec", encdec_shapes, checked, kernel, dev, rng, name,
                                power)
    if 20 in phases:
        vlm_shapes = cs.vlm_phase(dev, reset_all, kernel, sig_kernel, name, power)
        cs.trainer_shape_checks("vlm", vlm_shapes, checked, kernel, dev, rng, name, power)
    if 21 in phases:
        driver_shapes = cs.driver_phase(dev, reset_all, kernel, sig_kernel, name, power)
        cs.trainer_shape_checks("driver", driver_shapes, checked, kernel, dev, rng, name,
                                power)
    if 22 in phases:
        cs.dryrun_phase(dryrun_procs, reset_all, kernel, sig_kernel, name, power)
    if 23 in phases:
        import repro_torch as rt
        cs.guard_phase(rt, dev, rng, reset_all, kernel, name, power)
    print(card)
    return 0


if __name__ == "__main__":
    with tempfile.TemporaryDirectory(prefix="serving_probe_autotune_") as cache_dir:
        cs.CACHE_DIR = cache_dir
        os.environ[cs.AUTOTUNE_ENV] = os.path.join(cache_dir, "bench.json")
        sys.exit(main())
