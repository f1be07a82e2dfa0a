"""Benchmark suite CLI of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.bench [--smoke | --quick | --full]
                                               [--repeats N] [--out PATH]
                                               [--md PATH] [--device cuda|cpu]

Runs the paper-aligned workloads (signature Table 1, sig-kernel + Gram
Table 2, log-signature Table 3, Figs 1-2, §3.4 gradient accuracy, the
streaming Path, the RFF / Nyström and discretisation frontiers; ``--smoke``
adds the all-backend agreement checks and the autotune round trip) on the
card, or on the CPU with ``--device cpu``, writes the schema-versioned BENCH
JSON (default ``BENCH_TORCH_<mode>.json``) and prints a markdown summary.
The frontiers and the round trip write the autotune cache at
``REPRO_AUTOTUNE_CACHE`` (default ``~/.cache/repro_torch/autotune.json``).
Gate a run against another with ``python -m repro_torch.bench.compare``.
"""

from __future__ import annotations

import argparse
import sys

from . import suite


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench", description=__doc__.splitlines()[0])
    mode_group = ap.add_mutually_exclusive_group()
    mode_group.add_argument("--smoke", action="store_true",
                            help="tiny shapes + backend agreement checks")
    mode_group.add_argument("--quick", action="store_true",
                            help="scaled-down paper cells (the default)")
    mode_group.add_argument("--full", action="store_true",
                            help="the paper's exact cells")
    ap.add_argument("--repeats", type=int, default=None,
                    help="timing repeats (default: 2 smoke / 3 quick / "
                         "5 full; paper methodology is 50)")
    ap.add_argument("--out", default=None,
                    help="output JSON path, or '-' to skip writing "
                         "(default: BENCH_TORCH_<mode>.json)")
    ap.add_argument("--md", default=None,
                    help="also write the markdown summary to this path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the workloads run (default cuda, which raises "
                         "without CUDA)")
    args = ap.parse_args(argv)

    mode = "smoke" if args.smoke else ("full" if args.full else "quick")
    out = args.out if args.out is not None else default_out(mode)
    doc = suite.run_suite(mode, repeats=args.repeats, device=args.device,
                          progress=lambda m: print(m, file=sys.stderr, flush=True))
    if out != "-":
        suite.write_json(doc, out)
        print(f"wrote {out} ({len(doc['entries'])} entries, "
              f"{doc['wall_seconds']:.1f} s)", file=sys.stderr)
    md = suite.markdown_summary(doc)
    if args.md:
        with open(args.md, "w", encoding="utf-8") as f:
            f.write(md + "\n")
    print(md)
    return 0


def default_out(mode: str) -> str:
    """``BENCH_TORCH_<mode>.json`` in every mode: the JAX package's committed
    baseline (``BENCH_PR10.json``) is never the port's default."""
    return f"BENCH_TORCH_{mode}.json"


if __name__ == "__main__":
    sys.exit(main())
