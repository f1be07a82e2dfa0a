"""Run one cell of the port's benchmark once and print its result line.

    python3 sigbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``src/repro_torch``.  The cell's
cards are found first: without them the run prints no result and exits
with 3.  The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; ``check`` comes last, each compared number beside its
limit, which also end standard error.  A run whose process, or any rank
process of a cell on several cards, holds JAX or the JAX package once its
window has closed prints no result and exits with 4.
"""

import time

T0 = time.time()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch under {ROOT}: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # compile caches at fixed paths inside the checkout
    cache = ROOT / ".sigbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    from sigbench import device, harness, spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), T0)
    held = device.held(result)
    if held:
        print(f"the run's processes hold {held}: the benchmark measures the port alone",
              file=sys.stderr)
        return 4
    result["device"]["power_limit"] = device.power_limit()
    lines = result.pop("_lines")     # "check" stays the last key
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
