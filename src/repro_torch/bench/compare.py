"""Diff two BENCH JSONs of the port and exit nonzero on performance regression.

    PYTHONPATH=src python -m repro_torch.bench.compare BASELINE NEW \
        [--tolerance 2.5] [--no-normalize] [--allow-missing]

The JAX package's gate (``repro.bench.compare``), with its tolerances and
exit codes, for documents the port wrote.  Rules:

* Entries are matched by ``name``; a baseline entry missing from the new
  run is a coverage regression (``--allow-missing`` downgrades to a note).
* **Machine-speed normalisation** (default): the median new/old ratio over
  all shared timing entries is treated as the box-speed factor and divided
  out, so a uniformly slower machine never fails the gate — only entries
  that regress *relative to the rest of the suite* do.
* A timing entry regresses when its normalised ratio exceeds
  ``--tolerance`` (default 2.5x) AND the absolute slowdown exceeds
  ``--abs-floor-us`` (default 250µs) — tiny entries are timer noise.
* Accuracy entries regress when the error grows past
  ``old * --accuracy-tolerance`` (default 4x) and an absolute floor of
  1e-5.
* Entries with ``meta.gate == false`` (calibration probe, the group
  start-up wall clock, the O(h) approx-backward baseline, the budget's
  skips) are reported but never gate.
* **Roofline deltas are never gated**: the change in achieved fraction of
  peak FLOPs/bandwidth is reported as a ``ROOFLINE`` note.
* A document the JAX package wrote (its fingerprint names ``jax``) is
  refused against one of the port's (``torch``): exit code 2.
"""

from __future__ import annotations

import argparse
import sys
from statistics import median
from typing import Dict, List, Tuple

from . import suite

#: entries faster than this (baseline side) are excluded from the
#: machine-speed median — they are dominated by dispatch overhead
_NORMALIZE_MIN_SECONDS = 100e-6

#: accuracy regressions need to clear this absolute error floor
_ACCURACY_FLOOR = 1e-5

#: speed factors outside this range are implausible and get clamped
_FACTOR_CLAMP = 16.0


def _gated(entry: dict) -> bool:
    return bool(entry.get("meta", {}).get("gate", True))


def _framework(doc: dict) -> str:
    fp = doc.get("fingerprint", {})
    return "jax" if "jax" in fp else "torch" if "torch" in fp else "unknown"


def speed_factor(old_entries: Dict[str, dict],
                 new_entries: Dict[str, dict]) -> float:
    """Median new/old ratio over substantial shared timing entries."""
    ratios = []
    for name, old in old_entries.items():
        new = new_entries.get(name)
        if new is None or old["kind"] != "time" or new["kind"] != "time":
            continue
        if old["seconds"] >= _NORMALIZE_MIN_SECONDS and old["seconds"] > 0:
            ratios.append(new["seconds"] / old["seconds"])
    if len(ratios) < 3:
        return 1.0
    return min(max(median(ratios), 1.0 / _FACTOR_CLAMP), _FACTOR_CLAMP)


def compare_docs(old_doc: dict, new_doc: dict, *, tolerance: float = 2.5,
                 accuracy_tolerance: float = 4.0, abs_floor: float = 250e-6,
                 normalize: bool = True, allow_missing: bool = False,
                 ) -> Tuple[List[str], List[str]]:
    """Returns (regressions, notes); empty regressions == gate passes.

    Raises ``ValueError`` for a pair of a JAX-package and a port document:
    their timings are of different programs on different machines."""
    frameworks = {_framework(old_doc), _framework(new_doc)}
    if frameworks == {"jax", "torch"}:
        raise ValueError("refusing to compare a JAX-package BENCH document with one "
                         "of the PyTorch port: different programs")
    old_entries = {e["name"]: e for e in old_doc["entries"]}
    new_entries = {e["name"]: e for e in new_doc["entries"]}
    regressions: List[str] = []
    notes: List[str] = []

    if old_doc.get("mode") != new_doc.get("mode"):
        notes.append(f"NOTE mode mismatch: baseline {old_doc.get('mode')!r} "
                     f"vs new {new_doc.get('mode')!r} — entry sets may "
                     f"not align")
    factor = speed_factor(old_entries, new_entries) if normalize else 1.0
    if factor != 1.0:
        notes.append(f"machine-speed factor {factor:.2f}x "
                     f"(median over shared timing entries) divided out")

    for name, old in sorted(old_entries.items()):
        new = new_entries.get(name)
        if new is None:
            msg = f"MISSING {name}: present in baseline, absent from new run"
            (notes if allow_missing else regressions).append(msg)
            continue
        if old["kind"] != new["kind"]:
            regressions.append(
                f"KIND {name}: {old['kind']!r} -> {new['kind']!r}")
            continue
        if old["kind"] == "time" and old["seconds"] > 0:
            ratio = new["seconds"] / old["seconds"]
            eff = ratio / factor
            line = (f"{name}: {old['seconds'] * 1e6:.1f} -> "
                    f"{new['seconds'] * 1e6:.1f} us "
                    f"(x{ratio:.2f} raw, x{eff:.2f} normalized)")
            slow = new["seconds"] - old["seconds"] * factor
            if _gated(old) and _gated(new) and eff > tolerance \
                    and slow > abs_floor:
                regressions.append("SLOWER " + line)
            else:
                notes.append(line)
            ro = old.get("roofline") or {}
            rn = new.get("roofline") or {}
            if "frac_flops" in ro and "frac_flops" in rn:
                notes.append(
                    f"ROOFLINE {name}: frac-of-peak flops "
                    f"{ro['frac_flops']:.4f} -> {rn['frac_flops']:.4f}, "
                    f"bandwidth {ro.get('frac_bandwidth', 0.0):.4f} -> "
                    f"{rn.get('frac_bandwidth', 0.0):.4f} "
                    f"({rn.get('bound', '?')}-bound; non-gating)")
        elif old["kind"] == "accuracy":
            limit = max(old["value"] * accuracy_tolerance,
                        old["value"] + _ACCURACY_FLOOR)
            line = (f"{name}: err {old['value']:.2e} -> {new['value']:.2e}")
            if _gated(old) and _gated(new) and new["value"] > limit:
                regressions.append("LESS-ACCURATE " + line)
            else:
                notes.append(line)
        else:  # "check": presence is the contract; the run itself asserted
            notes.append(f"{name}: {new.get('derived', 'ok')}")
    extra = sorted(set(new_entries) - set(old_entries))
    if extra:
        notes.append(f"{len(extra)} new entries not in baseline: "
                     + ", ".join(extra))
    return regressions, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.compare",
        description="diff two BENCH jsons of the port; nonzero exit on regression")
    ap.add_argument("baseline", help="committed BENCH json (e.g. BENCH_TORCH_full.json)")
    ap.add_argument("new", help="freshly produced BENCH json")
    ap.add_argument("--tolerance", type=float, default=2.5,
                    help="max normalized slowdown ratio (default 2.5)")
    ap.add_argument("--accuracy-tolerance", type=float, default=4.0,
                    help="max error growth factor (default 4.0)")
    ap.add_argument("--abs-floor-us", type=float, default=250.0,
                    help="ignore absolute slowdowns below this (default 250)")
    ap.add_argument("--no-normalize", action="store_true",
                    help="compare raw ratios (same-machine runs)")
    ap.add_argument("--allow-missing", action="store_true",
                    help="missing baseline entries are notes, not failures")
    ap.add_argument("--quiet", action="store_true",
                    help="print regressions only")
    args = ap.parse_args(argv)

    old_doc = suite.load_json(args.baseline)
    new_doc = suite.load_json(args.new)
    try:
        regressions, notes = compare_docs(
            old_doc, new_doc, tolerance=args.tolerance,
            accuracy_tolerance=args.accuracy_tolerance,
            abs_floor=args.abs_floor_us * 1e-6,
            normalize=not args.no_normalize, allow_missing=args.allow_missing)
    except ValueError as e:
        print(f"REFUSED {e}", file=sys.stderr)
        return 2
    if not args.quiet:
        for line in notes:
            print(line)
    for line in regressions:
        print("REGRESSION " + line)
    print(f"compared {len(old_doc['entries'])} baseline entries: "
          f"{len(regressions)} regressions")
    return 1 if regressions else 0


if __name__ == "__main__":
    sys.exit(main())
