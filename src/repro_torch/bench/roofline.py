"""Roofline attribution for bench entries: achieved vs. peak FLOPs/bandwidth.

Every BENCH entry carries a ``"roofline"`` dict, so a win or a regression
can be attributed to the compute- vs. memory-bound regime it happened in.

:func:`analytic_counts` gives closed-form per-op (flops, bytes) estimates
from the entry's ``meta`` (op, B, L, d, depth, lam) — the same model, and
the same numbers, as the JAX package's ``repro.bench.roofline``.  They
count the work of the function, not of whatever computes it: the CUDA
kernel, the plain scan and the Pallas kernel get the same counts, so the
achieved fraction says how far each is from the card's bound.  (The JAX
package's HLO-derived counts have no counterpart here: ``source`` is
``"analytic"``, or ``"none"`` for an entry no model covers.)

Peaks come from :func:`peaks`: on the card the H100 SXM data-sheet
constants (67 TFLOP/s FP32 outside the tensor cores, 3.35 TB/s HBM3) with
the card's name beside them; on the CPU two tiny **measured** probes (a
matmul for peak FLOP/s, a copy for bandwidth), so the fractions mean
something on the machine that produced the JSON.

Everything here is non-gating: ``compare.py`` only reports achieved-fraction
deltas.

CLI::

    PYTHONPATH=src python -m repro_torch.bench.roofline BENCH_TORCH_full.json
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.tensoralg import sig_dim

from . import timer

#: H100 SXM data sheet: FP32 outside the tensor cores (the Goursat and
#: Horner arithmetic; the FP64 tensor-core peak is the same 67) and HBM3
PEAK_H100_FLOPS = 67e12
PEAK_H100_BW = 3.35e12

#: elementwise flops per refined PDE cell (the 2nd-order Goursat update:
#: two poly evals in the Δ term + 3 multiply-adds) — the JAX package's model
_PDE_FLOPS_PER_CELL = 10.0

_peaks_memo: Dict[str, Dict[str, object]] = {}


def _measured_peaks() -> Dict[str, object]:
    """Matmul + copy probes: order-of-magnitude peaks for a CPU host."""
    n = 512
    a = torch.full((n, n), 1.0 / n)
    t_mm = timer.bench(lambda x: x @ x, a, repeats=3, warmup=1)
    flops = 2.0 * n ** 3 / max(t_mm, 1e-9)
    big = torch.zeros((32, 1 << 20))  # 128 MiB
    t_cp = timer.bench(lambda x: x + 1.0, big, repeats=3, warmup=1)
    bw = 2.0 * big.numel() * 4 / max(t_cp, 1e-9)  # read + write
    return {"flops": flops, "bandwidth": bw, "source": "measured"}


def peaks(device="cuda") -> Dict[str, object]:
    """Peak FLOP/s + bytes/s of ``device`` (memoised once per process)."""
    kind = torch.device(device).type
    if kind not in _peaks_memo:
        if kind == "cuda":
            _peaks_memo[kind] = {"flops": PEAK_H100_FLOPS, "bandwidth": PEAK_H100_BW,
                                 "source": "datasheet",
                                 "device_kind": torch.cuda.get_device_name(0)}
        else:
            _peaks_memo[kind] = _measured_peaks()
    return _peaks_memo[kind]


def analytic_counts(name: str, meta: dict) -> Optional[Tuple[float, float]]:
    """Closed-form (flops, bytes) lower bound from an entry's meta, or None.

    Per-op models (f32 bytes; ``grad``/``bwd`` entries pay 3× — forward +
    adjoint sweep + cotangent accumulation):

    * signature / logsignature — Horner touches each of the ``sig_dim``
      signature coordinates ~3× per path step;
    * sigkernel — one Δ matmul per pair (``2·L²·d``) + ~10 flops per
      refined PDE cell; bytes stream Δ three times (write + fwd + solve);
    * gram / gram_reduce / gram_sharded — the sigkernel model × ``B²`` pairs;
    * autotune and frontier entries — the same models at the cache-key
      shape in ``meta["shape"]``.
    """
    op = meta.get("op")
    if not isinstance(op, str):
        if name.startswith("calibration_matmul_scan"):
            return 32 * 2.0 * 256 ** 3, 3 * 256 * 256 * 4.0
        return None
    mult = 3.0 if ("bwd" in name or "grad" in name) else 1.0
    lam = int(meta.get("lam", 0))
    if "L" not in meta:
        return _key_shape_counts(op, meta.get("shape"), mult)
    try:
        if op in ("signature", "logsignature"):
            B, L, d = meta["B"], meta["L"], meta["d"]
            sd = sig_dim(d, int(meta["depth"]))
            return 3.0 * B * L * sd * mult, 4.0 * B * (L * d + sd)
        if op in ("sigkernel", "sigkernel_grad"):
            B, L, d = meta.get("B", 4), meta["L"], meta.get("d", 3)
            n = L << lam
            per_pair = 2.0 * L * L * d + _PDE_FLOPS_PER_CELL * n * n
            return B * per_pair * mult, 4.0 * B * (2 * L * d + 3 * L * L)
        if op in ("gram", "gram_reduce", "gram_sharded"):
            B, L, d = meta["B"], meta["L"], meta["d"]
            n = L << lam
            pairs = float(B) * B
            per_pair = 2.0 * L * L * d + _PDE_FLOPS_PER_CELL * n * n
            return pairs * per_pair * mult, 4.0 * (2 * B * L * d + pairs * 3 * L * L)
    except (KeyError, TypeError, ValueError):
        return None
    return None


def _key_shape_counts(op: str, bshape, mult: float) -> Optional[Tuple[float, float]]:
    """Counts of the autotune and frontier entries, which carry the per-op
    cache-key shape instead of B/L/d: sigkernel (nx, ny, d) at the tuning
    batch, gram (Bx, By, nx, ny, d); the grid dims are already refined."""
    from .autotune import _TUNE_BATCH
    if not isinstance(bshape, (list, tuple)):
        return None
    try:
        if op == "sigkernel" and len(bshape) == 3:
            nx, ny, d = bshape
            per = 2.0 * nx * ny * d + _PDE_FLOPS_PER_CELL * nx * ny
            return (_TUNE_BATCH * per * mult,
                    4.0 * _TUNE_BATCH * (2 * nx * d + 3 * nx * ny))
        if op == "gram" and len(bshape) == 5:
            bx, by, nx, ny, d = bshape
            per = 2.0 * nx * ny * d + _PDE_FLOPS_PER_CELL * nx * ny
            return (float(bx) * by * per * mult,
                    4.0 * ((bx + by) * nx * d + bx * by * 3 * nx * ny))
    except (TypeError, ValueError):
        return None
    return None


def entry_fields(flops: Optional[float], nbytes: Optional[float],
                 seconds: Optional[float], source: str, device="cuda") -> dict:
    """The ``"roofline"`` dict for one bench entry.

    Always contains ``peak_flops`` / ``peak_bandwidth`` / ``source``; adds
    ``flops`` / ``bytes`` / ``bound`` when the model produced counts,
    ``bound_seconds`` (the larger of flops over peak FLOP/s and bytes over
    peak bytes/s) and ``achieved_*`` / ``frac_*`` when the entry was timed.
    """
    pk = peaks(device)
    out: dict = {"peak_flops": pk["flops"], "peak_bandwidth": pk["bandwidth"],
                 "source": source}
    if flops is None or nbytes is None:
        return out
    out["flops"] = float(flops)
    out["bytes"] = float(nbytes)
    t_c = flops / pk["flops"] if pk["flops"] else 0.0
    t_m = nbytes / pk["bandwidth"] if pk["bandwidth"] else 0.0
    out["bound"] = "compute" if t_c >= t_m else "memory"
    out["bound_seconds"] = max(t_c, t_m)
    if seconds and seconds > 0:
        out["achieved_flops"] = flops / seconds
        out["achieved_bandwidth"] = nbytes / seconds
        if pk["flops"]:
            out["frac_flops"] = out["achieved_flops"] / pk["flops"]
        if pk["bandwidth"]:
            out["frac_bandwidth"] = out["achieved_bandwidth"] / pk["bandwidth"]
        out["frac_bound"] = out["bound_seconds"] / seconds
    return out


def attach(entry: dict, device="cuda") -> dict:
    """Set ``entry["roofline"]`` in place from the analytic model and return
    the entry; an entry no model covers still carries the peaks."""
    counts = analytic_counts(entry["name"], entry.get("meta", {}))
    seconds = entry.get("seconds")
    if counts is None:
        entry["roofline"] = entry_fields(None, None, seconds, "none", device)
    else:
        entry["roofline"] = entry_fields(counts[0], counts[1], seconds, "analytic", device)
    return entry


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

def _fmt_rate(x: Optional[float], unit: str) -> str:
    if x is None:
        return "—"
    for scale, prefix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if x >= scale:
            return f"{x / scale:.2f} {prefix}{unit}"
    return f"{x:.2f} {unit}"


def markdown_summary(doc: dict) -> str:
    """Roofline table over a BENCH document's timed entries (peaks as the
    document recorded them)."""
    fp = doc.get("fingerprint", {})
    head = [
        f"## roofline — mode `{doc.get('mode')}`, "
        f"platform `{fp.get('platform')}` ({fp.get('device_kind')}, "
        f"power limit {fp.get('power_limit')})",
        "",
        "| entry | µs/call | FLOPs | achieved | frac of peak | "
        "bandwidth | frac of peak | bound | frac of bound | src |",
        "|---|---:|---:|---:|---:|---:|---:|---|---:|---|",
    ]
    rows, pk = [], None
    for e in doc.get("entries", []):
        if e.get("kind") != "time":
            continue
        r = e.get("roofline") or {}
        pk = pk or r
        rows.append(
            f"| {e['name']} | {e['seconds'] * 1e6:.1f} "
            f"| {_fmt_rate(r.get('flops'), 'F')} "
            f"| {_fmt_rate(r.get('achieved_flops'), 'FLOP/s')} "
            f"| {r.get('frac_flops', 0.0) * 100:.2f}% "
            f"| {_fmt_rate(r.get('achieved_bandwidth'), 'B/s')} "
            f"| {r.get('frac_bandwidth', 0.0) * 100:.2f}% "
            f"| {r.get('bound', '—')} | {r.get('frac_bound', 0.0) * 100:.3f}% "
            f"| {r.get('source', '—')} |")
    if not rows:
        rows = ["| (no timed entries with roofline data) | | | | | | | | | |"]
    tail = []
    if pk:
        tail = ["", f"peaks: {_fmt_rate(pk.get('peak_flops'), 'FLOP/s')} compute, "
                    f"{_fmt_rate(pk.get('peak_bandwidth'), 'B/s')} bandwidth"]
    return "\n".join(head + rows + tail)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    with open(args[0], encoding="utf-8") as f:
        doc = json.load(f)
    print(markdown_summary(doc))
    if len(args) > 1:
        with open(args[1], "w", encoding="utf-8") as f:
            f.write(markdown_summary(doc) + "\n")
        print(f"\nwrote {args[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
