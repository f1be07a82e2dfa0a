#!/usr/bin/env python3
"""Set the port's dry-run records beside the JAX package's, cell by cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out port.json
    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --all --out jax.json
    python3 tools/dryrun_table.py port.json jax.json > table.md

Prints a markdown table with one row a cell of the sweep, in the sweep's
order: each side's flops and dot flops a device, argument bytes a device,
collective count and link traffic (``skip``, or the op of an ``error``),
the dot-flop ratio port / JAX where both ran, and the seconds each took
(the port's trace, JAX's lower and compile); then the cells that errored
and the sweep's totals.  Reads JSON only.
"""

from __future__ import annotations

import json
import sys


def _key(r):
    return r["arch"], r["shape"], r["mesh"]


def _coll(r):
    c = r.get("collectives") or {}
    return (int(sum(v["count"] for v in c.values())),
            sum(v["traffic"] for v in c.values()))


def _cell(r):
    if r is None:
        return ["—"] * 5
    if "skipped" in r:
        return ["skip"] + [""] * 4
    if "error" in r:
        what = r.get("op") or r["error"].splitlines()[0][:60]
        return [f"error: `{what}`"] + [""] * 4
    n, t = _coll(r)
    return [f"{r['flops']:.4g}", f"{r['hlo_dot_flops']:.4g}",
            f"{r['argument_bytes'] / 2**30:.3f}", str(n), f"{t / 2**30:.3f}"]


def main(port_path: str, jax_path: str) -> int:
    with open(port_path) as f:
        port = {_key(r): r for r in json.load(f)}
    with open(jax_path) as f:
        jax = {_key(r): r for r in json.load(f)}
    print("| arch | shape | mesh | port flops | port dot | port arg GiB | port coll | "
          "port GiB moved | JAX flops | JAX dot | JAX arg GiB | JAX coll | JAX GiB moved | "
          "dot port/JAX | port s | JAX s |")
    print("|" + " --- |" * 16)
    errors, seconds = [], {"port": 0.0, "jax": 0.0}
    for key in port:
        p, j = port[key], jax.get(key)
        ratio = ""
        if p and j and "flops" in p and "flops" in j and j["hlo_dot_flops"] > 0:
            ratio = f"{p['hlo_dot_flops'] / j['hlo_dot_flops']:.3f}"
        ps = p.get("compile_s", "") if p else ""
        js = j.get("compile_s", "") if j else ""
        seconds["port"] += ps or 0.0
        seconds["jax"] += js or 0.0
        print("| " + " | ".join(list(key) + _cell(p) + _cell(j) + [ratio, str(ps), str(js)])
              + " |")
        if p and "error" in p:
            errors.append(f"- {' x '.join(key)}: `{p.get('op', '')}` at `{p.get('where', '')}`")
    n_ok = sum("flops" in r for r in port.values())
    n_skip = sum("skipped" in r for r in port.values())
    print(f"\nport: {len(port)} entries, {n_ok} records, {n_skip} skipped, {len(errors)} errors; "
          f"traced {seconds['port']:.1f} s in all. JAX: "
          f"{sum('flops' in r for r in jax.values())} records, "
          f"{sum('error' in r for r in jax.values())} errors; compiled "
          f"{seconds['jax']:.1f} s in all.")
    if errors:
        print("\nport errors:\n" + "\n".join(errors))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
