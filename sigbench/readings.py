"""The readings that the comparison's limits are set from, on the card.

    python3 sigbench/readings.py --workload <cell> --seeds 11,12,... \\
        [--fault control --fault-seeds 21,22,23] [--seconds 2]

For each seed, one short window of the cell at its own size and load, and
the compared numbers of its sampled calls (the program's readings); then,
with ``--fault``, the same under that broken path: ``control`` puts the
entry's control in the program's place (the control's readings), and
``module:function`` names another fault.  Every seed runs in one process a
card, so set-up is paid once.
Prints one JSON line a seed.  The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(cell, seeds, fault, seconds, dev, rank=0, world=1, mesh=None) -> list:
    from sigbench import harness
    out = []
    for seed in seeds:
        t0 = time.time()
        r = harness.measure(cell, seed, seconds, False, dev, time.time(), rank=rank,
                            world=world, mesh=mesh, fault=fault)
        if rank == 0:
            out.append({"seed": seed, "fault": fault, "numbers": r["check"]["numbers"],
                        "correct": r["check"]["correct"], "calls": r["attempted"],
                        "failed": r["failed"], "seconds": time.time() - t0})
    return out


def _rank_readings(rank, world, cell, jobs, seconds):
    import torch
    from repro_torch.launch import make_gram_mesh
    nccl = torch.distributed.get_backend() == "nccl"
    dev = torch.device("cuda", rank) if nccl else torch.device("cpu")
    mesh = make_gram_mesh()
    return [row for seeds, fault in jobs
            for row in readings(cell, seeds, fault, seconds, dev, rank, world, mesh)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from sigbench import spec
    cell = spec.load_cell(args.workload)
    jobs = [(_seeds(args.seeds), None)]
    if args.fault:
        jobs.append((_seeds(args.fault_seeds), args.fault))
    world = int(cell.config.get("ranks", 1))
    if world > 1:
        from repro_torch.launch import spawn_ranks
        rows = spawn_ranks(_rank_readings, world, (cell, jobs, args.seconds),
                           backend="nccl", timeout=3000)[0]
    else:
        dev = torch.device("cuda", 0)
        rows = [row for seeds, fault in jobs
                for row in readings(cell, seeds, fault, args.seconds, dev)]
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
