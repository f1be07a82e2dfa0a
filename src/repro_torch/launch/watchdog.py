"""Straggler / hang watchdog for multi-process training.

A copy of ``repro/launch/watchdog.py`` (which imports no JAX).  Each
training process writes a heartbeat file every step; this watchdog checks
staleness and (a) logs stragglers whose step lags the median by more than
``--lag`` steps, (b) kills-and-restarts the training command when any
heartbeat is older than ``--timeout`` seconds (the checkpoint/resume path
makes restarts cheap).  On a real cluster this runs per-host under the job
manager; the logic is host-count agnostic.

    python -m repro_torch.launch.watchdog --pattern 'hb_*.json' \\
        --timeout 300 --restart-cmd 'python -m repro_torch.launch.train ...'
"""

from __future__ import annotations

import argparse
import glob
import json
import subprocess
import sys
import time


def scan(pattern):
    beats = []
    for path in glob.glob(pattern):
        try:
            with open(path) as f:
                beats.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            continue
    return beats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pattern", required=True)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--lag", type=int, default=5)
    ap.add_argument("--interval", type=float, default=10.0)
    ap.add_argument("--restart-cmd", default=None)
    ap.add_argument("--max-restarts", type=int, default=10)
    args = ap.parse_args(argv)

    restarts = 0
    while True:
        beats = scan(args.pattern)
        now = time.time()
        if beats:
            steps = sorted(b["step"] for b in beats)
            median = steps[len(steps) // 2]
            for b in beats:
                if median - b["step"] > args.lag:
                    print(f"STRAGGLER proc {b.get('process')} at step "
                          f"{b['step']} (median {median})", flush=True)
            stale = [b for b in beats if now - b["time"] > args.timeout]
            if stale:
                print(f"HANG detected ({len(stale)} stale heartbeats)",
                      flush=True)
                if args.restart_cmd and restarts < args.max_restarts:
                    restarts += 1
                    print(f"restart #{restarts}: {args.restart_cmd}",
                          flush=True)
                    subprocess.Popen(args.restart_cmd, shell=True)
                else:
                    sys.exit(1)
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
