"""Serve signature features over concurrently growing tick streams, with the
PyTorch port.

A steady-state serving loop: N named streams receive ticks, the server
coalesces all pending appends per flush into batched bucketed updates
(admission batching), and each stream answers O(1) signature / rolling /
RFF-feature queries from its per-prefix store.  Prints a latency and
throughput report plus the admission-batching counters.  The PyTorch
counterpart of ``examples/serve_sig_features.py``, with its flags, loop,
report and admission check; it runs on the card unless given
``--device cpu``, and each latency ends in a synchronise of the card.

    PYTHONPATH=src python examples/serve_sig_features_torch.py --streams 8 --ticks 64
"""

import argparse
import time

import torch

from repro_torch import FeatureConfig, TransformPipeline
from repro_torch.api import card_device
from repro_torch.core.transforms import bucket_length
from repro_torch.serve import SigFeatureServer
from repro_torch.stream import trace_counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=64,
                    help="flush rounds (one tick per stream per round)")
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--d", type=int, default=3, help="channels per tick")
    ap.add_argument("--init-len", type=int, default=32)
    ap.add_argument("--window", type=int, default=16,
                    help="rolling / feature query window (points)")
    ap.add_argument("--rank", type=int, default=32, help="RFF feature rank")
    ap.add_argument("--lead-lag", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = card_device(args.device, "serve_sig_features_torch.py")

    def ready(t):
        """Wait for t (a card synchronise; CPU results are ready)."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return t

    tp = TransformPipeline(lead_lag=args.lead_lag)
    srv = SigFeatureServer(
        args.depth, transforms=tp,
        features=FeatureConfig(method="rff", rank=args.rank, depth=args.depth),
        device=dev)

    g = torch.Generator(device=dev).manual_seed(0)
    init = 0.1 * torch.randn((args.streams, args.init_len, args.d), generator=g, device=dev)
    for s in range(args.streams):
        srv.open_stream(f"stream-{s}", init[s])

    # warm the build / update operations at the capacity and group buckets
    # the steady state will visit, so tick 0 is served warm
    capacity = bucket_length(args.init_len + args.ticks)
    t_warm = srv.warmup(lengths=(args.init_len, capacity), chunk_sizes=(1,),
                        group_sizes=(args.streams,))

    ticks = 0.05 * torch.randn((args.ticks, args.streams, args.d), generator=g, device=dev)

    append_lat, query_lat, feat_lat = [], [], []
    t_loop = time.perf_counter()
    for t in range(args.ticks):
        t0 = time.perf_counter()
        for s in range(args.streams):
            srv.append(f"stream-{s}", ticks[t, s])
        srv.flush()
        ready(srv.signature("stream-0"))
        t1 = time.perf_counter()
        ready(srv.rolling("stream-0", args.window))
        t2 = time.perf_counter()
        ready(srv.features("stream-0", window=args.window))
        t3 = time.perf_counter()
        append_lat.append(t1 - t0)
        query_lat.append(t2 - t1)
        feat_lat.append(t3 - t2)
    wall = time.perf_counter() - t_loop

    def report(name, xs, skip=4):
        xs = sorted(xs[skip:]) if len(xs) > skip else sorted(xs)
        p50 = xs[len(xs) // 2]
        p95 = xs[min(len(xs) - 1, int(0.95 * len(xs)))]
        print(f"  {name:<28s} p50 {p50 * 1e3:8.3f} ms   "
              f"p95 {p95 * 1e3:8.3f} ms")

    n_pts = args.ticks * args.streams
    st = srv.stats()
    print(f"serve_sig_features: {args.streams} streams x {args.ticks} "
          f"ticks, depth {args.depth}, d {args.d}, "
          f"lead_lag={args.lead_lag}, device {dev.type}")
    print(f"  warmup {t_warm:.2f} s; steady loop {wall:.2f} s  "
          f"({n_pts / wall:,.0f} points/s admitted)")
    report("flush + full signature", append_lat)
    report(f"rolling({args.window}) windows", query_lat)
    report(f"rff features (rank {args.rank})", feat_lat)
    print(f"  admission: {st['flushes']} flushes -> "
          f"{st['update_groups']} batched groups "
          f"({st['coalesced_streams']} stream-updates coalesced, "
          f"{st['solo_updates']} solo/growth)")
    print(f"  stream calls: {trace_counts()}")
    # admission batching must keep update invocations per flush near 1 —
    # far below one per stream (growth rounds route a few streams solo)
    invocations = st["update_groups"] + st["solo_updates"]
    if invocations > 2 * st["flushes"] + args.streams:
        raise RuntimeError(
            f"admission batching degraded: {invocations} update invocations "
            f"for {st['flushes']} flushes of {args.streams} streams")
    return st


if __name__ == "__main__":
    main()
