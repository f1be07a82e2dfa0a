"""Distributed + streaming signature-kernel Grams with the PyTorch port —
the paper's workload over a group of ranks, runnable on a laptop.

The PyTorch counterpart of parts 1 and 2 of
``examples/gram_matrix_distributed.py`` (B, L, d = 32, 64, 4 GBM paths,
``GridConfig(1, 1)``), run by ``--world N`` ranks that
``repro_torch.launch.spawn_ranks`` starts: NCCL, one rank a card, or gloo
CPU processes with ``--device cpu``.  :func:`rank_main` is what every rank
runs; it is a module-level function, which each rank imports by name.

1. ``sigkernel_gram_sharded`` — the (Bx, By) tile grid of Goursat solves
   block-cyclic sharded over a 2-D (data, model) mesh of the ranks; the
   symmetric fast path deals the upper-triangle pairs round-robin over
   every rank, so the triangular tile grid stays load-balanced.  Ragged
   batches survive sharding unchanged.
2. ``mmd2(..., row_block=)`` — streaming losses: the three Gram terms are
   summed per row block, in the forward and the gradient, so the full
   (B, B) Grams never exist.

Part 3 of the JAX example (jit-sharding the plain engine through JAX's
logical sharding rules) has no PyTorch counterpart.  In its place every
rank holds the sharded Gram against the dense ``sigkernel_gram`` on its
own device, which is part 3's own "engines agree" check; the JAX example's
sub-mesh comparison (one device against the full mesh) is the same check
here, since a torch mesh spans its whole group.

    PYTHONPATH=src python examples/gram_matrix_distributed_torch.py --world 1
    PYTHONPATH=src python examples/gram_matrix_distributed_torch.py --device cpu --world 4
"""

import argparse

import torch

from repro_torch.api import card_device
from repro_torch.core.config import GridConfig
from repro_torch.core.gram import sigkernel_gram, sigkernel_gram_sharded
from repro_torch.core.losses import mmd2
from repro_torch.data.synthetic import gbm_paths
from repro_torch.launch import make_gram_mesh, spawn_ranks

B, L, D = 32, 64, 4


def rank_main(rank: int, world: int, device_type: str) -> dict:
    """Parts 1 and 2 on one rank (``cuda:rank`` or the CPU); returns what
    the report prints, as Python numbers."""
    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if dev.type == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    mesh = make_gram_mesh()          # near-square (data, model) over all ranks
    grid = GridConfig(1, 1)
    # the same seeds on every rank: every rank holds the same X and Y
    X = gbm_paths(torch.Generator(device=dev).manual_seed(0), B, L, D)
    Y = gbm_paths(torch.Generator(device=dev).manual_seed(1), B, L, D)

    # -- 1. the sharded engine: one call, tiles dealt over the whole mesh ----
    K = sigkernel_gram_sharded(X, Y, mesh=mesh, grid=grid)
    # symmetric: upper-triangle pairs (~2x fewer PDE solves) dealt round-robin
    # over every rank, mirrored once on the way out
    Kxx = sigkernel_gram_sharded(X, mesh=mesh, grid=grid)
    # ragged batches: the masking is burnt into the prepared streams before
    # the tiles are dealt
    lengths = torch.tensor([L - (i % 7) for i in range(B)], device=dev)
    Kr = sigkernel_gram_sharded(X, Y, lengths=lengths, mesh=mesh, grid=grid)

    # -- 2. streaming losses: the (B, B) Grams never exist -------------------
    loss_dense = float(mmd2(X, Y, grid=grid))
    loss_stream = float(mmd2(X, Y, grid=grid, row_block=8))
    Xg = X.clone().requires_grad_()
    g, = torch.autograd.grad(mmd2(Xg, Y, grid=grid, row_block=8), Xg)

    # -- in place of part 3: the sharded engine against the dense one -------
    K_dense = sigkernel_gram(X, Y, grid=grid)
    Kr_dense = sigkernel_gram(X, Y, lengths=lengths, grid=grid)
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "backend": torch.distributed.get_backend(), "shape": tuple(K.shape),
            "mean_k": float(K.mean()), "sym_shape": tuple(Kxx.shape),
            "asymmetry": float((Kxx - Kxx.T).abs().max()),
            "ragged_shape": tuple(Kr.shape), "ragged_finite": bool(torch.isfinite(Kr).all()),
            "mmd2_dense": loss_dense, "mmd2_stream": loss_stream,
            "grad_shape": tuple(g.shape), "grad_finite": bool(torch.isfinite(g).all()),
            "dense_err": float((K - K_dense).abs().max()),
            "ragged_dense_err": float((Kr - Kr_dense).abs().max()),
            "K": K.cpu()}


def report(outs) -> None:
    """Print rank 0's results and whether every rank got the same Gram."""
    r = outs[0]
    print(f"ranks: {len(outs)} ({r['backend']}), mesh: {r['mesh']}")
    print("sharded gram:", r["shape"], " E[k(X,Y)] =", r["mean_k"])
    print("sharded symmetric gram:", r["sym_shape"], " max asymmetry:", r["asymmetry"])
    print("ragged sharded gram:", r["ragged_shape"], "finite:", r["ragged_finite"])
    # mmd2 is a small difference of O(1) Gram sums, so compare absolutely:
    # summation order differs between the streaming and dense reductions
    match = abs(r["mmd2_dense"] - r["mmd2_stream"]) <= 1e-5
    print(f"mmd2 dense {r['mmd2_dense']:.6f}  streaming {r['mmd2_stream']:.6f}  "
          f"match: {match}")
    print("streaming grad:", r["grad_shape"], "finite:", r["grad_finite"])
    print("sharded vs dense gram err:", max(o["dense_err"] for o in outs))
    print("ragged sharded vs dense err:", max(o["ragged_dense_err"] for o in outs))
    print("ranks agree:", all(torch.equal(o["K"], r["K"]) for o in outs))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=1,
                    help="ranks (with the card: one rank a card)")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, default) or cpu (gloo)")
    args = ap.parse_args(argv)
    dev = card_device(args.device, "gram_matrix_distributed_torch.py")
    outs = spawn_ranks(rank_main, args.world, (dev.type,),
                       backend="nccl" if dev.type == "cuda" else "gloo")
    report(outs)
    return outs


if __name__ == "__main__":
    main()
