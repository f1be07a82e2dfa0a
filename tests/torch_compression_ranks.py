"""The ranks' side of tests/test_torch_compression.py (gloo) and of the
chip smoke's NCCL check.

Each rank of a ``repro_torch.launch.spawn_ranks`` group imports this module
by name, so it imports torch, numpy and the port only.  Every rank's inputs
are a pure function of (seed, rank), so the JAX side of the test rebuilds
them with :func:`rank_inputs`.
"""

import numpy as np
import torch

from repro_torch.optim import init_error_feedback, psum_compressed, psum_compressed_tree

#: the gradient tree: a matrix, a vector, a scalar and an all-zero leaf, in
#: this insertion order on every rank
TREE_SHAPES = {"w": (5, 7), "layer": {"b": (7,), "s": ()}, "z": (3,)}


def _leaves(shapes, rng, scale):
    out = {}
    for k, s in shapes.items():
        if isinstance(s, dict):
            out[k] = _leaves(s, rng, scale)
        else:
            out[k] = np.asarray(rng.normal(size=s) * scale, np.float32) if k != "z" \
                else np.zeros(s, np.float32)
    return out


def rank_inputs(seed: int, rank: int) -> dict:
    """This rank's inputs: ``g`` (64,) and ``ef`` (64,) for the one-tensor
    call (``ef`` nonzero, a carried error), and two gradient trees of
    :data:`TREE_SHAPES`, one a step (the second 10x smaller)."""
    rng = np.random.default_rng([seed, rank])
    return {"g": (rng.normal(size=64) * 3).astype(np.float32),
            "ef": (rng.normal(size=64) * 1e-2).astype(np.float32),
            "tree": [_leaves(TREE_SHAPES, rng, 10.0 ** -k) for k in range(2)]}


def _torch(tree, device):
    return {k: _torch(v, device) if isinstance(v, dict) else torch.from_numpy(v).to(device)
            for k, v in tree.items()}


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.cpu().numpy() for k, v in tree.items()}


def compressed_rank(rank, world, seed, device_type="cpu") -> dict:
    """One ``psum_compressed`` of this rank's (g, ef), and two steps of
    ``psum_compressed_tree`` from :func:`init_error_feedback` (the second
    carries the first's error), on the rank's device; the results as numpy
    arrays."""
    dev = torch.device(device_type, rank if device_type == "cuda" else 0)
    x = rank_inputs(seed, rank)
    mean, ef = psum_compressed(torch.from_numpy(x["g"]).to(dev),
                               torch.from_numpy(x["ef"]).to(dev))
    steps, ef_tree = [], init_error_feedback(_torch(x["tree"][0], dev))
    for grads in x["tree"]:
        m, ef_tree = psum_compressed_tree(_torch(grads, dev), ef_tree)
        steps.append((_numpy(m), _numpy(ef_tree)))
    return {"mean": mean.cpu().numpy(), "ef": ef.cpu().numpy(), "tree_steps": steps}
