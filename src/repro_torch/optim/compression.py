"""Int8 gradient compression with error feedback for a cross-group mean.

Counterpart of ``repro/optim/compression.py``.  Where the interconnect
between groups of ranks is the bottleneck, the mean of a gradient over a
``torch.distributed`` group is replaced by

    all_gather(int8 quantised tensors and their scales) + local dequant-sum

which moves about a quarter of the bytes of a float32 all-reduce.  The
quantisation error is carried to the next step in an error-feedback
accumulator (per parameter, float32), which keeps EF-SGD convergent
(Karimireddy et al. 2019).  A process group takes the place of the JAX
package's ``shard_map`` axis name:

    g_mean, ef_new = psum_compressed(g_local, ef, group)

The arithmetic is the JAX package's, in its order: the scale is
``max|x| / 127 + 1e-30`` in float32, the quotient rounds half to even and
is clipped to ±127.  Every division has a tensor divisor: on the card a
Python-number divisor becomes a product with its reciprocal, which rounds
otherwise than the division (for a max|x| of 1.3728498, say), so the card
would disagree with the CPU and the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.params import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: int8 ``q`` with ``q * scale ≈ x``; ``scale`` a 0-d
    tensor of ``x``'s dtype."""
    scale = torch.max(torch.abs(x)) / x.new_tensor(127.0) + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def psum_compressed(g: torch.Tensor, ef: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``g`` over the ranks of ``group`` (default: the whole world)
    with int8 error-feedback compression.

    ``g``, ``ef``: this rank's float32 tensors of one shape.  Every rank
    gathers every rank's int8 tensor and scale, dequantises and sums them
    in rank order and divides by the group's size, so every rank returns
    the same mean.  Returns ``(mean, new_ef)``.  Needs an initialised
    process group (gloo for CPU tensors, NCCL for card tensors)."""
    x = g + ef
    q, scale = quantize_int8(x)
    ef_new = x - dequantize(q, scale)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)            # int8 on the wire
    dist.all_gather(ss, scale, group=group)
    deq = torch.stack(qs).to(torch.float32) * torch.stack(ss).reshape((n,) + (1,) * g.ndim)
    return deq.sum(dim=0) / deq.new_tensor(float(n)), ef_new


def psum_compressed_tree(grads: Dict, ef_tree: Dict,
                         group: Optional[dist.ProcessGroup] = None) -> Tuple[Dict, Dict]:
    """:func:`psum_compressed` on every leaf of a nested dict of gradients
    (cast to float32) with the matching leaf of ``ef_tree``, leaf by leaf in
    the dict's order (the same on every rank).  Returns ``(mean tree, new
    error-feedback tree)``."""
    out = {k: psum_compressed_tree(g, ef_tree[k], group) if isinstance(g, dict)
           else psum_compressed(g.to(torch.float32), ef_tree[k], group)
           for k, g in grads.items()}
    return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}


def init_error_feedback(params: Dict) -> Dict:
    """Zero float32 error-feedback accumulators shaped like ``params``, on
    their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
