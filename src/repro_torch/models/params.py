"""Parameter trees: the JAX package's nested parameter dicts as modules.

A :class:`ParamTree` registers a nested dict of tensors as parameters under
the same names, one submodule a dict level, so ``state_dict()`` keys are
the JAX tree's paths joined by dots (``layers.stacked.attn.wq``).
:meth:`ParamTree.tree` hands the parameters back as the nested dict that
the functional layers (:mod:`repro_torch.models.layers`) take, and
:func:`params_from_jax` turns a JAX parameter tree, given as numpy arrays,
into a state dict that ``load_state_dict`` maps onto the module.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


class ParamTree(nn.Module):
    """A nested dict of tensors, registered as parameters under its own
    names."""

    def __init__(self, tree: Dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, nn.Parameter(value))

    def tree(self) -> Dict:
        """The parameters as a nested dict (the tensors themselves)."""
        out = dict(self._parameters)
        out.update((name, child.tree()) for name, child in self._modules.items()
                   if isinstance(child, ParamTree))
        return out


def tree_map(fn: Callable, tree: Dict) -> Dict:
    """``fn`` on every leaf of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def tree_items(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(dotted path, leaf) pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as a state dict of CPU tensors
    for the port's module of the same model: ``module.load_state_dict(
    params_from_jax(tree))``.  Both layer layouts map (``layers.stacked.*``
    with a leading layer axis, or ``layers.layer_{i}.*``); a strict load
    refuses a tree of another layout or shape."""
    return {name: torch.from_numpy(np.array(leaf, copy=True)) for name, leaf in tree_items(tree)}
