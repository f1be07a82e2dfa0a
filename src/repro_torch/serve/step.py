"""Serving steps: batched prefill and single-token decode.

Counterpart of ``repro/serve/step.py``.  The JAX steps take the parameters
and cast them to the compute dtype inside ``jit``, where the cast fuses
away; eager, that cast would copy every weight at every token.  So the
port's builders take the compute-dtype tree once, as ``params=`` (by
default :func:`compute_params` of the model, cast when the builder is
called), and the steps take no parameters: ``prefill_step(batch)`` and
``decode_step(caches, tokens, cur_len)``.  Build the prefill and decode
steps on one tree (pass the same ``params``) to hold one copy.  The decode
step updates the caches it is given in place.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..parallel.api import shard
from ..train.step import cast_compute


def compute_params(model) -> Dict:
    """The model's parameters cast to its compute dtype
    (:func:`repro_torch.train.step.cast_compute`); a leaf already of that
    dtype is the parameter itself, not a copy."""
    with torch.no_grad():
        return cast_compute(model.tree(), model.compute_dtype)


def make_prefill_step(model, max_len: Optional[int] = None, *, params: Optional[Dict] = None):
    """``prefill_step(batch, caches=None) -> (logits, caches)``.  max_len:
    the decode caches' capacity (defaults to the prompt length).  The step
    makes the caches, or fills ``caches`` (as ``model.cache_init`` makes
    them; on a mesh the caller lays them out,
    :func:`repro_torch.parallel.sharding.cache_shardings`)."""
    p = compute_params(model) if params is None else params

    def prefill_step(batch, caches=None):
        if max_len is not None:
            batch = dict(batch, max_len=max_len)
        return model.prefill(batch, params=p, caches=caches)

    return prefill_step


def make_decode_step(model, *, greedy: bool = True, temperature: float = 1.0,
                     params: Optional[Dict] = None):
    """Build a one-token decode step.

    ``greedy=True`` (default) argmaxes the last-position logits and the step
    is ``decode_step(caches, tokens, cur_len)``; ``temperature`` is then
    ignored.  ``greedy=False`` samples from ``softmax(logits /
    temperature)`` instead, and the step takes a trailing
    ``torch.Generator`` on the model's device (where the JAX step takes a
    PRNG key): ``decode_step(caches, tokens, cur_len, generator)``.  Either
    returns ``(next_tokens (B, 1) int32, logits, caches)``.
    """
    if not greedy and temperature <= 0:
        raise ValueError(
            f"sampling (greedy=False) needs temperature > 0, got "
            f"{temperature}; use greedy=True for argmax decoding")
    p = compute_params(model) if params is None else params

    if greedy:
        def decode_step(caches, tokens, cur_len):
            """tokens: (B, 1) current tokens; returns (next_tokens, logits, caches)."""
            logits, caches = model.decode(caches, tokens, cur_len, params=p)
            # on a mesh the vocab shards are gathered for the argmax
            last = shard(logits[:, -1, :], "batch", None)
            nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
            return nxt, logits, caches

        return decode_step

    def decode_step(caches, tokens, cur_len, generator: torch.Generator):
        """tokens: (B, 1); returns (next_tokens, logits, caches)."""
        logits, caches = model.decode(caches, tokens, cur_len, params=p)
        probs = torch.softmax(logits[:, -1, :].float() / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)
        return nxt.to(torch.int32), logits, caches

    return decode_step
