"""Signature-kernel losses (MMD², scoring rule), differentiable with the
exact one-pass backward.

Counterpart of ``repro/core/losses.py``.  Each Gram term goes through
:func:`repro_torch.core.gram.sigkernel_gram`, whose symmetric
``Kxx``/``Kyy`` terms solve only the upper triangle.  With ``streaming=``
on (auto-enabled whenever ``row_block=`` is set) every term goes through
:func:`repro_torch.core.gram.sigkernel_gram_reduce` instead, which sums per
row block under ``torch.utils.checkpoint`` in the forward and the backward,
so the (B, B) Grams never exist; the streaming guard
(``check_streaming=True``) proves it once per shape and config, on fake
tensors, before a streaming term runs.  ``features=`` (a
:class:`repro_torch.core.features.FeatureConfig`) reduces every term in
feature space instead, O(B·rank), streaming by default; ``error_budget=``
lets each term take a cheaper engine the autotune cache measured within the
budget (streaming by default too), as in
:func:`repro_torch.core.gram.sigkernel_gram`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .config import resolve_kernel_configs
from .gram import sigkernel_gram, sigkernel_gram_reduce
from repro_torch import spans


def _use_streaming(streaming: Optional[bool], row_block: Optional[int],
                   approx: bool = False) -> bool:
    """``streaming=None`` means auto: stream iff the caller bounded memory
    with ``row_block=``, or an approximation is active (its feature-space
    reduction never forms a Gram).  Explicit True/False always wins."""
    if streaming is None:
        return row_block is not None or approx
    return bool(streaming)


@spans.spanned(spans.ENTRY_MMD2)
def mmd2(X: torch.Tensor, Y: torch.Tensor, *, transforms=None, grid=None,
         static_kernel=None, unbiased: bool = True, backend: str = "auto",
         row_block: Optional[int] = None, streaming: Optional[bool] = None,
         lengths=None, lengths_y=None, features=None,
         error_budget=None) -> torch.Tensor:
    """Squared MMD between two path distributions under the signature kernel.

    X: (Bx, L, d) samples from P; Y: (By, L', d) samples from Q.  The
    unbiased estimator needs at least two samples per side.  ``streaming``
    (default: on when ``row_block=``, ``features=`` or ``error_budget=`` is
    set) sums the three Gram terms per block through
    :func:`sigkernel_gram_reduce`, so peak memory follows ``row_block``
    instead of the batch, in the value and the gradient.  ``features=``
    takes the approximate feature map it names; ``error_budget=`` a
    measured cheaper engine within the budget, as in :func:`sigkernel_gram`.
    """
    bx, by = X.shape[0], Y.shape[0]
    if unbiased and min(bx, by) < 2:
        raise ValueError(
            f"unbiased MMD needs >= 2 samples per side (got Bx={bx}, "
            f"By={by}); the 1/(b·(b-1)) normaliser is NaN at b=1 — "
            "pass unbiased=False")
    cfg, g, kernel = resolve_kernel_configs(transforms, grid, static_kernel)
    approx = features is not None or error_budget is not None
    kw = dict(transforms=cfg, grid=g, static_kernel=kernel, backend=backend,
              row_block=row_block, features=features, error_budget=error_budget)
    if _use_streaming(streaming, row_block, approx):
        rkw = dict(kw, check_streaming=True)
        sxx_sum = sigkernel_gram_reduce(X, lengths=lengths, include_diag=not unbiased,
                                        **rkw)
        syy_sum = sigkernel_gram_reduce(Y, lengths=lengths_y,
                                        include_diag=not unbiased, **rkw)
        sxy_sum = sigkernel_gram_reduce(X, Y, lengths=lengths, lengths_y=lengths_y,
                                        **rkw)
        if unbiased:
            sxx = sxx_sum / (bx * (bx - 1))
            syy = syy_sum / (by * (by - 1))
        else:
            sxx = sxx_sum / (bx * bx)
            syy = syy_sum / (by * by)
        return sxx + syy - 2.0 * sxy_sum / (bx * by)
    Kxx = sigkernel_gram(X, lengths=lengths, **kw)   # upper triangle only
    Kyy = sigkernel_gram(Y, lengths=lengths_y, **kw)
    Kxy = sigkernel_gram(X, Y, lengths=lengths, lengths_y=lengths_y, **kw)
    if unbiased:
        sxx = (Kxx.sum() - torch.trace(Kxx)) / (bx * (bx - 1))
        syy = (Kyy.sum() - torch.trace(Kyy)) / (by * (by - 1))
    else:
        sxx = Kxx.mean()
        syy = Kyy.mean()
    return sxx + syy - 2.0 * Kxy.mean()


def scoring_rule(X: torch.Tensor, y: torch.Tensor, *, transforms=None, grid=None,
                 static_kernel=None, backend: str = "auto",
                 row_block: Optional[int] = None, streaming: Optional[bool] = None,
                 lengths=None, length_y=None, features=None,
                 error_budget=None) -> torch.Tensor:
    """Signature-kernel score E[k(X,X')]/2 − E[k(X,y)] for one observation
    y (L, d); ``E[k(X,X')]`` averages over distinct pairs.  ``streaming``,
    ``features`` and ``error_budget`` as in :func:`mmd2`."""
    b = X.shape[0]
    if b < 2:
        raise ValueError(
            f"scoring_rule needs an ensemble of >= 2 paths (got B={b}); "
            "the 1/(b·(b-1)) normaliser is NaN at b=1")
    cfg, g, kernel = resolve_kernel_configs(transforms, grid, static_kernel)
    approx = features is not None or error_budget is not None
    kw = dict(transforms=cfg, grid=g, static_kernel=kernel, backend=backend,
              row_block=row_block, features=features, error_budget=error_budget)
    ly = None if length_y is None else torch.as_tensor(length_y).reshape(1)
    if _use_streaming(streaming, row_block, approx):
        rkw = dict(kw, check_streaming=True)
        exx_sum = sigkernel_gram_reduce(X, lengths=lengths, include_diag=False, **rkw)
        exy_sum = sigkernel_gram_reduce(X, y[None], lengths=lengths, lengths_y=ly, **rkw)
        return 0.5 * exx_sum / (b * (b - 1)) - exy_sum / b
    Kxx = sigkernel_gram(X, lengths=lengths, **kw)
    exx = (Kxx.sum() - torch.trace(Kxx)) / (b * (b - 1))
    Kxy = sigkernel_gram(X, y[None], lengths=lengths, lengths_y=ly, **kw)
    return 0.5 * exx - Kxy.mean()


def sig_aux_loss(hidden: torch.Tensor, target: torch.Tensor, *, proj: torch.Tensor,
                 transforms=None, grid=None, static_kernel=None, backend: str = "auto",
                 row_block: Optional[int] = None, streaming: Optional[bool] = None,
                 lengths=None, lengths_target=None, features=None,
                 error_budget=None) -> torch.Tensor:
    """Auxiliary signature-kernel loss between a model's hidden trajectory
    and a target path distribution: the biased :func:`mmd2` between
    ``hidden @ proj / sqrt(H)`` and ``target``.

    hidden: (B, L, H) hidden states; proj: (H, d) projection into a
    low-dimensional path space; target: (B', L', d) reference paths.
    ``lengths`` / ``lengths_target`` make either side ragged;
    ``streaming=``, ``row_block=``, ``features=`` and ``error_budget=`` pass
    through to :func:`mmd2` (an approximation makes the loss O(B·rank)).
    """
    cfg, g, kernel = resolve_kernel_configs(transforms, grid, static_kernel)
    path = hidden @ proj
    # scale by the width so the PDE stays well-conditioned for wide layers
    path = path / torch.sqrt(torch.tensor(proj.shape[0], dtype=path.dtype,
                                          device=path.device))
    return mmd2(path, target, transforms=cfg, grid=g, static_kernel=kernel,
                unbiased=False, backend=backend, row_block=row_block,
                streaming=streaming, lengths=lengths, lengths_y=lengths_target,
                features=features, error_budget=error_budget)
