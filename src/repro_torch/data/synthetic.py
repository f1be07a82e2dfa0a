"""Deterministic, stateless, resumable synthetic data.

Counterpart of ``repro/data/synthetic.py``.  Every batch is a pure function
of ``(seed, step)``: :func:`step_generator` seeds a ``torch.Generator`` from
the pair, so a training loop just asks for ``batch_at(step)`` and a restart
at step k sees the same stream.  Each sampler draws its random numbers and
hands them to a pure function of the draws (``_gbm_from_normals``,
``_fbm_from_uniforms``, ``_tokens_from_uniforms``), which the tests feed
the JAX package's own draws: JAX's and torch's generators never agree.

The draws are made on the generator's device.  :class:`TokenLM` and
:class:`PathData` make theirs on the card unless given ``device="cpu"``;
one seed gives other numbers on the card than on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..api import card_device

_MASK = (1 << 64) - 1


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` whose state is a pure function of
    ``(seed, step)`` (a splitmix64 hash of the pair)."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    g = torch.Generator(device=device)
    g.manual_seed(z ^ (z >> 31))
    return g


def _gbm_from_normals(z: torch.Tensor, mu: float, sigma: float) -> torch.Tensor:
    """GBM paths (B, L, d) from standard normal draws z (B, L - 1, d)."""
    B, n, d = z.shape
    dt = 1.0 / max(n, 1)
    dw = z * math.sqrt(dt)
    logp = torch.cumsum((mu - 0.5 * sigma ** 2) * dt + sigma * dw, dim=1)
    logp = torch.cat([z.new_zeros(B, 1, d), logp], dim=1)
    return torch.exp(logp) - 1.0


def gbm_paths(generator: torch.Generator, batch: int, length: int, dim: int,
              mu: float = 0.0, sigma: float = 0.2) -> torch.Tensor:
    """Geometric-Brownian-motion paths (B, L, d), float32, on the
    generator's device: the canonical signature-kernel workload
    distribution (quant-finance time series)."""
    z = torch.randn((batch, length - 1, dim), generator=generator,
                    device=generator.device)
    return _gbm_from_normals(z, mu, sigma)


def _fbm_from_uniforms(u: torch.Tensor, length: int, hurst: float) -> torch.Tensor:
    """Spectral fBM paths (B, L, d) from uniform draws u (B, K, d) in [0, 1)."""
    n_modes = u.shape[1]
    freqs = torch.arange(1, n_modes + 1, dtype=torch.float32, device=u.device)
    amps = freqs ** (-(hurst + 0.5))
    phases = u * 2 * math.pi
    t = torch.linspace(0.0, 1.0, length, device=u.device)
    ang = (2 * math.pi * freqs[None, None, :, None] * t[None, :, None, None]
           + phases[:, None, :, :])                              # (B, L, K, d)
    return (amps[None, None, :, None] * torch.sin(ang)).sum(dim=2)


def fbm_paths(generator: torch.Generator, batch: int, length: int, dim: int,
              hurst: float = 0.7, n_modes: int = 32) -> torch.Tensor:
    """Approximate fractional Brownian motion by spectral synthesis:
    X(t) = Σ_k k^{-(H+1/2)} sin(2πk t + φ_k) with random phases."""
    u = torch.rand((batch, n_modes, dim), generator=generator, device=generator.device)
    return _fbm_from_uniforms(u, length, hurst)


def _tokens_from_uniforms(u: torch.Tensor, vocab: int) -> Dict[str, torch.Tensor]:
    """Zipf-like tokens from uniform draws u (B, S + 1) in [1e-6, 1): a
    heavy head by cubing; the labels are the tokens shifted by one.  The
    cube is taken in float64 and rounded to float32 (a correctly rounded
    cube, as the JAX package's ``u ** 3.0`` nearly always is; float32
    ``u * u * u`` differs from it in a quarter of the draws)."""
    cube = (u.double() ** 3).to(u.dtype)
    toks = torch.clamp_max(cube * vocab, vocab - 1).to(torch.int64)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class TokenLM:
    """Zipf-ish synthetic token stream for LM training.  Tokens are int64
    (the JAX package's are int32)."""
    vocab: int
    seq: int
    batch: int
    seed: int = 0
    n_patches: int = 0          # vlm: prepend patch embeddings
    n_frames: int = 0           # encdec: audio frame embeddings
    d_model: int = 0
    sig_target_dim: int = 0
    device: Optional[str] = None

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        dev = card_device(self.device, "TokenLM")
        g = step_generator(self.seed, step, dev)
        u = torch.rand((self.batch, self.seq + 1), generator=g, device=dev)
        out = _tokens_from_uniforms(1e-6 + (1.0 - 1e-6) * u, self.vocab)
        if self.n_patches:
            out["patches"] = 0.1 * torch.randn(
                (self.batch, self.n_patches, 1024), generator=g, device=dev,
                dtype=torch.bfloat16)
        if self.n_frames:
            out["frames"] = 0.1 * torch.randn(
                (self.batch, self.n_frames, self.d_model), generator=g, device=dev,
                dtype=torch.bfloat16)
        if self.sig_target_dim:
            out["sig_target"] = gbm_paths(g, self.batch, 32, self.sig_target_dim)
        return out


@dataclasses.dataclass(frozen=True)
class PathData:
    """Path-distribution data for signature-kernel workloads.  Only GBM
    paths: ``kind`` must be ``"gbm"`` (the JAX package ignores the field
    and always draws GBM)."""
    batch: int
    length: int
    dim: int
    seed: int = 0
    kind: str = "gbm"
    device: Optional[str] = None

    def batch_at(self, step: int) -> torch.Tensor:
        if self.kind != "gbm":
            raise ValueError(f"PathData draws GBM paths only, got kind={self.kind!r}")
        g = step_generator(self.seed ^ 0x5161, step, card_device(self.device, "PathData"))
        return gbm_paths(g, self.batch, self.length, self.dim)
