"""Top-level model API: ``build_model(cfg)`` -> a :class:`Model` module whose
``loss(batch)`` gives ``(loss, metrics)`` and whose ``prefill``,
``cache_init`` and ``decode`` serve it.

Counterpart of ``repro/models/api.py`` for the dense and hybrid
(RecurrentGemma) decoder-only families.  The paper's technique attaches as
the optional signature-kernel auxiliary loss on the hidden-state trajectory
(``cfg.sig_loss``), through the port's
:func:`repro_torch.core.losses.sig_aux_loss`, whose exact backward runs the
Goursat kernels on the card.  The moe / vlm / encdec / ssm families wait
for ROADMAP item 8b.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..api import card_device
from ..core.config import GridConfig
from ..core.losses import sig_aux_loss
from . import layers as L
from . import transformer as T
from .params import ParamTree

VOCAB_ALIGN = 256


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab // VOCAB_ALIGN) * VOCAB_ALIGN


def _logits(params, x, cfg):
    table = params["lm_head"] if "lm_head" in params else params["embed"]
    logits = L.unembed(table, x)
    vp = padded_vocab(cfg)
    if vp != cfg.vocab:  # mask synthetic vocab slots
        mask = torch.arange(vp, device=logits.device) < cfg.vocab
        logits = torch.where(mask, logits, -1e30)
    return logits


def _sig_aux(params, hidden, batch, cfg):
    """Signature-kernel MMD between the model's hidden trajectory (32 points
    of it, in float32) and a target path distribution."""
    S = hidden.shape[1]
    stride = max(1, S // 32)
    path_h = hidden[:, ::stride][:, :32].float()
    target = batch["sig_target"].float()
    # float32 @ a compute-dtype projection promotes to float32 in JAX
    return sig_aux_loss(path_h, target, proj=params["sig_proj"].float(),
                        grid=GridConfig(cfg.sig_dyadic, cfg.sig_dyadic))


class Model(ParamTree):
    """A decoder-only LM.  Its parameters carry the JAX package's names
    (``embed.table``, ``layers.stacked.attn.wq``, ``layers.layer_0.attn.wq``
    or ``layers.groups.pos_0.rec.w_x``, ``final_norm.scale``,
    ``lm_head.table``, ``sig_proj``); every method takes them from the
    module, or from ``params`` (a nested dict of the same shape, e.g. a
    compute-dtype copy, :func:`repro_torch.train.step.cast_compute`).

    The serving methods run without autograd.  Decode caches take the
    parameters' layer layout; KV caches hold the compute dtype, RG-LRU
    states float32."""

    def __init__(self, cfg, tree: Dict):
        super().__init__(tree)
        self.cfg = cfg

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def loss(self, batch: Dict, params: Optional[Dict] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        p = self.tree() if params is None else params
        x = L.embed(p["embed"], batch["tokens"], self.compute_dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = T.stack_apply(p["layers"], x, positions, cfg)
        x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
        ce = L.cross_entropy(_logits(p, x, cfg), batch["labels"])
        total = ce + 0.01 * aux
        metrics = {"ce": ce, "aux": aux}
        if cfg.sig_loss:
            sl = _sig_aux(p, x, batch, cfg)
            total = total + cfg.sig_loss_weight * sl
            metrics["sig"] = sl
        return total, metrics

    @torch.no_grad()
    def prefill(self, batch: Dict, params: Optional[Dict] = None):
        """The prompt ``batch["tokens"]`` (B, S) through the model, building
        the decode caches, of ``batch.get("max_len", S)`` positions.
        Returns (the last position's logits (B, 1, padded vocab), caches)."""
        cfg = self.cfg
        p = self.tree() if params is None else params
        x = L.embed(p["embed"], batch["tokens"], self.compute_dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        max_len = int(batch.get("max_len", x.shape[1]))
        x, caches = T.stack_prefill(p["layers"], x, positions, cfg, max_len, self.compute_dtype)
        x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
        return _logits(p, x[:, -1:], cfg), caches

    def cache_init(self, batch_size: int, max_len: int) -> Dict:
        """Zeroed decode caches for ``batch_size`` sequences of up to
        ``max_len`` positions, on the parameters' device."""
        return T.stack_cache_init(self.cfg, batch_size, max_len, self.compute_dtype,
                                  self.embed.table.device)

    @torch.no_grad()
    def decode(self, caches: Dict, tokens: torch.Tensor, cur_len, params: Optional[Dict] = None):
        """One token a sequence, ``tokens`` (B, 1), at position ``cur_len``
        (a Python int, or a 0-d tensor, read once).  Updates ``caches`` in
        place and returns (logits (B, 1, padded vocab), caches)."""
        cfg = self.cfg
        p = self.tree() if params is None else params
        x = L.embed(p["embed"], tokens, self.compute_dtype)
        x, caches = T.stack_decode(p["layers"], x, caches, int(cur_len), cfg)
        x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
        return _logits(p, x, cfg), caches


def init_params(generator: torch.Generator, cfg) -> Dict:
    """The LM's parameter tree, drawn on the generator's device."""
    vp = padded_vocab(cfg)
    dev = generator.device
    params = {"embed": L.embed_init(generator, vp, cfg.d_model),
              "final_norm": L.rmsnorm_init(cfg.d_model, dev),
              "layers": T.stack_init(generator, cfg)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.embed_init(generator, vp, cfg.d_model)
    if cfg.sig_loss:
        params["sig_proj"] = L.dense_init(generator, cfg.d_model, cfg.sig_loss_dim)
    return params


def build_model(cfg, *, seed: int = 0, device=None) -> Model:
    """The LM of ``cfg`` with parameters drawn from ``seed``, on the card
    unless ``device="cpu"``.  The dense and hybrid families build."""
    if cfg.family not in ("dense", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: build_model builds the 'dense' and 'hybrid' families; "
            f"{cfg.family!r} waits for ROADMAP Queue A item 8b")
    g = torch.Generator(device=card_device(device, "build_model"))
    g.manual_seed(seed)
    return Model(cfg, init_params(g, cfg))
