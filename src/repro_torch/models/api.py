"""Top-level model API: ``build_model(cfg)`` -> a :class:`Model` module whose
``loss(batch)`` gives ``(loss, metrics)`` and whose ``prefill``,
``cache_init`` and ``decode`` serve it.

Counterpart of ``repro/models/api.py`` for the dense, MoE, vlm (the dense
LM behind stubbed patch embeddings, ``batch["patches"]``), SSM (Mamba-2)
and hybrid (RecurrentGemma) decoder-only families and the encoder-decoder
(Whisper) family, :class:`EncDecModel`.  The paper's technique
attaches as the optional signature-kernel auxiliary loss on the hidden-state
trajectory (``cfg.sig_loss``), through the port's
:func:`repro_torch.core.losses.sig_aux_loss`, whose exact backward runs the
Goursat kernels on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..api import card_device
from ..core.config import GridConfig
from ..core.losses import sig_aux_loss
from ..parallel.api import current_rules, gather_fsdp, shard
from . import layers as L
from . import transformer as T
from . import whisper as W
from .params import ParamTree

VOCAB_ALIGN = 256


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab // VOCAB_ALIGN) * VOCAB_ALIGN


def _at_use(params: Dict) -> Dict:
    """The tree with the leaves outside the layer stacks gathered over their
    fsdp axes (:func:`repro_torch.parallel.api.gather_fsdp`; the stacks
    gather a layer at a time).  The tree itself outside a mesh."""
    if current_rules() is None:
        return params
    return {k: v if k in ("layers", "enc", "dec") else gather_fsdp(v) for k, v in params.items()}


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
    """A decoder-only LM (:class:`EncDecModel`, its subclass, is the
    encoder-decoder).  Its parameters carry the JAX package's names
    (``embed.table``, ``layers.stacked.attn.wq``, ``layers.layer_0.attn.wq``,
    ``layers.stacked.moe.w_gate``, ``layers.stacked.mixer.in_proj`` or
    ``layers.groups.pos_0.rec.w_x``, ``final_norm.scale``,
    ``lm_head.table``, ``patch_proj``, ``sig_proj``); every method takes
    them from the module, or from ``params`` (a nested dict of the same
    shape, e.g. a compute-dtype copy,
    :func:`repro_torch.train.step.cast_compute`).

    For the vlm family, ``loss`` and ``prefill`` take ``batch["patches"]``
    (B, P, 1024), the stubbed vision front end's patch embeddings: projected
    by ``patch_proj``, they take the place of the first P token embeddings
    (:meth:`embed_inputs`).  Without them the family is the dense LM;
    ``decode`` takes tokens only.

    The serving methods run without autograd.  Decode caches take the
    parameters' layer layout; KV caches hold the compute dtype, RG-LRU
    and SSM states (and the SSM conv windows) float32."""

    def __init__(self, cfg, tree: Dict):
        super().__init__(tree)
        self.cfg = cfg

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def embed_inputs(self, batch: Dict, p: Dict) -> torch.Tensor:
        """The token embeddings of ``batch["tokens"]`` in the compute dtype;
        for the vlm family with ``batch["patches"]`` (B, P, 1024), the first
        P replaced by the patches' projection, computed in the compute dtype
        (a prompt of fewer than P tokens becomes P positions, as in JAX)."""
        cdt = self.compute_dtype
        x = L.embed(p["embed"], batch["tokens"], cdt)
        if self.cfg.family == "vlm" and "patches" in batch:
            pe = batch["patches"].to(cdt) @ p["patch_proj"].to(cdt)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        return shard(x, "batch", "seq", None)

    def loss(self, batch: Dict, params: Optional[Dict] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        p = _at_use(self.tree() if params is None else params)
        if cfg.family == "vlm" and "patches" in batch:
            P, S = batch["patches"].shape[1], batch["tokens"].shape[1]
            if P > S:
                raise ValueError(f"{cfg.name}: {P} patches need at least {P} tokens and "
                                 f"labels, got {S}")
        x = self.embed_inputs(batch, p)
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
    def prefill(self, batch: Dict, params: Optional[Dict] = None,
                caches: Optional[Dict] = None):
        """The prompt ``batch["tokens"]`` (B, S) (with a vlm config's
        ``batch["patches"]``) through the model, building the decode caches,
        of ``batch.get("max_len", S)`` positions, or filling ``caches``
        (as :meth:`cache_init` makes them; on a mesh, laid out by the
        caller).  Returns (the last position's logits (B, 1, padded vocab),
        caches)."""
        cfg = self.cfg
        p = _at_use(self.tree() if params is None else params)
        x = self.embed_inputs(batch, p)
        positions = torch.arange(x.shape[1], device=x.device)
        max_len = int(batch.get("max_len", x.shape[1]))
        x, caches = T.stack_prefill(p["layers"], x, positions, cfg, max_len, self.compute_dtype,
                                    caches)
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
        p = _at_use(self.tree() if params is None else params)
        x = shard(L.embed(p["embed"], tokens, self.compute_dtype), "batch", None, None)
        x, caches = T.stack_decode(p["layers"], x, caches, int(cur_len), cfg)
        x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
        return _logits(p, x, cfg), caches


class EncDecModel(Model):
    """The encoder-decoder (Whisper).  Its parameters carry the JAX
    package's names (``enc.stacked.attn.wq``, ``dec.layer_0.cross.wk``,
    ``embed.table``, ``ln_enc.scale``, ``ln_out.bias``, ``sig_proj``); the
    embedding is tied (no ``lm_head``).  Every method takes
    ``batch["frames"]`` (B, n_audio_frames, d_model), the stubbed front
    end's frame embeddings, beside the tokens, cast to the compute dtype.
    Decode caches hold, per decoder layer, its KV cache and its cross K/V
    (``ck``, ``cv``), all in the compute dtype."""

    def encode(self, batch: Dict, params: Optional[Dict] = None) -> torch.Tensor:
        """The encoder states of ``batch["frames"]``, after ``ln_enc``."""
        p = _at_use(self.tree() if params is None else params)
        enc = W.encoder_apply(p["enc"], batch["frames"].to(self.compute_dtype), self.cfg)
        return L.layernorm(p["ln_enc"], enc, self.cfg.norm_eps)

    def loss(self, batch: Dict, params: Optional[Dict] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        p = _at_use(self.tree() if params is None else params)
        enc = self.encode(batch, p)
        temb = L.embed(p["embed"], batch["tokens"], self.compute_dtype)
        x = W.decoder_apply(p["dec"], temb, enc, cfg)
        x = L.layernorm(p["ln_out"], x, cfg.norm_eps)
        ce = L.cross_entropy(_logits(p, x, cfg), batch["labels"])
        metrics = {"ce": ce}
        total = ce
        if cfg.sig_loss:
            sl = _sig_aux(p, x, batch, cfg)
            total = total + cfg.sig_loss_weight * sl
            metrics["sig"] = sl
        return total, metrics

    @torch.no_grad()
    def prefill(self, batch: Dict, params: Optional[Dict] = None,
                caches: Optional[Dict] = None):
        """The frames through the encoder and the prompt ``batch["tokens"]``
        (B, S) through the decoder, building the decode caches of
        ``batch.get("max_len", S)`` positions, or filling ``caches`` as
        :meth:`Model.prefill` does.  Returns (the last
        position's logits (B, 1, padded vocab), caches)."""
        cfg = self.cfg
        p = _at_use(self.tree() if params is None else params)
        enc = self.encode(batch, p)
        max_len = int(batch.get("max_len", batch["tokens"].shape[1]))
        temb = L.embed(p["embed"], batch["tokens"], self.compute_dtype)
        x, caches = W.decoder_prefill(p, temb, enc, cfg, max_len, self.compute_dtype, caches)
        x = L.layernorm(p["ln_out"], x, cfg.norm_eps)
        return _logits(p, x[:, -1:], cfg), caches

    def cache_init(self, batch_size: int, max_len: int) -> Dict:
        """Decode caches for ``batch_size`` sequences of up to ``max_len``
        positions, the cross K/V those of zero encoder states (serving
        fills them with :meth:`prefill`)."""
        cfg = self.cfg
        enc = torch.zeros((batch_size, cfg.n_audio_frames, cfg.d_model),
                          dtype=self.compute_dtype, device=self.embed.table.device)
        return W.dec_cache_init(self.tree(), enc, cfg, batch_size, max_len, self.compute_dtype)

    @torch.no_grad()
    def decode(self, caches: Dict, tokens: torch.Tensor, cur_len, params: Optional[Dict] = None):
        """One token a sequence, ``tokens`` (B, 1), at position ``cur_len``;
        updates ``caches`` in place and returns (logits, caches)."""
        cfg = self.cfg
        p = _at_use(self.tree() if params is None else params)
        x = L.embed(p["embed"], tokens, self.compute_dtype)
        x, caches = W.decoder_decode(p, x, caches, int(cur_len), cfg)
        x = L.layernorm(p["ln_out"], x, cfg.norm_eps)
        return _logits(p, x, cfg), caches


def init_params(generator: torch.Generator, cfg) -> Dict:
    """The model's parameter tree, drawn on the generator's device."""
    vp = padded_vocab(cfg)
    if cfg.family == "encdec":
        params = W.init(generator, cfg.replace(vocab=vp))
        if cfg.sig_loss:
            params["sig_proj"] = L.dense_init(generator, cfg.d_model, cfg.sig_loss_dim)
        return params
    dev = generator.device
    params = {"embed": L.embed_init(generator, vp, cfg.d_model),
              "final_norm": L.rmsnorm_init(cfg.d_model, dev),
              "layers": T.stack_init(generator, cfg)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.embed_init(generator, vp, cfg.d_model)
    if cfg.family == "vlm":
        params["patch_proj"] = L.dense_init(generator, 1024, cfg.d_model)
    if cfg.sig_loss:
        params["sig_proj"] = L.dense_init(generator, cfg.d_model, cfg.sig_loss_dim)
    return params


def build_model(cfg, *, seed: int = 0, device=None) -> Model:
    """The model of ``cfg`` with parameters drawn from ``seed``, on the card
    unless ``device="cpu"``: an :class:`EncDecModel` for the encdec family,
    else a :class:`Model` (the dense, moe, vlm, ssm and hybrid families)."""
    g = torch.Generator(device=card_device(device, "build_model"))
    g.manual_seed(seed)
    return (EncDecModel if cfg.family == "encdec" else Model)(cfg, init_params(g, cfg))
