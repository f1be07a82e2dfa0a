"""Assigned input-shape presets and per-cell input specs.

Counterpart of ``repro/launch/shapes.py``: the same presets, the same skip
reasons (:func:`cell_supported`) and the same microbatch policy.  Where the
JAX package gives ``jax.ShapeDtypeStruct``s, the port gives tensors on the
``meta`` device, which allocate nothing.  The dtypes follow the port:

* every int32 of the JAX specs (``tokens``, ``labels``, ``cur_len``) is
  int64, the dtype the port's ``TokenLM`` draws and indexes with;
* ``patches`` and ``frames`` are bfloat16 and ``sig_target`` float32, as in
  the JAX package;
* :func:`cache_shape_for` builds the model and its decode caches under
  ``FakeTensorMode`` and hands the caches back on the ``meta`` device, in
  the dtypes ``cache_init`` gives them, which are the JAX package's (KV
  caches in the compute dtype, recurrent and SSM states float32, ring
  positions int32), as ``jax.eval_shape`` of the JAX ``model.cache_init``
  does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..models import build_model
from ..models.params import tree_map


@dataclasses.dataclass(frozen=True)
class ShapePreset:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapePreset("train_4k", "train", 4096, 256),
    "prefill_32k": ShapePreset("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapePreset("decode_32k", "decode", 32768, 128),
    "long_500k": ShapePreset("long_500k", "decode", 524288, 1),
}

# the paper's own workloads (pySigLib Table 2 scaled to pod size):
# sig_gram — forward Gram of 4096×4096 path pairs, L=1024, d=8 (MMD eval /
#            hypothesis testing); sig_mmd_train — differentiated MMD with the
#            exact one-pass backward (512×512 pairs, L=256).
SIG_SHAPES = {
    "sig_gram": ShapePreset("sig_gram", "sig_fwd", 1024, 4096),
    "sig_mmd_train": ShapePreset("sig_mmd_train", "sig_train", 256, 512),
}


def cell_supported(cfg, shape: ShapePreset) -> Optional[str]:
    """None if supported, else the skip reason (recorded in EXPERIMENTS.md)."""
    if cfg.family == "sigkernel":
        if shape.kind not in ("sig_fwd", "sig_train"):
            return "LM shapes do not apply to the sig-kernel workload"
        return None
    if shape.kind in ("sig_fwd", "sig_train"):
        return "sig shapes apply only to the sigkernel-workload arch"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("full-attention family: 500k decode requires sub-quadratic "
                "sequence mixing (run for ssm/hybrid only, per spec)")
    return None


def _spec(shape, dtype=torch.int64) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg, shape: ShapePreset) -> Dict:
    B, S = shape.batch, shape.seq
    batch = {"tokens": _spec((B, S)), "labels": _spec((B, S))}
    if cfg.family == "vlm":
        batch["patches"] = _spec((B, cfg.n_patches, 1024), torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = _spec((B, cfg.n_audio_frames, cfg.d_model), torch.bfloat16)
    if cfg.sig_loss:
        batch["sig_target"] = _spec((B, 32, cfg.sig_loss_dim), torch.float32)
    return batch


def prefill_input_specs(cfg, shape: ShapePreset) -> Dict:
    B, S = shape.batch, shape.seq
    batch = {"tokens": _spec((B, S))}
    if cfg.family == "vlm":
        batch["patches"] = _spec((B, cfg.n_patches, 1024), torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = _spec((B, cfg.n_audio_frames, cfg.d_model), torch.bfloat16)
    return batch


def decode_input_specs(cfg, shape: ShapePreset, cache_shape) -> Dict:
    B = shape.batch
    return {"caches": cache_shape, "tokens": _spec((B, 1)), "cur_len": _spec(())}


def cache_shape_for(cfg, shape: ShapePreset) -> Dict:
    """The decode caches of ``cfg``'s model for ``shape.batch`` sequences of
    ``shape.seq`` positions, as ``meta`` tensors (nothing allocated).  The
    JAX function's ``model`` argument is built here, from ``cfg``."""
    with FakeTensorMode():
        model = build_model(cfg, device="cpu")
        caches = model.cache_init(shape.batch, shape.seq)
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), caches)


def microbatch_policy(cfg, gb: int, batch_shard: int) -> int:
    """Number of sequential microbatches for the train step."""
    if cfg.d_model >= 6000:
        target = 1            # >=30B-class: one sequence per device
    elif cfg.family == "encdec":
        target = 2            # enc-dec holds encoder + decoder activations
    elif cfg.d_model >= 2000:
        target = 4
    else:
        target = 8
    n_mb = max(1, gb // max(batch_shard * target, 1))
    while gb % n_mb or (gb // n_mb) % batch_shard:
        n_mb -= 1
    return max(n_mb, 1)
