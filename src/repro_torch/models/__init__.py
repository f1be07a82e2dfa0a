"""Model zoo of the port: the architecture configs and the dense, MoE, vlm,
SSM and hybrid LMs and the encoder-decoder (Whisper) as modules whose
parameters carry the JAX package's names, with their serving methods.
Counterpart of ``repro.models``."""

from .api import Model, build_model
from .config import ArchConfig, get_config, list_configs, register
from .params import ParamTree, params_from_jax

__all__ = ["ArchConfig", "Model", "ParamTree", "build_model", "get_config", "list_configs",
           "params_from_jax", "register"]
