"""Architecture configs (exact public configurations) + registry population.

A copy of ``repro.configs``: the ten assigned architectures and the
paper's own Gram workload, as data.  Only the dense family builds in the
port so far (:func:`repro_torch.models.build_model`)."""
from . import (qwen2_moe_a2_7b, dbrx_132b, internvl2_76b, whisper_large_v3,
               mamba2_780m, qwen2_72b, granite_34b, deepseek_7b,
               nemotron_4_340b, recurrentgemma_2b, sigkernel_workload)

__all__ = [
    "qwen2_moe_a2_7b", "dbrx_132b", "internvl2_76b", "whisper_large_v3",
    "mamba2_780m", "qwen2_72b", "granite_34b", "deepseek_7b",
    "nemotron_4_340b", "recurrentgemma_2b", "sigkernel_workload",
    "ASSIGNED",
]

ASSIGNED = [
    "qwen2-moe-a2.7b", "dbrx-132b", "internvl2-76b", "whisper-large-v3",
    "mamba2-780m", "qwen2-72b", "granite-34b", "deepseek-7b",
    "nemotron-4-340b", "recurrentgemma-2b",
]
