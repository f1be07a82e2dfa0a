"""The paper's own workload: large-batch signature-kernel Gram computation
(pySigLib Table 2 scaled to pod size).  Not an LM; used for the sig-specific
dry-run and roofline rows."""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="sigkernel-workload", family="sigkernel",
    n_layers=0, d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab=0,
))

# Gram-engine settings for the dry-run / roofline cells: per-device row
# blocks keep live Δ memory at row_block·By·L² floats, and the CPU-lowered
# compile cells use the antidiag wavefront.  The JAX package's dry run reads
# these; the port's dry run waits for ROADMAP Queue A item A5.
GRAM_ENGINE_DEFAULTS = dict(backend="antidiag", row_block=2)
