"""Whisper-large-v3 — encoder-decoder backbone; conv/mel frontend is a stub
providing 1500 precomputed frame embeddings [arXiv:2212.04356]."""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, act="gelu", n_audio_frames=1500,
    rope_theta=1e4,
))
