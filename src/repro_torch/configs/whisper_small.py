"""Whisper-small backbone: 12L encoder + 12L decoder; the audio conv
frontend is a STUB (input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64,
    enc_layers=12, enc_len=1500, tie_embeddings=True,
)
