"""Zamba2-2.7B: Mamba-2 backbone with a shared full-attention block
applied every 6 SSM blocks (simplified from the alternating two-block
scheme; noted in DESIGN.md).
[arXiv:2411.15242; hf-verified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
    shared_attn_every=6,
)
