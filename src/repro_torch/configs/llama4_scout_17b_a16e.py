"""Llama-4 Scout 17B-active/16E: top-1 MoE with a shared expert and
chunked local attention (iRoPE); early-fusion frontend stubbed.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    n_experts=16, top_k=1, moe_every=1, shared_expert_ff=8192,
    attn_chunk=8192,
    fsdp=True,
)
