"""DeepSeek-7B: llama-architecture dense MHA (kv == heads).
[arXiv:2401.02954; hf-verified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400, head_dim=128,
    rope_theta=10000.0,
)
