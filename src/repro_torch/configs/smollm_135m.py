"""SmolLM-135M: llama-architecture small dense LM.
[hf:HuggingFaceTB/SmolLM-135M; hf-verified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152, head_dim=64,
    tie_embeddings=True, rope_theta=10000.0,
)
