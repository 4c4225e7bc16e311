"""PaliGemma-3B backbone: gemma decoder with MQA (kv=1); SigLIP vision
frontend is a STUB (input_specs provides patch embeddings).
[arXiv:2407.07726; hf-verified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257216, head_dim=256,
    vis_prefix_len=256, vis_embed_dim=1152,
)
