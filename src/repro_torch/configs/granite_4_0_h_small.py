"""IBM Granite 4.0-H Small (32B total, ~9B active): 40 layers of width 4,096,
36 Mamba-2 mixers and 4 GQA attention mixers without positional embedding
(layers 5, 15, 25, 35), each layer followed by a dropless top-10 MoE of 72
SwiGLU experts of width 768 beside a SwiGLU shared expert of width 1,536;
embeddings x12, each branch x0.22 into the residual, softmax scale 1/128,
logits / 16, tied embeddings.  Departures: the SSD chunk is 128 (published
256; the result does not depend on it) and dt comes from the port's own
float32 projection (the published in_proj holds it in bf16).
[hf:ibm-granite/granite-4.0-h-small config.json; hf-verified]"""
from repro_torch.models.config import ModelConfig

ATTENTION_LAYERS = (5, 15, 25, 35)

CONFIG = ModelConfig(
    name="granite-4.0-h-small", family="hybrid_moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=768, vocab=100352, norm_eps=1e-5, tie_embeddings=True,
    use_rope=False, attn_scale=0.0078125,
    n_experts=72, top_k=10, shared_expert_ff=1536, moe_dropless=True,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
    layer_types=tuple("attention" if i in ATTENTION_LAYERS else "mamba" for i in range(40)),
    embed_scale=12.0, residual_scale=0.22, logits_scale=0.0625,
)
