"""Model configuration schema for the assigned architectures.

One ``ModelConfig`` drives every family: dense / MoE transformers, Mamba-2
SSMs, Mamba+attention hybrids (zamba2's shared block, or granite's per-layer
pattern of Mamba-2 and attention mixers with a MoE in every layer),
encoder-decoder (whisper) and VLM backbones (paligemma).
``src/repro_torch/configs/<arch>.py`` instantiates the exact public
configurations; ``smoke()`` shrinks any config to a CPU-testable size of the
same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | hybrid_moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True          # False: no positional embedding (NoPE)
    attn_scale: Optional[float] = None  # softmax scale; default head_dim ** -0.5
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert_ff: int = 0      # llama4-style always-on shared expert
    moe_every: int = 1             # MoE layer every N layers (rest dense)
    capacity_factor: float = 1.25
    moe_dropless: bool = False     # compute every routed slot (no capacity)

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0             # N (state size per head)
    ssm_head_dim: int = 64         # P
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_conv: int = 4              # causal conv width
    ssm_chunk: int = 128           # SSD chunk length

    # hybrid (zamba2): a shared attention block applied every k SSM blocks
    shared_attn_every: int = 6

    # hybrid_moe (granite-4.0-h): each layer's mixer, "mamba" or "attention"
    # (one entry per layer), then a MoE; the scalings of the embedding, of
    # each branch before it joins the residual, and of the logits
    layer_types: tuple[str, ...] = ()
    embed_scale: float = 1.0
    residual_scale: float = 1.0
    logits_scale: float = 1.0

    # encoder-decoder (whisper): encoder depth/length (frontend is a stub
    # providing precomputed frame embeddings, per the assignment spec)
    enc_layers: int = 0
    enc_len: int = 1500

    # VLM (paligemma): stubbed SigLIP patch embeddings prepended as a prefix
    vis_prefix_len: int = 256
    vis_embed_dim: int = 1152      # SigLIP-So400m width (stub input dim)

    # llama4: chunked local attention (iRoPE); 0 = full attention
    attn_chunk: int = 0

    # distribution / execution policy
    fsdp: bool = False             # shard weights over the data axis too
    remat: bool = True             # activation checkpointing per layer
    dtype: str = "bfloat16"
    parallelism: str = "tp"        # "tp" | "dp" (dp: no tensor parallelism;
                                   #  batch shards over every mesh axis)
    fsdp_gather: bool = False      # FSDP via per-layer weight all-gather
                                   #  (constraint) instead of GSPMD partial-
                                   #  sum all-reduces of activations
    attn_seq_shard: bool = False   # sequence-parallel attention: shard query
                                   #  time over the model axis (for archs
                                   #  whose head count doesn't divide TP)
    bf16_reduce: bool = False      # accumulate TP output projections in
                                   #  bf16 so cross-chip all-reduces move
                                   #  half the bytes (per-chip MXU partials
                                   #  are still f32 internally)

    def __post_init__(self):
        # a configuration file gives the pattern as a JSON list
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if self.family == "hybrid_moe" and len(self.layer_types) != self.n_layers:
            raise ValueError(f"{self.name}: {len(self.layer_types)} layer_types for "
                             f"{self.n_layers} layers")
        if set(self.layer_types) - {"mamba", "attention"}:
            raise ValueError(f"{self.name}: a layer type is 'mamba' or 'attention', got "
                             f"{sorted(set(self.layer_types))}")

    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layers_of(self, kind: str) -> int:
        """How many layers of ``layer_types`` have the mixer ``kind``."""
        return sum(1 for k in self.layer_types if k == kind)

    def is_moe_layer(self, layer: int) -> bool:
        return self.n_experts > 0 and (layer % self.moe_every == self.moe_every - 1)

    # -- parameter counting (for 6ND roofline cross-checks) ------------------

    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd, h, kv = self.hd(), self.n_heads, self.n_kv_heads
        n = 0
        if self.family in ("dense", "moe", "vlm", "hybrid", "hybrid_moe", "ssm", "encdec"):
            n += v * d  # embeddings
            if not self.tie_embeddings:
                n += d * v  # lm head
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        mlp = 3 * d * ff  # gated (swiglu)
        if self.family in ("dense", "vlm"):
            n += self.n_layers * (attn + mlp + 2 * d)
        elif self.family == "moe":
            moe_layers = sum(1 for l in range(self.n_layers) if self.is_moe_layer(l))
            dense_layers = self.n_layers - moe_layers
            expert_mlp = self.n_experts * 3 * d * ff + d * self.n_experts
            shared = 3 * d * self.shared_expert_ff if self.shared_expert_ff else 0
            n += moe_layers * (attn + expert_mlp + shared + 2 * d)
            n += dense_layers * (attn + mlp + 2 * d)
        elif self.family == "ssm":
            n += self.n_layers * self._ssm_block_params()
        elif self.family == "hybrid":
            n += self.n_layers * self._ssm_block_params()
            n += attn + mlp + 2 * d  # one shared attention block
        elif self.family == "hybrid_moe":
            # every leaf of models/model.py HybridMoELM: the Mamba-2 blocks
            # (with conv bias and dt bias), the attention layers, and in every
            # layer two norms, the router, the experts and the shared expert
            e, se = self.n_experts, self.shared_expert_ff
            mamba = self._ssm_block_params() - d + self.d_inner + 2 * self.ssm_state \
                + self.ssm_nheads
            n += self.layers_of("mamba") * mamba + self.layers_of("attention") * attn
            n += self.n_layers * (2 * d + d * e + e * 3 * d * ff + 3 * d * se)
            n += d  # final norm
        elif self.family == "encdec":
            n += self.enc_layers * (attn + 2 * d * ff + 2 * d)  # relu mlp
            n += self.n_layers * (2 * attn + 2 * d * ff + 3 * d)  # self+cross
        if self.family == "vlm":
            n += self.vis_embed_dim * d  # projector (frontend itself stubbed)
        return n

    def _ssm_block_params(self) -> int:
        d, di = self.d_model, self.d_inner
        nh, ns = self.ssm_nheads, self.ssm_state
        in_proj = d * (2 * di + 2 * ns + nh)  # z, x, B, C, dt
        conv = self.ssm_conv * (di + 2 * ns)
        out = di * d
        extras = 2 * nh + di + d  # A, D, gated-norm, rmsnorm
        return in_proj + conv + out + extras

    def active_param_count(self) -> int:
        """Active parameters per token (MoE uses top_k of n_experts)."""
        if self.family not in ("moe", "hybrid_moe"):
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        moe_layers = self.n_layers if self.family == "hybrid_moe" else \
            sum(1 for l in range(self.n_layers) if self.is_moe_layer(l))
        inactive = moe_layers * (self.n_experts - self.top_k) * 3 * d * ff
        return self.param_count() - inactive


def smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink any config to a CPU-smoke-test size of the same family.  A
    layer pattern becomes four layers with the attention mixer second, and
    its MoE 8 experts with 4 routed per token."""
    small = dict(
        n_layers=2 if cfg.family not in ("hybrid", "hybrid_moe") else 4,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_len=8 if cfg.enc_layers else 1500,
        n_experts=min(cfg.n_experts, 4),
        shared_expert_ff=64 if cfg.shared_expert_ff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_chunk=8,
        shared_attn_every=2,
        vis_prefix_len=4 if cfg.family == "vlm" else cfg.vis_prefix_len,
        vis_embed_dim=32 if cfg.family == "vlm" else cfg.vis_embed_dim,
        fsdp=False,
        remat=False,
        dtype="float32",
    )
    if cfg.layer_types:
        small.update(layer_types=("mamba", "attention", "mamba", "mamba"), n_experts=8, top_k=4)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
