"""grok-1-314b — MoE (8 experts, top-2) with attention logit soft-cap
[hf xai-org/grok-1; unverified]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    n_heads=48,
    kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    activation="gelu",
    gated_mlp=True,
    num_experts=8,
    top_k=2,
    attn_softcap=30.0,
    norm_type="rmsnorm",
    tie_embeddings=True,
    rope_theta=10000.0,
    layer_groups=(32, 32),
    notes="Full attention -> long_500k skipped. Soft-capped logits (30).",
)
