"""internvl2-1b — VLM: InternViT frontend (STUB: patch embeddings provided
by input_specs) + Qwen2-0.5B-class LM backbone [arXiv:2404.16821; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    n_heads=14,
    kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    activation="silu",
    gated_mlp=True,
    qkv_bias=True,
    norm_type="rmsnorm",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    num_image_tokens=256,
    notes="Patch embeddings stubbed (256 image tokens prepended). "
    "Full attention -> long_500k skipped.",
)
