"""yi-6b — llama-arch dense GQA LM [arXiv:2403.04652; hf 01-ai/Yi-6B]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab=64000,
    activation="silu",
    gated_mlp=True,
    norm_type="rmsnorm",
    tie_embeddings=False,
    rope_theta=5_000_000.0,
    notes="GQA kv=4; full attention -> long_500k skipped.",
)
