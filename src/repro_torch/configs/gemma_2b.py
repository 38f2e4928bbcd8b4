"""gemma-2b — dense MQA LM with GeGLU, head_dim 256 [arXiv:2403.08295; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    n_heads=8,
    kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    activation="gelu",
    gated_mlp=True,
    norm_type="rmsnorm",
    norm_plus_one=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
    notes="MQA (kv=1): KV replicated across TP; decode KV cache sequence-sharded. "
    "Full attention -> long_500k skipped.",
)
