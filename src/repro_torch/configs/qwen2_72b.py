"""qwen2-72b — dense GQA LM with QKV bias [arXiv:2407.10671; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    activation="silu",
    gated_mlp=True,
    qkv_bias=True,
    norm_type="rmsnorm",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    notes="GQA kv=8, QKV bias. Train cell needs FSDP+TP+accum. "
    "Full attention -> long_500k skipped.",
)
