"""rwkv6-3b — "Finch": attention-free RNN-LM with data-dependent decay
[arXiv:2404.05892; hf RWKV/rwkv-6-world-3b]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    n_heads=40,  # d_model / rwkv_head_dim
    kv_heads=40,
    d_ff=8960,
    vocab=65536,
    norm_type="layernorm",
    tie_embeddings=False,
    use_rope=False,
    rwkv_head_dim=64,
    notes="Attention-free: attention-sharding aspects inapplicable "
    "(DESIGN.md §5); O(1)-state decode -> long_500k RUNS.",
)
