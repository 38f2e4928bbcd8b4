"""recurrentgemma-2b — Griffin hybrid: RG-LRU recurrent blocks + local
attention in a (rec, rec, attn) pattern [arXiv:2402.19427; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    n_heads=10,
    kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    activation="gelu",
    gated_mlp=True,
    norm_type="rmsnorm",
    norm_plus_one=True,
    embed_scale=True,
    tie_embeddings=True,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    local_window=2048,
    notes="Recurrent state + windowed attention -> long_500k RUNS "
    "(O(window) decode). MQA on the attention blocks.",
)
