"""mixtral-8x22b — MoE (8 experts, top-2) with sliding-window attention
[arXiv:2401.04088; hf mistralai/Mixtral-8x22B]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    n_heads=48,
    kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    activation="silu",
    gated_mlp=True,
    num_experts=8,
    top_k=2,
    attn_window=4096,
    norm_type="rmsnorm",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    notes="SWA window 4096 -> ring KV cache, long_500k RUNS. "
    "8 experts vs 16-way model axis: experts replicated, TP inside experts.",
)
