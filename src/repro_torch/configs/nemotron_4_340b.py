"""nemotron-4-340b — dense GQA LM with squared-ReLU MLP [arXiv:2402.16819].

Deviations noted in DESIGN.md: full-dim RoPE (paper uses partial rotary);
LayerNorm per the paper; non-gated squared-ReLU MLP (d_ff 73728).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    n_heads=96,
    kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    activation="relu2",
    gated_mlp=False,
    norm_type="layernorm",
    tie_embeddings=False,
    rope_theta=10000.0,
    layer_groups=(48, 48),
    notes="Largest cell: FSDP x TP, grad accumulation, full remat. "
    "Full attention -> long_500k skipped.",
)
