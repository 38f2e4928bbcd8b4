"""whisper-small — enc-dec audio backbone [arXiv:2212.04356].

The conv frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, S, d_model).  Sinusoidal positions replace
whisper's learned/fixed tables so the assigned 4k/32k cells are
well-defined (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    enc_layers=12,
    d_model=768,
    n_heads=12,
    kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    activation="gelu",
    gated_mlp=False,
    norm_type="layernorm",
    tie_embeddings=True,
    use_rope=False,
    notes="Enc-dec: encoder and decoder both run at the cell's seq_len. "
    "Full attention -> long_500k skipped.",
)
