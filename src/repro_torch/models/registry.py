"""Architecture registry: configs, reduced smoke configs and model constructors.

All ten of the reference's architectures are registered: the dense yi-6b,
gemma-2b, qwen2-72b and nemotron-4-340b, the mixture-of-experts
mixtral-8x22b (with a sliding window) and grok-1-314b (with a logit
soft-cap), the hybrid recurrentgemma-2b, the ssm rwkv6-3b, the
encoder-decoder whisper-small and the vision-language internvl2-1b.  The
reference's per-cell `input_specs` wait for the dry-run's slice (ROADMAP
Queue 1 item 13b)."""

from __future__ import annotations

import importlib
from typing import Any

from repro_torch.configs.base import ModelConfig

ARCHS = {
    "yi-6b": "repro_torch.configs.yi_6b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}

# Speculative-decoding pairings: target arch -> the small arch that drafts
# for it.  A pairing is only meaningful when the two models share a token
# space (true for the reduced smoke configs, which all use vocab=512).
# Targets absent from this table self-draft.
DRAFTS = {
    "qwen2-72b": "gemma-2b",
    "yi-6b": "gemma-2b",
    "nemotron-4-340b": "gemma-2b",
    "grok-1-314b": "yi-6b",
    "mixtral-8x22b": "yi-6b",
}


def draft_for(name: str) -> str | None:
    """The registry's draft pairing for `name` (None: self-draft)."""
    return DRAFTS.get(name)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).CONFIG


def reduced_config(name: str) -> ModelConfig:
    """Family-preserving reduced config for CPU smoke tests."""
    cfg = get_config(name)
    kw: dict[str, Any] = dict(
        num_layers=2, d_model=64, n_heads=4, kv_heads=max(1, min(cfg.kv_heads, 2)),
        head_dim=16, d_ff=128, vocab=512, layer_groups=(),
    )
    if cfg.family == "moe":
        kw.update(num_experts=4, top_k=2)
    if cfg.family == "hybrid":
        kw.update(num_layers=3, lru_width=64, local_window=16, n_heads=4,
                  head_dim=16, kv_heads=1)
    if cfg.family == "ssm":
        kw.update(rwkv_head_dim=16, n_heads=4, kv_heads=4)
    if cfg.family == "encdec":
        kw.update(enc_layers=2)
    if cfg.family == "vlm":
        kw.update(num_image_tokens=8)
    if cfg.attn_window:
        kw.update(attn_window=16)
    return cfg.replace(name=cfg.name + "-reduced", **kw)


def build_model(cfg: ModelConfig):
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg)
    from repro_torch.models.lm import TransformerLM

    return TransformerLM(cfg)
