"""Architecture registry: configs, reduced smoke configs and model constructors.

All ten of the reference's architectures are registered: the dense yi-6b,
gemma-2b, qwen2-72b and nemotron-4-340b, the mixture-of-experts
mixtral-8x22b (with a sliding window) and grok-1-314b (with a logit
soft-cap), the hybrid recurrentgemma-2b, the ssm rwkv6-3b, the
encoder-decoder whisper-small and the vision-language internvl2-1b.  Each
(arch x shape) cell's step inputs are described by `input_specs`, as
`(shape, dtype)` leaves that allocate nothing (the dry run and the roofline
make meta tensors of them)."""

from __future__ import annotations

import importlib
from typing import Any

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

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


# ---------------------------------------------------------------------------
# Input specs ((shape, dtype) stand-ins; never allocate)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig | str) -> dict[str, Any]:
    """Returns {"inputs": ..., "cache": ... (decode only)}, trees of
    `(shape, dtype)` leaves.

    train : tokens/labels (B, S)  [+frames/embeds for stub frontends]
    prefill: tokens (B, S)        [+frames/embeds]
    decode : tokens (B, 1), positions (B, 1), cache with seq_len entries
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    model = build_model(cfg)

    def text_inputs(seq, with_labels):
        d: dict[str, Any] = {"tokens": ((B, seq), i32)}
        if with_labels:
            d["labels"] = ((B, seq), i32)
        return d

    decode_inputs = {"tokens": ((B, 1), i32), "positions": ((B, 1), i32)}
    if cfg.family == "encdec":
        if shape.kind == "decode":
            return {"inputs": decode_inputs, "cache": model.cache_specs(B, S, enc_len=S)}
        inp = text_inputs(S, shape.kind == "train")
        inp["frames"] = ((B, S, cfg.d_model), bf16)
        return {"inputs": inp, "cache": None}

    if cfg.family == "vlm":
        if shape.kind == "decode":
            return {"inputs": decode_inputs, "cache": model.cache_specs(B, S)}
        P = cfg.num_image_tokens
        inp = text_inputs(S - P, shape.kind == "train")
        inp["embeds"] = ((B, P, cfg.d_model), bf16)
        return {"inputs": inp, "cache": None}

    if shape.kind == "decode":
        return {"inputs": decode_inputs, "cache": model.cache_specs(B, S)}
    return {"inputs": text_inputs(S, shape.kind == "train"), "cache": None}


def cells(arch: str) -> list[str]:
    """Supported (arch x shape) cells; long_500k only for sub-quadratic."""
    return get_config(arch).supported_shapes()


def all_cells() -> list[tuple[str, str]]:
    return [(arch, shape) for arch in ARCHS for shape in cells(arch)]


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape not in cfg.supported_shapes():
                out.append((arch, shape, "full-attention arch: long_500k needs "
                            "sub-quadratic attention (DESIGN.md §5)"))
    return out
