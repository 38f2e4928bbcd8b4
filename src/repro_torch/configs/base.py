"""Model/shape configuration schema covering all assigned architecture
families, plus the four assigned input-shape cells.

Every architecture file in this package instantiates `ModelConfig` with the
exact published numbers (sources in each file) and provides `reduced()`
smoke configs for CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# ---------------------------------------------------------------------------
# Shapes (assigned; identical across LM-family archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | encdec | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # MLP / block details
    activation: str = "silu"  # silu | gelu | relu2
    gated_mlp: bool = True
    qkv_bias: bool = False
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    norm_plus_one: bool = False  # gemma (1 + w) RMSNorm
    embed_scale: bool = False  # gemma sqrt(d_model) embedding scale
    tie_embeddings: bool = True
    use_rope: bool = True
    rope_theta: float = 10000.0

    # attention flavour
    attn_window: int | None = None  # sliding-window size (mixtral / local attn)
    attn_softcap: float | None = None  # grok logit soft-cap

    # MoE
    num_experts: int = 0
    top_k: int = 2

    # hybrid (recurrentgemma / griffin)
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    local_window: int = 2048

    # ssm (rwkv6)
    rwkv_head_dim: int = 64

    # enc-dec (whisper)
    enc_layers: int = 0

    # vlm
    num_image_tokens: int = 0

    # distribution defaults (weavable; see distributed/sharding.py)
    layer_groups: tuple[int, ...] = ()  # () -> one group with all layers

    notes: str = ""

    # -- derived -----------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (windowed / recurrent decode)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (no encoder-only)

    def supported_shapes(self) -> list[str]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.sub_quadratic:
            out.append("long_500k")
        return out

    def param_count(self) -> int:
        """Analytic total parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.num_layers
        hd = self.resolved_head_dim
        H, K = self.n_heads, self.kv_heads
        attn = d * H * hd + 2 * d * K * hd + H * hd * d
        mlp = d * f * (3 if self.gated_mlp else 2)
        if self.family == "moe":
            mlp = self.num_experts * mlp + d * self.num_experts
        per_layer = attn + mlp + 2 * d
        if self.family == "ssm":
            dr = self.rwkv_head_dim
            time_mix = 5 * d * d + d * d + (5 * d + 5 * 32 * d + d * 32 * 5) + (
                d * 64 + 64 * d + d
            )
            chan = d * f + f * d + d * d
            per_layer = time_mix + chan + 4 * d
        if self.family == "hybrid":
            lw = self.lru_width or d
            nb = max(self.n_heads, 1)
            rec = 2 * d * lw + lw * d + 4 * lw + 2 * (nb * (lw // nb) ** 2) + lw
            att = attn
            pat = self.block_pattern or ("rec", "rec", "attn")
            n_rec = sum(1 for i in range(L) if pat[i % len(pat)] == "rec")
            n_att = L - n_rec
            per_layer = 0  # handled below
            body = n_rec * (rec + mlp + 2 * d) + n_att * (att + mlp + 2 * d)
            return body + V * d * (1 if self.tie_embeddings else 2)
        body = L * per_layer
        if self.family == "encdec":
            body += self.enc_layers * (attn + mlp + 2 * d) + L * (attn + d)  # + cross
        embed = V * d * (1 if self.tie_embeddings else 2)
        return body + embed

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.kv_heads * hd + self.n_heads * hd * d
        mlp_active = self.top_k * d * f * 3 + d * self.num_experts
        body = L * (attn + mlp_active + 2 * d)
        return body + self.vocab * d * (1 if self.tie_embeddings else 2)

    def groups(self) -> tuple[int, ...]:
        if self.layer_groups:
            assert sum(self.layer_groups) == self.num_layers
            return self.layer_groups
        return (self.num_layers,)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
