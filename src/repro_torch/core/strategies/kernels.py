"""Kernel-substitution aspects: weave hand-written CUDA implementations (or
block-size choices) onto compute joinpoints — the GPU analogue of the
paper's compiler-flag / code-variant selection (§2.3).

`KernelAspect(pattern, op_kind, "cuda")` is the counterpart of the
reference's `"pallas"` selection; the default implementation is `"eager"`
(plain PyTorch), as `"xla"` is in the reference.

`TunedKernelAspect` closes the DSE->autotuner loop at weave time: it builds
the program's kernel signatures, consults the persistent kernel-tuner cache
(`repro_torch.autotune.kernel_tuner`, rows of the program's device) and
weaves the tuned knobs in as extras — so a woven program runs with
DSE-selected knobs, and exposes them as knobs for mARGOt refinement."""

from __future__ import annotations

import torch

from repro_torch.core.knob import Knob
from repro_torch.core.weaver import Aspect, Weaver


class KernelAspect(Aspect):
    name = "KernelSubstitution"

    def __init__(self, pattern: str, op_kind: str, impl: str, *,
                 expose_knob: bool = False, impls: tuple[str, ...] = ()):
        self.pattern, self.op_kind, self.impl = pattern, op_kind, impl
        self.expose_knob = expose_knob
        self.impls = impls or (impl,)

    def apply(self, weaver: Weaver) -> None:
        matched = weaver.select(self.pattern).all()
        for jp in matched:
            jp.attr("kind")
        weaver.set_impl(self.pattern, self.op_kind, self.impl)
        if self.expose_knob:
            weaver.add_knob(Knob(f"{self.op_kind}_impl", self.impls, self.impl))


class BlockSizeAspect(Aspect):
    name = "KernelBlockSizes"

    def __init__(self, **sizes: int):
        self.sizes = sizes  # e.g. flash_block_q=64, flash_block_kv=64

    def apply(self, weaver: Weaver) -> None:
        for key, val in self.sizes.items():
            weaver.set_extra(key, val)


class TunedKernelAspect(Aspect):
    """Weave DSE-tuned kernel knobs from the tuner cache.

    For every kernel the program contains — flash attention (`attention`
    joinpoints: the training, decode, paged-decode, quantized-pool and
    speculative signatures), RMSNorm (`norm`), the WKV recurrence
    (`rwkv_time_mix`) and the RG-LRU (`rglru`) — it makes the reference's
    selects and attribute reads, builds the problem signature and looks it
    up among the rows of the program's device.  On a hit it sets the
    extras that exist on the card (`flash_dkv_n_split`, the FMA route's
    `flash_block_q[_bwd]` / `flash_block_kv[_bwd]` / `flash_block_kv_dec`,
    `flash_page_size`, `flash_cache_dtype`, `speculative_draft_len`) and
    exposes them as knobs.  RMSNorm, WKV and RG-LRU have no knob on the
    card (`kernel_tuner.FIXED_TILES`): their lookups always miss.  On a
    miss it leaves the defaults untouched, so its weave report equals the
    reference's; tuning is explicit, never a weave side effect, unless
    `tune_on_miss=True`.
    """

    name = "TunedKernelBlocks"

    def __init__(self, batch: int, seq_len: int, *, dtype: str = "bfloat16",
                 cache_len: int | None = None,
                 tuner=None, tune_on_miss: bool = False,
                 expose_knobs: bool = True):
        self.batch, self.seq_len, self.dtype = batch, seq_len, dtype
        self.cache_len = cache_len  # decode-signature cache length
        self.tuner = tuner
        self.tune_on_miss = tune_on_miss
        self.expose_knobs = expose_knobs

    def signature(self, cfg):
        from repro_torch.autotune.kernel_tuner import flash_signature

        return flash_signature(
            (self.batch, self.seq_len, cfg.n_heads, cfg.resolved_head_dim),
            cfg.kv_heads, self.dtype, causal=True, window=cfg.attn_window)

    def _serving(self, make_sig, cfg):
        """A serving signature: one token against `cache_len` slots (ring
        caches clamp to the window — the cache *is* the window)."""
        cache_len = self.cache_len or self.seq_len
        window = cfg.attn_window
        if window is not None and window < cache_len:
            cache_len, window = window, None  # ring layout
        return make_sig(self.batch, cache_len, cfg.n_heads, cfg.kv_heads,
                       cfg.resolved_head_dim, self.dtype, window=window)

    def decode_signature(self, cfg):
        from repro_torch.autotune.kernel_tuner import flash_decode_signature

        return self._serving(flash_decode_signature, cfg)

    def paged_signature(self, cfg):
        from repro_torch.autotune.kernel_tuner import paged_decode_signature

        return self._serving(paged_decode_signature, cfg)

    def quantized_signature(self, cfg):
        from repro_torch.autotune.kernel_tuner import quantized_cache_signature

        return self._serving(quantized_cache_signature, cfg)

    def speculative_signature(self, cfg):
        from repro_torch.autotune.kernel_tuner import speculative_signature

        return self._serving(speculative_signature, cfg)

    def rmsnorm_signature(self, cfg):
        from repro_torch.autotune.kernel_tuner import rmsnorm_signature

        return rmsnorm_signature(self.batch * self.seq_len, cfg.d_model, self.dtype)

    def rwkv_signature(self, cfg):
        from repro_torch.autotune.kernel_tuner import rwkv6_signature

        return rwkv6_signature(self.batch, self.seq_len, cfg.d_model,
                               cfg.rwkv_head_dim, self.dtype)

    def rglru_signature(self, cfg):
        from repro_torch.autotune.kernel_tuner import rglru_signature

        return rglru_signature(self.batch, self.seq_len,
                               cfg.lru_width or cfg.d_model, self.dtype)

    def _knobs_for(self, tuner, sig, device: str):
        from repro_torch.autotune.kernel_tuner import tunable

        knobs = tuner.lookup(sig, device)
        if knobs is None and self.tune_on_miss and tunable(sig):
            knobs = tuner.tune(sig)
        return knobs

    def _weave(self, weaver, sig, knobs, extras: dict[str, str]):
        """Set extras and expose knobs for one signature's tuned values.
        `extras` maps a knob of the tuner's space to the extra the nn layer
        or the server reads; a knob the row lacks is skipped."""
        from repro_torch.autotune.kernel_tuner import space_values

        space = space_values(sig)
        for name, extra_key in extras.items():
            if name not in knobs:
                continue
            val = knobs[name]
            # categorical knobs (cache_dtype) weave as strings, the rest ints
            val = val if isinstance(val, str) else int(val)
            weaver.set_extra(extra_key, val)
            if self.expose_knobs:
                values = tuple(space.get(name, ()))
                if isinstance(val, str):
                    values = values if val in values else values + (val,)
                else:
                    values = tuple(sorted(set(values) | {val}))
                weaver.add_knob(Knob(extra_key, values, val))

    def apply(self, weaver: Weaver) -> None:
        from repro_torch.autotune.kernel_tuner import default_tuner

        tuner = self.tuner or default_tuner()
        cfg = weaver.program.cfg
        device = torch.device(weaver.program.device).type

        attn_jps = weaver.select(kind="attention").all()
        if attn_jps:
            for jp in attn_jps:
                jp.attr("kind")
            for sig, extras in (
                (self.signature(cfg), {
                    "block_q": "flash_block_q", "block_kv": "flash_block_kv",
                    "block_q_bwd": "flash_block_q_bwd",
                    "block_kv_bwd": "flash_block_kv_bwd",
                    "dkv_n_split": "flash_dkv_n_split"}),
                (self.decode_signature(cfg), {"block_kv_dec": "flash_block_kv_dec"}),
                # a paged entry wins over the dense decode entry
                (self.paged_signature(cfg), {
                    "page_size": "flash_page_size",
                    "block_kv_dec": "flash_block_kv_dec"}),
                # the accuracy-constrained dtype x geometry entry wins over the
                # paged one: the pool stores what the DSE picked (fp names
                # mean: keep the fp pool)
                (self.quantized_signature(cfg), {
                    "cache_dtype": "flash_cache_dtype",
                    "page_size": "flash_page_size",
                    "block_kv_dec": "flash_block_kv_dec"}),
                # a tuned draft span turns speculative serving on
                (self.speculative_signature(cfg), {"draft_len": "speculative_draft_len"}),
            ):
                knobs = self._knobs_for(tuner, sig, device)
                if knobs:
                    self._weave(weaver, sig, knobs, extras)

        for kind, gate, make, extras in (
            ("norm", cfg.norm_type == "rmsnorm", self.rmsnorm_signature,
             {"block_rows": "rms_block_rows"}),
            ("rwkv_time_mix", True, self.rwkv_signature, {"chunk": "wkv_chunk"}),
            ("rglru", True, self.rglru_signature,
             {"block_d": "rglru_block_d", "chunk": "rglru_chunk"}),
        ):
            jps = weaver.select(kind=kind).all()
            if jps and gate:
                for jp in jps:
                    jp.attr("kind")
                knobs = self._knobs_for(tuner, make(cfg), device)
                if knobs:
                    self._weave(weaver, make(cfg), knobs, extras)
