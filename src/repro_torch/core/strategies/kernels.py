"""Kernel-substitution aspects: weave hand-written CUDA implementations (or
block-size choices) onto compute joinpoints — the GPU analogue of the
paper's compiler-flag / code-variant selection (§2.3).

`KernelAspect(pattern, op_kind, "cuda")` is the counterpart of the
reference's `"pallas"` selection; the default implementation is `"eager"`
(plain PyTorch), as `"xla"` is in the reference.  `TunedKernelAspect` (tuned
block sizes from the kernel-tuner cache) waits for the tuner's slice."""

from __future__ import annotations

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
