"""Dtype policies — the substrate of the ANTAREX precision-tuning aspects.

A `DTypePolicy` is the GPU analogue of the paper's double/float/half/fixed
choice: storage (param) dtype, compute dtype (tensor-core input) and
accumulation dtype.  The `PolicyResolver` holds an ordered list of (glob-pattern, policy)
entries; the *last* matching pattern wins, so aspects append overrides —
exactly the paper's "change the type of the declarations inside this
function" with path patterns standing in for AST selection.

"fixed point" from the paper maps to int8 storage with fp32 scales
(`quantized=True`), dequantized on load.

`cache_<dtype>` policies retype the KV-cache *pool* instead: `ChangePrecision`
weaves them as the "flash_cache_dtype" extra, which `Server.serve_continuous`
resolves to an int8 / fp8 page pool with fp32 per-page scales.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}


def parse_dtype(d: Any):
    if isinstance(d, str):
        return _DTYPES[d]
    return d


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    accum_dtype: Any = torch.float32
    quantized: bool = False  # int8 weights + per-channel fp32 scales
    # KV-cache pool storage format ("int8" / "float8_e4m3fn" / ...): the
    # paper's fixed-point declaration-retyping applied to the *cache* kind —
    # pk/pv stored narrow with per-page fp32 scales, dequantized on load
    cache_dtype: str | None = None

    @staticmethod
    def make(name: str) -> "DTypePolicy":
        """Named policies mirroring the paper's precision levels.

        double -> f32 everywhere;  float -> bf16 compute / f32 params;
        half   -> bf16 params+compute;  fixed -> int8 weights (emulated);
        cache_<dtype> -> quantized KV-cache pool at <dtype>.
        """
        if name in ("double", "f32", "float32"):
            return DTypePolicy(torch.float32, torch.float32, torch.float32)
        if name in ("float", "mixed", "bf16_mixed"):
            return DTypePolicy(torch.float32, torch.bfloat16, torch.float32)
        if name in ("half", "bf16", "bfloat16"):
            return DTypePolicy(torch.bfloat16, torch.bfloat16, torch.float32)
        if name in ("fixed", "int8"):
            return DTypePolicy(torch.bfloat16, torch.bfloat16, torch.float32, quantized=True)
        if name.startswith("cache_"):
            return DTypePolicy(torch.bfloat16, torch.bfloat16, torch.float32,
                               cache_dtype=name[len("cache_"):])
        raise ValueError(f"unknown policy name {name!r}")


class PolicyResolver:
    """Ordered (pattern, policy) table; last match wins."""

    def __init__(self, entries: list[tuple[str, DTypePolicy]] | None = None):
        self.entries: list[tuple[str, DTypePolicy]] = list(entries or [])

    @staticmethod
    def default(base: str = "half") -> "PolicyResolver":
        return PolicyResolver([("*", DTypePolicy.make(base))])

    def override(self, pattern: str, policy: DTypePolicy | str) -> "PolicyResolver":
        if isinstance(policy, str):
            policy = DTypePolicy.make(policy)
        self.entries.append((pattern, policy))
        return self

    def resolve(self, path: str) -> DTypePolicy:
        found = DTypePolicy()
        for pattern, policy in self.entries:
            if fnmatch.fnmatch(path, pattern):
                found = policy
        return found

    def copy(self) -> "PolicyResolver":
        return PolicyResolver(list(self.entries))

    def __repr__(self):
        return f"PolicyResolver({self.entries!r})"
