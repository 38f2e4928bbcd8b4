"""Carry weights and cache state across from the reference implementation.

The reference's param tree and caches arrive as nested dicts of **numpy**
arrays (whoever calls this does the framework-to-numpy half; bf16 leaves are
widened to fp32 first, which is exact).  Nothing here imports the reference.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.nn.module import Module, param_tree


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    flat: dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


def load_jax_params(model: Module, tree: Mapping) -> dict[str, Any]:
    """Fill the model's (already materialized) parameters from the
    reference's param tree, path by path, in place.  Every path of either
    side must be consumed exactly once and every shape must agree; dtypes
    follow the port's parameters.  Returns the port's param tree."""
    params = param_tree(model)
    ours = _flatten(params)
    theirs = _flatten(tree)
    missing = sorted(set(ours) - set(theirs))
    unused = sorted(set(theirs) - set(ours))
    if missing or unused:
        raise KeyError(f"param trees differ: missing from the source {missing}, "
                       f"not consumed {unused}")
    for path, param in ours.items():
        value = np.asarray(theirs[path])
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {tuple(value.shape)} does not fit "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.tensor(value))
    return params


# recurrent decode state the model keeps in fp32 whatever the compute dtype
# (RG-LRU `lru`, RWKV `x_prev` and `wkv`); the conv window `conv` follows it
FP32_STATE = ("lru", "x_prev", "wkv")


def cache_from_numpy(cache: Any, device="cpu", dtype=None) -> Any:
    """A reference cache (nested dicts of numpy arrays: attention `k`, `v`,
    `index`, `pos`, `kv_pos`; recurrent `conv`, `lru`, `x_prev`, `wkv`) as
    the port's cache on `device`.  Float leaves take `dtype` (None: keep the
    array's own), except the fp32 recurrent states; integer leaves become
    int32."""

    def convert(value, key):
        if value is None:
            return None
        if isinstance(value, Mapping):
            return {k: convert(v, k) for k, v in value.items()}
        t = torch.tensor(np.asarray(value), device=device)
        if not t.is_floating_point():
            return t.to(torch.int32)
        if key in FP32_STATE:
            return t.to(torch.float32)
        return t.to(dtype) if dtype is not None else t

    return convert(cache, "")


def cache_to_numpy(cache: Any) -> Any:
    """The port's cache as nested dicts of numpy arrays (floats as fp32)."""
    if cache is None:
        return None
    if isinstance(cache, Mapping):
        return {k: cache_to_numpy(v) for k, v in cache.items()}
    t = cache.detach().cpu()
    return (t.to(torch.float32) if t.is_floating_point() else t).numpy()
