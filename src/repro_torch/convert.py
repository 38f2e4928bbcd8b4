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


def _matched(params: Mapping, tree: Mapping) -> list:
    """The reference tree's arrays in the port tree's leaf order, after
    checking that every path of either side is consumed exactly once and
    that every shape agrees."""
    ours = _flatten(params)
    theirs = _flatten(tree)
    missing = sorted(set(ours) - set(theirs))
    unused = sorted(set(theirs) - set(ours))
    if missing or unused:
        raise KeyError(f"param trees differ: missing from the source {missing}, "
                       f"not consumed {unused}")
    out = []
    for path, param in ours.items():
        value = np.asarray(theirs[path])
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {tuple(value.shape)} does not fit "
                             f"{tuple(param.shape)}")
        out.append(value)
    return out


def load_jax_params(model: Module, tree: Mapping) -> dict[str, Any]:
    """Fill the model's (already materialized) parameters from the
    reference's param tree, path by path, in place.  Every path of either
    side must be consumed exactly once and every shape must agree; dtypes
    follow the port's parameters.  Returns the port's param tree."""
    params = param_tree(model)
    for param, value in zip(_flatten(params).values(), _matched(params, tree)):
        with torch.no_grad():
            param.copy_(torch.tensor(value))
    return params


def load_jax_opt_state(model: Module, opt_tree: Mapping, *,
                       state_dtype: str = "float32") -> dict[str, Any]:
    """The reference's AdamW state (`master`, `m`, `v`, `count` and, under
    compression, `ef`) as the port's (`optim/adamw.init_state`'s layout), on
    the model's device: `master` fp32, `m` / `v` in `state_dtype`, `ef` fp32
    (the reference's residuals are fp32 after the first step whatever the
    state dtype), `count` a 0-dim int32 tensor.  Each tree must match the
    model's param tree path for path (as `load_jax_params` checks)."""
    params = param_tree(model)
    device = next(iter(_flatten(params).values())).device
    sdt = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32

    def tree_like(src, dtype):
        values = iter(_matched(params, src))  # in `_flatten`'s order

        def walk(tree):
            if isinstance(tree, Mapping):
                return {k: walk(v) for k, v in tree.items()}
            return torch.tensor(next(values), dtype=dtype, device=device)

        return walk(params)

    state = {
        "master": tree_like(opt_tree["master"], torch.float32),
        "m": tree_like(opt_tree["m"], sdt),
        "v": tree_like(opt_tree["v"], sdt),
        "count": torch.tensor(int(np.asarray(opt_tree["count"])),
                              dtype=torch.int32, device=device),
    }
    if "ef" in opt_tree:
        state["ef"] = tree_like(opt_tree["ef"], torch.float32)
    return state


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
