"""Layer stack: one stacked parameter per leaf, a Python loop over layers.

`ScannedStack` stacks a homogeneous block's parameters with a leading
"layers" axis — one `(L, ...)` parameter per leaf, registered on the
template block's own modules so `state_dict()` keys read
`<stack>.<block>.<...>` — and applies layer i to slice i of every leaf
(views, no copies).  The reference scans the same stacked tree with
`lax.scan`; here the loop is plain Python and there is no remat.  Decode
caches ride along as per-layer slices of tensors with a leading `L` dim.

Joinpoint view: the stack exposes its *template* block (one joinpoint stands
for all layers in the group).  Models that need per-layer-group weaving
split the trunk into several ScannedStack groups (see configs.layer_groups).
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import torch

from repro_torch.nn.module import Ctx, Module, ParamSpec, _walk_spec


def _stack_specs(tree: Any, n: int) -> Any:
    """Add a leading (n, ...) 'layers' dim to every ParamSpec leaf."""

    def leaf(spec: ParamSpec, path: str, owner, name) -> ParamSpec:
        return ParamSpec(
            shape=(n, *spec.shape),
            axes=("layers", *spec.axes),
            init=spec.init,
            scale=spec.scale,
            dtype=spec.dtype,
        )

    return _walk_spec(tree, "", leaf)


def _layer(tree: Any, i: int) -> Any:
    """Slice layer i out of every leaf of a stacked tree (views)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack_layers(trees: list) -> Any:
    """Inverse of `_layer`: stack per-layer trees on a new leading dim."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, Mapping):
        return {k: _stack_layers([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


class ScannedStack(Module):
    kind = "stack"

    def __init__(self, name: str, block: Module, n_layers: int):
        super().__init__()
        self.name = name
        self.n_layers = n_layers
        self._block_name = block.name
        # registered under the block's own name: that name is the key of the
        # stacked subtree in the param tree and the prefix in state_dict()
        self.add_module(block.name, block)

    @property
    def template(self) -> Module:
        """The template block (the reference's `stack.block`)."""
        return self._modules[self._block_name]

    def spec(self):
        return {self._block_name: _stack_specs(self.template, self.n_layers)}

    def walk(self, prefix: str = "") -> Iterator[tuple[str, Module]]:
        path = f"{prefix}/{self.name}" if prefix else self.name
        yield path, self
        yield from self.template.walk(path)

    def forward(
        self,
        params,
        x,
        *,
        ctx: Ctx,
        mode: str = "dense",
        cache: Any = None,  # per-layer tree with leading n_layers dim
        positions=None,
        block_kwargs: dict | None = None,
    ):
        with ctx.scope(self.name):
            stacked = params[self._block_name]
            block_kwargs = dict(block_kwargs or {})
            block = self.template

            # one tap name stands for every layer, so a tap inside the loop
            # would keep only the last layer's value — disabled within, as in
            # the reference
            saved_taps = ctx.taps_enabled
            ctx.taps_enabled = []
            new_caches = []
            try:
                for i in range(self.n_layers):
                    out, layer_cache = block(
                        _layer(stacked, i), x, ctx=ctx, mode=mode,
                        cache=_layer(cache, i), positions=positions,
                        **block_kwargs,
                    )
                    # per-layer precision mixes may upcast the block output;
                    # the residual dtype is pinned by the embedding policy
                    x = out.to(x.dtype)
                    new_caches.append(layer_cache)
            finally:
                ctx.taps_enabled = saved_taps
            if mode in ("decode", "prefill") and cache is not None:
                # a decode step (or a paged prefill) wrote every layer's
                # k / v / pools through views of the stacked cache tensors:
                # those tensors *are* the new cache; only the replaced
                # leaves (index) are restacked
                new_cache = _merge_decode_cache(cache, new_caches)
            else:
                new_cache = _stack_layers(new_caches)
            return x, new_cache


def _merge_decode_cache(cache: Mapping, layers: list) -> dict:
    """The stacked decode cache after an in-place step: a leaf every layer
    returned as a view of the stacked tensor is kept as that tensor (no
    restacking copy of the whole cache per token); a replaced leaf is
    stacked anew."""
    out = {}
    for key, old in cache.items():
        vals = [layer[key] for layer in layers]
        if isinstance(old, Mapping):
            out[key] = _merge_decode_cache(old, vals)
        elif all(v.data_ptr() == old[i].data_ptr() and v.shape == old[i].shape
                 for i, v in enumerate(vals)):
            out[key] = old
        else:
            out[key] = torch.stack(vals)
    return out
