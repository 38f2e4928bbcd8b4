"""Parameter trees as nested dicts, flattened as `jax.tree` flattens them:
leaves in sorted-key order, so two trees of one structure line up whatever
order their dicts were built in."""

from __future__ import annotations

from typing import Any, Callable, Mapping


def leaves(tree) -> list:
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def rebuild(template, values: list) -> Any:
    """A tree shaped like `template` holding `values` in leaf order."""
    it = iter(values)

    def walk(t):
        if isinstance(t, Mapping):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)

    return walk(template)


def tree_map(fn: Callable, tree) -> Any:
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
