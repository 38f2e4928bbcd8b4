"""Minimal composable module system for the ANTAREX PyTorch port.

The *functional* model definition is a tree of `Module` objects with explicit
parameter specs carrying *logical axis names*.  All extra-functional
concerns — dtype policies, kernel implementation selection, sharding rules,
monitoring taps — live in a `Ctx` object that the ANTAREX weaver builds from
aspects.  The model code consults the Ctx; it is never edited.

A `Module` is a `torch.nn.Module`: `init_params` registers one
`nn.Parameter` per `ParamSpec` leaf under the spec's own name, so
`state_dict()` keys are the reference's param-tree paths joined by ".".
Application stays functional — `module(params, x, ctx=ctx)` with `params` the
nested dict `param_tree` returns (views of the registered parameters) —
because a `ScannedStack` keeps one stacked `(L, ...)` parameter per leaf and
hands its template block one layer's slice at a time.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import zlib
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import check_mesh
from repro_torch.nn.dtypes import DTypePolicy, PolicyResolver

# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

Initializer = str  # "normal" | "zeros" | "ones" | "scaled" | "embedding"


def resolve_device(device: "str | torch.device") -> torch.device:
    """The device an entry point runs on.  Asking for the card where there
    is none is an error: nothing carries on on the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' explicitly to run on the host")
    return device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor.

    ``axes`` holds one *logical* axis name (or None) per dimension: the
    sharding rules map it to mesh axes (`distributed/sharding.py`).
    ``dtype`` of None means "the woven dtype policy decides" (the common
    case); norms pin fp32.
    """

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: Initializer = "normal"
    scale: float | None = None  # stddev for "normal", fan-in override for "scaled"
    dtype: Any | None = None  # None -> policy param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"ParamSpec shape {self.shape} and axes {self.axes} rank mismatch"
            )

    def instantiate(self, generator: torch.Generator, policy: DTypePolicy,
                    device: torch.device) -> torch.Tensor:
        """Same distributions as the reference; the draws themselves differ
        (another generator) — equal weights come from `convert.py`."""
        dtype = self.dtype if self.dtype is not None else policy.param_dtype
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init == "normal":
            std = self.scale if self.scale is not None else 0.02
        elif self.init == "scaled":  # 1/sqrt(fan_in)
            fan_in = self.scale if self.scale is not None else self.shape[0]
            std = 1.0 / np.sqrt(max(fan_in, 1))
        elif self.init == "embedding":
            std = self.scale if self.scale is not None else 1.0
        else:
            raise ValueError(f"unknown initializer {self.init!r}")
        # drawn directly in the storage dtype: an fp32 staging copy of the
        # largest leaf (a stacked MLP weight) would double its footprint
        out = torch.empty(self.shape, dtype=dtype, device=device)
        return out.normal_(0.0, float(std), generator=generator)


# ---------------------------------------------------------------------------
# Weave-time context
# ---------------------------------------------------------------------------


class Ctx:
    """Carries every woven extra-functional decision through `apply`.

    The weaver (repro_torch/core) builds one of these; model code only
    *reads* it.  `mesh` is None, a mesh of one device
    (`launch/mesh.make_card_mesh`) or a live mesh of several ranks
    (`launch/mesh.make_mesh`), on which the model computes each rank's shard
    (the parameters' local blocks, `distributed/sharding.local_shard`; an
    FSDP block gathered where it is used, `sharding.gather_plan`) and the
    blocks call the collectives.  `constrain` is the identity either
    way: a tensor already is the block its rank holds.  An abstract mesh of
    more than one device has no ranks and raises.
    """

    def __init__(
        self,
        *,
        policies: PolicyResolver | None = None,
        impls: Sequence[tuple[str, str, str]] = (),  # (pattern, op_kind, impl)
        mesh: Any | None = None,
        rules: Mapping[str, Any] | None = None,  # logical axis -> mesh axes
        taps_enabled: Sequence[str] = (),  # glob patterns of tap names to record
        deterministic: bool = True,
        extra: Mapping[str, Any] | None = None,
    ):
        self.policies = policies or PolicyResolver.default()
        self.impls = list(impls)
        self.mesh = check_mesh(mesh)
        self.rules = dict(rules or {})
        self.taps_enabled = list(taps_enabled)
        self.deterministic = deterministic
        self.extra = dict(extra or {})
        self.taps: dict[str, torch.Tensor] = {}
        self._path: list[str] = []

    # -- path scoping --------------------------------------------------------

    def scope(self, name: str) -> "_Scope":
        return _Scope(self, name)

    @property
    def path(self) -> str:
        return "/".join(self._path)

    # -- policy / impl resolution --------------------------------------------

    def policy(self) -> DTypePolicy:
        return self.policies.resolve(self.path)

    def impl(self, op_kind: str, default: str) -> str:
        """Resolve the woven implementation for an op kind at current path."""
        chosen = default
        for pattern, kind, impl in self.impls:
            if kind == op_kind and fnmatch.fnmatch(self.path, pattern):
                chosen = impl
        return chosen

    # -- monitoring taps -------------------------------------------------------

    def tap(self, name: str, value) -> None:
        """`value` may be a zero-argument callable so an untapped call site
        costs no reduction kernel."""
        if not self.taps_enabled:
            return
        full = f"{self.path}/{name}" if self.path else name
        for pattern in self.taps_enabled:
            if fnmatch.fnmatch(full, pattern):
                if callable(value):
                    value = value()
                self.taps[full] = torch.as_tensor(value).to(torch.float32)
                return

    # -- sharding constraints --------------------------------------------------

    def constrain(self, x: torch.Tensor, logical_axes: tuple[str | None, ...]) -> torch.Tensor:
        return x  # every tensor already is the block its rank holds


class _Scope:
    def __init__(self, ctx: Ctx, name: str):
        self.ctx, self.name = ctx, name

    def __enter__(self):
        self.ctx._path.append(self.name)
        return self.ctx

    def __exit__(self, *exc):
        self.ctx._path.pop()
        return False


# ---------------------------------------------------------------------------
# Module base
# ---------------------------------------------------------------------------


class Module(torch.nn.Module):
    """A named tree node with parameter specs and a functional apply.

    Subclasses define ``kind`` (the joinpoint kind the ANTAREX selectors match
    on), implement ``spec()`` returning ``{name: ParamSpec | Module}``, and a
    ``forward(params, ..., ctx=ctx)``.  A child Module is stored under the
    attribute its spec names it by, which is also its `state_dict` prefix.
    """

    kind: str = "module"
    name: str = "module"

    def spec(self) -> dict[str, "ParamSpec | Module"]:
        raise NotImplementedError

    # Attributes exposed to ANTAREX selectors (LARA joinpoint attributes).
    def attrs(self) -> dict[str, Any]:
        out = {}
        for k, v in vars(self).items():
            # `training` is torch.nn.Module's own flag, not a model attribute
            if k == "training" or k.startswith("_"):
                continue
            if isinstance(v, (int, float, str, bool, tuple)):
                out[k] = v
        return out

    # -- tree walking ----------------------------------------------------------

    def walk(self, prefix: str = "") -> Iterator[tuple[str, "Module"]]:
        """Yield (path, module) for this module and all descendants."""
        path = f"{prefix}/{self.name}" if prefix else self.name
        yield path, self
        for child in self.spec().values():
            if isinstance(child, Module):
                yield from child.walk(path)


# ---------------------------------------------------------------------------
# Param tree utilities
# ---------------------------------------------------------------------------


def _walk_spec(value, path: str, leaf_fn, owner=None, name: str = "") -> Any:
    """Generic recursion over spec trees (Module | dict | ParamSpec leaves).

    `leaf_fn(spec, path, owner, name)` receives the leaf's full path (the
    scopes a forward pass enters, plus the leaf's name) and the torch module
    that owns it; inside a plain dict (a stack's stacked specs) the owner is
    found by following the dict's keys down the template's attributes."""

    def child_path(base: str, child, child_name: str) -> str:
        # a child Module appends its own name when it is visited
        return base if isinstance(child, Module) else f"{base}/{child_name}"

    if isinstance(value, Module):
        sub_path = f"{path}/{value.name}" if path else value.name
        return {
            n: _walk_spec(child, child_path(sub_path, child, n), leaf_fn, value, n)
            for n, child in value.spec().items()
        }
    if isinstance(value, Mapping):
        sub_owner = getattr(owner, name)
        return {
            n: _walk_spec(child, child_path(path, child, n), leaf_fn, sub_owner, n)
            for n, child in value.items()
        }
    return leaf_fn(value, path, owner, name)


def flatten_specs(module: Module) -> dict[str, ParamSpec]:
    """Flat {path: ParamSpec} (paths relative to, and including, module.name)."""
    flat: dict[str, ParamSpec] = {}

    def leaf(spec: ParamSpec, path: str, owner, name):
        flat[path] = spec
        return spec

    _walk_spec(module, "", leaf)
    return flat


def init_params(
    module: Module, seed: int = 0, policies: PolicyResolver | None = None,
    device: "str | torch.device" = "cuda", shardings: Any | None = None,
    local: bool = False,
) -> dict[str, Any]:
    """Materialize every parameter on `device`, register it on the module
    that owns it, and return the param tree (nested dicts keyed by module
    names).  Draws come from one `torch.Generator` on that device.  Given
    a sharding tree of a live mesh (`distributed/sharding.param_shardings`),
    each leaf is drawn whole, as without a mesh, and only this rank's block
    is kept: the blocks are slices of the one-device parameters.  With
    `local` each rank draws its block alone, at the whole leaf's
    distribution, from a generator seeded by `seed`, the leaf and the
    block (ranks holding one block draw the same values): no rank holds a
    whole leaf — a model one device cannot hold — and the blocks are not
    slices of the one-device parameters."""
    device = resolve_device(device)
    policies = policies or PolicyResolver.default()
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    if shardings is not None:
        from repro_torch.distributed.sharding import block_coords, local_shard

        flat_shardings = iter(_flat_leaves(shardings))
    elif local:
        raise ValueError("local draws are a live mesh's: pass its shardings")

    def leaf(spec: ParamSpec, path: str, owner: torch.nn.Module, name: str):
        if local:
            sh = next(flat_shardings)
            block = block_coords(sh)
            generator.manual_seed(int(seed) * 1_000_003
                                  + zlib.crc32(f"{path}|{block}".encode()))
            fan_in = spec.shape[0] if spec.init == "scaled" and spec.scale is None \
                else spec.scale
            value = dataclasses.replace(spec, shape=sh.shard_shape(spec.shape),
                                        scale=fan_in).instantiate(
                generator, policies.resolve(path), device)
        else:
            value = spec.instantiate(generator, policies.resolve(path), device)
        if shardings is not None and not local:
            value = local_shard(value, next(flat_shardings))
        owner.register_parameter(
            name, torch.nn.Parameter(value, requires_grad=False))
        return owner._parameters[name]

    return _walk_spec(module, "", leaf)


def _flat_leaves(tree) -> list:
    """A nested dict's leaves in the order `_walk_spec` visits them."""
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _flat_leaves(v)]
    return [tree]


def param_tree(module: Module) -> dict[str, Any]:
    """The registered parameters as the nested dict `module(params, ...)`
    takes — the same structure as the reference's param pytree."""

    def leaf(spec: ParamSpec, path: str, owner: torch.nn.Module, name: str):
        if name not in owner._parameters:
            raise RuntimeError(f"parameter {path!r} is not materialized: "
                               "call init_params first")
        return owner._parameters[name]

    return _walk_spec(module, "", leaf)


def abstract_params(module: Module, policies: PolicyResolver | None = None,
                    device: "str | torch.device" = "meta") -> dict[str, Any]:
    """The param tree as empty tensors, meta by default (no allocation):
    the dry run's and the roofline's stand-in for `init_params`."""
    policies = policies or PolicyResolver.default()

    def leaf(spec: ParamSpec, path: str, owner, name):
        dtype = spec.dtype if spec.dtype is not None else policies.resolve(path).param_dtype
        return torch.empty(spec.shape, dtype=dtype, device=device)

    return _walk_spec(module, "", leaf)


def param_axes(module: Module) -> dict[str, Any]:
    """Tree of logical-axes tuples matching the param tree's structure."""
    return _walk_spec(module, "", lambda spec, path, owner, name: spec.axes)


def param_count(module: Module) -> int:
    return int(sum(np.prod(s.shape) for s in flatten_specs(module).values()))


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)
