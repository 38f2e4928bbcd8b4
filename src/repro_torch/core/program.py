"""Program: the functional application the ANTAREX aspects are woven onto.

The *domain expert* writes/choses the model (configs + models packages) and
is done.  Extra-functional concerns — precision, sharding, remat, kernels,
monitoring, autotuning, power — arrive exclusively through aspects, which
never touch the model code (DESIGN.md §2: separation of concerns).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.dtypes import PolicyResolver
from repro_torch.nn.module import Ctx, Module, resolve_device


@dataclasses.dataclass
class WeaveState:
    """Everything a weave decides; consumed by runtime/steps.py via Ctx."""

    # bf16 storage + bf16 tensor-core compute + fp32 accumulation; the fp32
    # master copy lives in the optimizer state (optim/adamw.py).
    policies: PolicyResolver = dataclasses.field(
        default_factory=lambda: PolicyResolver.default("half")
    )
    impls: list[tuple[str, str, str]] = dataclasses.field(default_factory=list)
    rules: dict[str, Any] = dataclasses.field(default_factory=dict)
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)
    taps: list[str] = dataclasses.field(default_factory=list)
    step_wrappers: list[Any] = dataclasses.field(default_factory=list)
    priority: int = 0  # PowerCapper task priority

    def copy(self) -> "WeaveState":
        return WeaveState(
            policies=self.policies.copy(),
            impls=list(self.impls),
            rules=dict(self.rules),
            extra=dict(self.extra),
            taps=list(self.taps),
            step_wrappers=list(self.step_wrappers),
            priority=self.priority,
        )

    def make_ctx(self, mesh=None, **kw) -> Ctx:
        return Ctx(
            policies=self.policies,
            impls=self.impls,
            mesh=mesh,
            rules=self.rules,
            taps_enabled=self.taps,
            extra=self.extra,
            **kw,
        )


@dataclasses.dataclass
class Program:
    model: Module
    cfg: ModelConfig
    kind: str = "train"  # train | serve
    # where its parameters and activations live: the card unless the caller
    # asks for the host ("cpu") or for shapes alone ("meta"); asking for the
    # card where there is none raises
    device: "str | torch.device" = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @staticmethod
    def from_arch(arch: str, *, kind: str = "train", reduced: bool = False,
                  device: "str | torch.device" = "cuda") -> "Program":
        """Build the functional program for `arch` on `device`."""
        from repro_torch.models.registry import build_model, get_config, reduced_config

        cfg = reduced_config(arch) if reduced else get_config(arch)
        return Program(model=build_model(cfg), cfg=cfg, kind=kind, device=device)
