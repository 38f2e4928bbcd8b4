"""Parallelization aspects (paper §4.1, Fig. 12 — the OpenMP/MPI analogue).

Across cards the parallelization degrees of freedom are mesh-axis mappings
(DP/FSDP/TP/SP), remat policy, gradient-accumulation factor, and collective
compression.  `AutoShard` plays the role of the paper's auto-parallelization
library: static analysis of the model (head counts, expert counts, param
sizes vs device memory) chooses a layout; `validate_rules` is the "disable nested
pragmas" pass (an axis must not shard two conflicting dimensions).
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.core.knob import Knob
from repro_torch.core.weaver import Aspect, Weaver


class ShardingAspect(Aspect):
    name = "Sharding"

    def __init__(self, rules: Mapping[str, Any]):
        self.rules = dict(rules)

    def apply(self, weaver: Weaver) -> None:
        for axis, mapping in self.rules.items():
            weaver.set_rule(axis, mapping)


class RematAspect(Aspect):
    name = "Remat"

    def __init__(self, policy: str = "full", *, expose_knob: bool = False):
        self.policy = policy
        self.expose_knob = expose_knob

    def apply(self, weaver: Weaver) -> None:
        weaver.set_extra("remat", self.policy)
        if self.expose_knob:
            weaver.add_knob(Knob("remat", ("full", "dots", "none"), self.policy))


class AccumAspect(Aspect):
    name = "GradAccumulation"

    def __init__(self, steps: int = 1, *, expose_knob: bool = False,
                 choices: tuple[int, ...] = (1, 2, 4, 8)):
        self.steps = steps
        self.expose_knob = expose_knob
        self.choices = choices

    def apply(self, weaver: Weaver) -> None:
        weaver.set_extra("accum_steps", self.steps)
        if self.expose_knob:
            vals = self.choices if self.steps in self.choices else (self.steps, *self.choices)
            weaver.add_knob(Knob("accum_steps", vals, self.steps))


class CompressionAspect(Aspect):
    """int8 error-feedback compression on the DCN-crossing gradient psum."""

    name = "GradCompression"

    def __init__(self, enabled: bool = True, axes: tuple[str, ...] = ("pod",)):
        self.enabled = enabled
        self.axes = axes

    def apply(self, weaver: Weaver) -> None:
        weaver.set_extra("grad_compression", self.enabled)
        weaver.set_extra("grad_compression_axes", self.axes)


class AutoShard(Aspect):
    """Static analysis -> layout (the auto-parallelization library).

    Chooses one of three production layouts from the model's structure:

      megatron_tp : heads % tp == 0 — TP on vocab/heads/mlp (KV heads are
                    expanded to q-heads inside attention so scores shard),
                    DP batch on (pod, data), FSDP on embed when params+opt
                    exceed memory.                   [yi, qwen2, nemotron,
                    mixtral, grok — experts replicated, TP inside experts]
      fsdp_sp     : dense but heads do not divide tp — activations are
                    sequence-sharded over model (DP x SP), vocab TP for the
                    embedding/logits, params FSDP over data.
                    [gemma, whisper, internvl]
      dp_fsdp     : recurrent families (ssm/hybrid) — batch over every mesh
                    axis (pure DP; recurrences have no token parallelism to
                    exploit), params FSDP over (data, model).
                    [rwkv6, recurrentgemma]
    """

    name = "AutoShard"

    def __init__(self, mesh_axes: Mapping[str, int], *, hbm_bytes: int = 80 << 30,
                 train: bool = True, layout: str | None = None):
        self.mesh_axes = dict(mesh_axes)  # e.g. {"pod": 2, "data": 16, "model": 16}
        self.hbm_bytes = hbm_bytes
        self.train = train
        self.layout = layout  # force a layout (hillclimb override)

    def apply(self, weaver: Weaver) -> None:
        tp = self.mesh_axes.get("model", 1)
        data_axes = tuple(a for a in ("pod", "data") if a in self.mesh_axes)
        cfg = weaver.program.cfg

        attn_jps = weaver.select(kind="attention").all()
        heads = min((jp.attr("n_heads", 10**9) for jp in attn_jps), default=0)
        kv_heads = min((jp.attr("kv_heads", 10**9) for jp in attn_jps), default=0)

        layout = self.layout
        if layout is None:
            if cfg.family in ("ssm", "hybrid"):
                layout = "dp_fsdp"
            elif heads and heads % tp == 0:
                layout = "megatron_tp"
            else:
                layout = "fsdp_sp"

        n_params = _estimate_params(weaver)
        bytes_per_param = 14 if self.train else 2  # bf16 + adamw fp32 states

        rules: dict[str, Any] = {"layers": None, "experts": None}
        if layout == "megatron_tp":
            rules.update(
                batch=data_axes,
                vocab="model", mlp="model",
                heads="model",
                # params' fused K*head_dim dim shards even when the head
                # count does not divide tp (activation constraints are
                # shape-guarded, so this only affects storage layout)
                kv_heads="model",
                kv_seq=None,
                seq_act=None,
                # res_seq="model" enables Korthikanti sequence-parallel
                # residuals (a §Perf hillclimb variant via rules override);
                # the baseline keeps the textbook replicated-residual
                # megatron schedule (2 fwd + 3 bwd all-reduces per layer).
                res_seq=None,
                expand_kv=kv_heads and kv_heads % tp != 0,
            )
            replicated = n_params * bytes_per_param / max(tp, 1)
            # FSDP spans every data-parallel axis (pod included)
            rules["embed"] = data_axes if replicated > 0.5 * self.hbm_bytes else None
        elif layout == "fsdp_sp":
            rules.update(
                batch=data_axes,
                vocab="model", mlp=None, heads=None, kv_heads=None,
                kv_seq="model", seq_act="model", res_seq="model",
                # block params are NOT tensor-parallel in this layout: FSDP
                # over (data, model) when the replicated footprint is large
                embed=("data", "model") if n_params * bytes_per_param
                > 0.3 * self.hbm_bytes else None,
                expand_kv=False,
            )
        else:  # dp_fsdp
            # axis order matters: shape-guarded fallback drops TRAILING axes,
            # so put "pod" last — a 256-batch on the 2x16x16 mesh then lands
            # on (data, model) = 256-way DP with pod-replicated grads.
            dp_batch = tuple(a for a in ("data", "model", "pod")
                             if a in self.mesh_axes)
            rules.update(
                batch=dp_batch,
                vocab=None, mlp=None, heads=None, kv_heads=None,
                kv_seq=None, seq_act=None, res_seq=None,
                embed=("data", "model") if n_params * bytes_per_param
                > 0.5 * self.hbm_bytes else None,
                expand_kv=False,
            )
        weaver.set_extra("layout", layout)
        for axis, mapping in rules.items():
            if axis == "expand_kv":
                weaver.set_extra("expand_kv", bool(mapping))
                continue
            weaver.set_rule(axis, mapping)
        validate_rules(rules)


def _estimate_params(weaver: Weaver) -> int:
    from repro_torch.nn.module import param_count

    return param_count(weaver.program.model)


def validate_rules(rules: Mapping[str, Any]) -> None:
    """The 'no nested pragmas' check: within one tensor the same mesh axis
    must not appear on two logical axes that co-occur.  Conservative check:
    embed/mlp/heads must not collide with batch axes."""
    batch_axes = set()
    v = rules.get("batch")
    for a in (v if isinstance(v, (tuple, list)) else [v]):
        if a:
            batch_axes.add(a)
    for key in ("vocab", "mlp", "heads", "kv_heads"):
        axis = rules.get(key)
        axes = axis if isinstance(axis, (tuple, list)) else [axis]
        for a in axes:
            if a in batch_axes:
                raise ValueError(
                    f"nested parallelism: mesh axis {a!r} used for both batch "
                    f"and {key} (the paper's nested-pragma hazard)"
                )
