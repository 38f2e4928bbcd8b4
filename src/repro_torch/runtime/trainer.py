"""Training runtime: the woven application's collect-analyse-decide-act loop.

Composes every ANTAREX runtime service around the train step:
  - libVC holds one step closure per weave variant; the mARGOt autotuner
    (if attached, duck-typed: `update()` -> an operating point with `knobs`,
    `observe(metric, value)`) picks the variant / knobs each step;
  - woven step wrappers (ExaMon sensors, timers, power capping) run on the
    host around each step, and wait for the card before they read a clock;
  - checkpointing is async + atomic, restart picks up the latest manifest,
    SIGTERM (or `preemption.request()`) triggers a final checkpoint, a
    watchdog guards step deadlines, and heartbeats feed straggler detection.

The parameters live on the program's device (`Program.from_arch(...,
device=)`), and so does the optimizer state; the train step updates both in
place (see `runtime/steps.build_train_step`).

On a live mesh (`launch/mesh.make_mesh`) every rank holds its shards of the
parameters and the optimizer state — under an FSDP layout its block of
every leaf split on its `embed` dim, with that block's master, m and v —
and hands the step the global batch, which keeps the rank's rows.  Every decision is rank 0's: its
mARGOt knobs and its preemption request are broadcast before a step is
taken, only it logs, and a checkpoint is the gathered (whole) state that
rank 0 writes and every rank of any mesh restores its blocks from.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, process_index_and_count
from repro_torch.core.weaver import WovenProgram
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.collectives import barrier, broadcast_object
from repro_torch.distributed.fault import PreemptionHandler, Watchdog
from repro_torch.distributed.sharding import (
    NamedSharding,
    gather_shards,
    local_shard,
    param_shardings,
    tree_shards,
)
from repro_torch.launch.mesh import is_live, require_mesh_on
from repro_torch.monitor.examon import ExamonBroker, get_default_broker
from repro_torch.monitor.sensors import apply_wrappers
from repro_torch.nn.module import init_params
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.tree import leaves, rebuild
from repro_torch.runtime.steps import build_train_step, model_flops_per_token
from repro_torch.versioning.libvc import LibVC


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    watchdog_deadline_s: float = 300.0
    keep_checkpoints: int = 3


class Trainer:
    def __init__(
        self,
        woven: WovenProgram,
        pipeline: TokenPipeline,
        cfg: TrainerConfig,
        *,
        mesh=None,
        opt_cfg: AdamWConfig | None = None,
        margot=None,
        broker: ExamonBroker | None = None,
        lr_fn: Callable | None = None,
    ):
        self.woven = woven
        self.pipeline = pipeline
        self.cfg = cfg
        self.mesh = mesh
        self.margot = margot
        self.broker = broker or get_default_broker()
        self.device = woven.program.device
        require_mesh_on(mesh, torch.device(self.device))
        self.opt_cfg = opt_cfg or AdamWConfig(
            compression=bool(woven.state.extra.get("grad_compression", False)),
            state_dtype=str(woven.state.extra.get("opt_state_dtype", "float32")),
        )
        model_cfg = woven.program.cfg
        self.info: dict[str, Any] = {
            "task_name": model_cfg.name,
            "tokens_per_step": pipeline.cfg.global_batch * pipeline.cfg.seq_len,
            "flops_per_step": model_flops_per_token(model_cfg)
            * pipeline.cfg.global_batch * pipeline.cfg.seq_len,
            "knobs": dict(woven.knobs.defaults()) if len(woven.knobs) else {},
        }

        def builder(variant: str):
            step = build_train_step(self.woven, mesh=self.mesh,
                                    variant=None if variant == "__default__" else variant,
                                    opt_cfg=self.opt_cfg, lr_fn=lr_fn)
            return apply_wrappers(step, self.woven.state.step_wrappers, self.info)

        self.libvc = LibVC(builder, error_strategy="fallback")
        self._checkpointer: Checkpointer | None = None
        self.params = None
        self.opt_state = None
        self.step = 0
        self.history: list[dict] = []
        self.restore_count = 0
        self.preemption = PreemptionHandler(install=False)
        self.watchdog_timeouts = 0

    # -- state ------------------------------------------------------------------

    @property
    def _live(self) -> bool:
        return is_live(self.mesh)

    def _shardings(self):
        """(params, opt_state) sharding trees of a live mesh."""
        ps = param_shardings(self.woven.program.model, self.mesh, self.woven.state.rules)
        opt = {"master": ps, "m": ps, "v": ps, "count": NamedSharding(self.mesh)}
        if self.opt_cfg.compression:
            opt["ef"] = ps
        return ps, opt

    def init_state(self) -> None:
        shardings = self._shardings()[0] if self._live else None
        self.params = init_params(self.woven.program.model, self.cfg.seed,
                                  self.woven.state.policies, self.device,
                                  shardings=shardings)
        self.opt_state = adamw.init_state(self.params, self.opt_cfg)
        self.step = 0

    def _ckpt(self) -> Checkpointer | None:
        """One Checkpointer per trainer: its save() joins the previous async
        write, so overlapping saves of the same step can't clobber each
        other's tmp/final dirs."""
        if not self.cfg.ckpt_dir:
            return None
        if self._checkpointer is None:
            self._checkpointer = Checkpointer(self.cfg.ckpt_dir,
                                              keep=self.cfg.keep_checkpoints)
        return self._checkpointer

    def save(self, blocking: bool = False) -> None:
        ckpt = self._ckpt()
        if ckpt is None or self.params is None:
            return
        params, opt = self.params, self.opt_state
        if self._live:  # the whole state, gathered on every rank
            ps, os_ = self._shardings()
            params = tree_shards(params, ps, gather_shards)
            opt = tree_shards(opt, os_, gather_shards)
            if self.mesh.rank != 0:
                return
        tree = {"params": params, "opt": opt,
                "data": {"step": np.asarray(self.pipeline.step)}}
        ckpt.save(self.step, tree, meta={"arch": self.woven.program.cfg.name},
                  blocking=blocking, whole=self._live)

    def maybe_restore(self) -> bool:
        ckpt = self._ckpt()
        if ckpt is None or ckpt.latest_step() is None:
            return False
        if self.params is None:
            self.init_state()
        template = {"params": self.params, "opt": self.opt_state,
                    "data": {"step": np.asarray(0)}}
        tree, manifest = ckpt.restore(template)
        if self._live:  # whole leaves on disk: keep this rank's blocks
            ps, os_ = self._shardings()
            tree["params"] = tree_shards(tree["params"], ps, local_shard)
            tree["opt"] = tree_shards(tree["opt"], os_, local_shard)
        # the parameters are the model's registered tensors: written in place
        with torch.no_grad():
            for live, saved in zip(leaves(self.params), leaves(tree["params"])):
                live.copy_(saved)
        self.opt_state = rebuild(
            self.opt_state, [t.to(self.device) for t in leaves(tree["opt"])])
        self.step = int(manifest["step"])
        self.pipeline.load_state_dict(
            {"step": int(tree["data"]["step"]), "seed": self.pipeline.cfg.seed}
        )
        self.restore_count += 1
        return True

    # -- loop -------------------------------------------------------------------

    def run(self, steps: int | None = None) -> list[dict]:
        steps = steps if steps is not None else self.cfg.steps
        if self.params is None and not self.maybe_restore():
            self.init_state()
        watchdog = Watchdog(self.cfg.watchdog_deadline_s, self._on_timeout)
        try:
            return self._run_loop(watchdog, steps)
        finally:
            watchdog.close()

    def _batch(self) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in next(self.pipeline).items()}

    def _run_loop(self, watchdog: Watchdog, steps: int) -> list[dict]:
        target = self.step + steps
        while self.step < target:
            # rank 0's host decisions, on every rank of a live mesh
            if broadcast_object(self.preemption.pending, self.mesh):
                self.save(blocking=True)
                break
            variant = None
            if self.margot is not None:
                knobs = None
                if not self._live or self.mesh.rank == 0:
                    knobs = dict(self.margot.update().knobs)
                knobs = broadcast_object(knobs, self.mesh)
                self.info["knobs"].update(knobs)
                variant = knobs.get("variant") or knobs.get("precision_mix")
            watchdog.beat()
            batch = self._batch()
            self.params, self.opt_state, metrics = self.libvc(
                variant, self.params, self.opt_state, batch, self.step,
            )
            watchdog.cancel()
            self.step += 1
            host = {k: float(v) for k, v in metrics.items()
                    if torch.as_tensor(v).ndim == 0}
            host["step"] = self.step
            host["step_time"] = self.info.get("last_step_time", 0.0)
            self.history.append(host)
            self.broker.publish(
                f"fleet/heartbeat/@host{process_index_and_count()[0]}",
                host["step_time"] or 1e-4,
            )
            if self.margot is not None and host.get("step_time"):
                self.margot.observe("step_time", host["step_time"])
            if self.cfg.ckpt_every and self.step % self.cfg.ckpt_every == 0:
                self.save()
            if self.cfg.log_every and self.step % self.cfg.log_every == 0 \
                    and (not self._live or self.mesh.rank == 0):
                print(f"step {self.step}: loss={host.get('loss', float('nan')):.4f} "
                      f"t={host['step_time']*1e3:.1f}ms")
        ckpt = self._ckpt()
        if ckpt is not None:
            ckpt.wait()
            barrier(self.mesh)  # rank 0's checkpoint is on disk for every rank
        return self.history

    def _on_timeout(self) -> None:
        self.watchdog_timeouts += 1
