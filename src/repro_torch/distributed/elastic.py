"""Elastic rescale: restore any checkpoint onto a mesh.

Checkpoints store host numpy (checkpoint/checkpointer.py); resharding is a
placement against the new mesh's shardings, derived from the same logical
rules — so changing the device count (or the DP/TP split) is a restart, not
a migration.  `plan_rescale` validates divisibility before committing
(batch % new DP size, etc.).  On a mesh of one card each leaf is placed
whole; on a live mesh (`launch/mesh.make_mesh`) every rank restores the
whole leaves and keeps its own block of each, bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.distributed.sharding import param_shardings, validate_mesh_rules
from repro_torch.launch.mesh import Mesh
from repro_torch.nn.module import Module


def plan_rescale(global_batch: int, new_mesh: Mesh,
                 rules: Mapping[str, Any]) -> dict:
    """Checks a proposed new mesh; returns derived facts or raises."""
    validate_mesh_rules(new_mesh, rules)
    dp = 1
    batch_axes = rules.get("batch") or ()
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    for a in batch_axes:
        dp *= new_mesh.shape.get(a, 1)
    if global_batch % dp:
        raise ValueError(
            f"global_batch {global_batch} not divisible by new DP degree {dp}"
        )
    return {"dp": dp, "per_replica_batch": global_batch // dp,
            "devices": new_mesh.size}


def reshard_params(model: Module, ckpt: Checkpointer, new_mesh: Mesh,
                   rules: Mapping[str, Any], template: Any,
                   step: int | None = None):
    """Restore -> place on the new mesh. Returns (params, manifest).  The
    checkpoint is a trainer's (`runtime/trainer.py`), which keeps the
    params under "params"; `template` is the param tree."""
    tree, manifest = ckpt.restore({"params": template}, step)
    shardings = param_shardings(model, new_mesh, rules)
    return Checkpointer.place(tree["params"], shardings), manifest
