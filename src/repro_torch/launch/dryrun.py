"""Dry run: every (architecture x input shape) cell on a mesh, on the meta
device — nothing is allocated and no card is needed, as the reference's dry
run never runs on its pod.

For each cell and mesh it builds the default weave, places the parameters,
the AdamW state, the step's inputs and its caches by the woven rules
(`distributed/sharding.py`), and records the per-device state bytes
(`memory_per_device["argument"]`), the reference's analytic memory formula
with the card's 80 GB in place of a TPU's 16 GiB (`analytic_hbm_per_device`,
`hbm_fits`, `hbm_capacity`), and on the card mesh the composed roofline
(`roofline/components.compose_cell`).

  card     : {"data": 1, "model": 1}, one H100 — the mesh the port runs on
  pod      : (16, 16) ("data", "model"), abstract
  multipod : (2, 16, 16) ("pod", "data", "model"), abstract

On the abstract meshes the record carries the placements and the per-device
arithmetic, and `"roofline": null` with the reason: costing a partitioned
program needs an SPMD partitioner, which PyTorch on one card lacks.  The
reference's `lower_s`, `compile_s` and the `temp` / `alias` / `code` memory
entries come from XLA's compiler and have no counterpart here.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
  python -m repro_torch.launch.dryrun --all                 # every cell, the card
  python -m repro_torch.launch.dryrun --all --mesh both     # pod and multipod
  ... --set accum_steps=8 --set opt_state_dtype=bfloat16   (weave overrides)

Each record is written to artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback
from typing import Any

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.core.program import Program
from repro_torch.distributed.sharding import input_shardings, param_shardings
from repro_torch.launch.mesh import (Mesh, make_production_mesh, make_test_mesh,
                                     mesh_name)
from repro_torch.launch.weave import default_weave
from repro_torch.models.registry import ARCHS, cells, get_config, input_specs, skipped_cells
from repro_torch.nn.module import abstract_params
from repro_torch.optim.adamw import AdamWConfig, _state_dtype
from repro_torch.optim.tree import tree_map
from repro_torch.roofline import analysis
from repro_torch.roofline.components import PARTITIONER_REASON, compose_cell
from repro_torch.roofline.hw import HBM_BYTES
from repro_torch.runtime.steps import step_flops

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
MESHES = ("card", "pod", "multipod")


def make_mesh(name: str) -> Mesh:
    """The dry run's meshes; the card's is abstract too: nothing runs."""
    if name == "card":
        return make_test_mesh((1, 1), ("data", "model"))
    return make_production_mesh(multi_pod=name == "multipod")


def _parse_set(values: list[str]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for kv in values or []:
        k, v = kv.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _leaves(tree, path=""):
    """(path, leaf) pairs of a tree of dicts."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaves(v, f"{path}/{k}" if path else str(k))]
    return [(path, tree)]


def _spec_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _placed_bytes(specs, shardings) -> tuple[float, dict]:
    """Per-device bytes of `(shape, dtype)` (or meta tensor) leaves under
    their shardings, and each leaf's spec."""
    total, placed = 0.0, {}
    for (path, leaf), (_, sh) in zip(_leaves(specs), _leaves(shardings)):
        shape, dtype = (leaf.shape, leaf.dtype) if isinstance(leaf, torch.Tensor) else leaf
        n = math.prod(sh.shard_shape(tuple(shape)))
        total += n * torch.empty((), dtype=dtype).element_size()
        placed[path] = _spec_json(sh.spec)
    return total, placed


def lower_cell(arch: str, shape_name: str, *, mesh: str = "card",
               overrides: dict[str, Any] | None = None,
               artifact_suffix: str = "", verbose: bool = True,
               roofline: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    m = make_mesh(mesh)
    name = mesh_name(m)
    chips = m.size

    program = Program.from_arch(arch, kind=shape.kind, device="meta")
    woven = default_weave(program, shape, dict(m.shape), overrides=overrides)
    state = woven.state
    rules = state.rules
    model = program.model

    params = abstract_params(model, state.policies)
    ps_params = param_shardings(model, m, rules)
    params_b, placed_params = _placed_bytes(params, ps_params)
    specs = input_specs(cfg, shape)
    inputs_b, placed_inputs = _placed_bytes(
        specs["inputs"], input_shardings(specs["inputs"], m, rules))
    cache_b, placed_cache = _placed_bytes(
        specs["cache"], input_shardings(specs["cache"], m, rules))

    opt_b = 0.0
    if shape.kind == "train":
        opt_cfg = AdamWConfig(
            compression=bool(state.extra.get("grad_compression", False)),
            state_dtype=str(state.extra.get("opt_state_dtype", "float32")),
        )
        sdt = _state_dtype(opt_cfg)
        # master (fp32), m and v (and the compression residuals), placed as
        # the params are, and the step count
        for dtype in [torch.float32, sdt, sdt] + ([sdt] if opt_cfg.compression else []):
            opt_b += _placed_bytes(tree_map(lambda p: (p.shape, dtype), params),
                                   ps_params)[0]
        opt_b += 4
    argument = params_b + opt_b + inputs_b + cache_b
    # what a serving step returns beside its (in-place) state: the last
    # token's logits (in the head's compute dtype) over the batch's shards,
    # and a prefill's new cache
    output = 0.0
    if shape.kind != "train":
        logit_bytes = torch.empty((), dtype=state.policies.resolve(
            f"{model.name}/head").compute_dtype).element_size()
        output = shape.global_batch * cfg.vocab * logit_bytes / _batch_shards(
            m, rules, shape.global_batch)
        if shape.kind == "prefill":
            new_cache = (model.cache_specs(shape.global_batch, shape.seq_len,
                                           enc_len=shape.seq_len)
                         if cfg.family == "encdec" else
                         model.cache_specs(shape.global_batch, shape.seq_len))
            output += _placed_bytes(new_cache, input_shardings(new_cache, m, rules))[0]

    # The reference's analytic HBM estimate, on the card's capacity:
    #   state (argument bytes, exact) + remat boundary stack + transients.
    accum_used = int(state.extra.get("accum_steps", 1))
    data_shards = _batch_shards(m, rules, None)
    model_shards = m.shape.get("model", 1) if rules.get("res_seq") else 1
    if shape.kind == "train":
        tokens_micro = shape.global_batch * shape.seq_len / max(accum_used, 1)
        n_layers = cfg.num_layers + (cfg.enc_layers if cfg.family == "encdec" else 0)
        boundary = n_layers * tokens_micro * cfg.d_model * 2 / (
            min(data_shards, shape.global_batch // max(accum_used, 1) or 1)
            * model_shards
        )
    else:
        boundary = 0.0
    analytic_hbm = float(argument + boundary + 3 * 2**30)
    hbm_fits = analytic_hbm <= HBM_BYTES
    memory = {"argument": argument, "output": output}

    composed = None
    if roofline and chips == 1:
        composed = compose_cell(arch, shape, mesh=m, overrides=overrides,
                                verbose=verbose)
    if composed is not None:
        roof = analysis.Roofline(
            arch=arch, shape=shape_name, mesh=name, chips=chips,
            flops_per_device=composed["flops_per_device"],
            bytes_per_device=composed["bytes_per_device"],
            collective_bytes_per_device=composed["collective_bytes_per_device"],
            collective_counts={}, collective_by_op={},
            model_flops=composed["model_flops"], memory_per_device=memory)
        record = roof.to_json()
        record["hbm_per_device"] = analysis.hbm_per_device(roof)
    else:
        record = {"arch": arch, "shape": shape_name, "mesh": name, "chips": chips,
                  "model_flops": step_flops(cfg, shape), "memory_per_device": memory,
                  "hbm_per_device": argument + output}
        for key in ("flops_per_device", "bytes_per_device",
                    "collective_bytes_per_device", "collective_counts",
                    "collective_by_op", "compute_s", "memory_s", "collective_s",
                    "bottleneck", "step_s", "useful_ratio", "roofline_fraction"):
            record[key] = None
    record.update({
        "analytic_hbm_per_device": analytic_hbm,
        "hbm_fits": hbm_fits,
        "hbm_capacity": HBM_BYTES,
        "accum_steps": state.extra.get("accum_steps", 1),
        "remat": state.extra.get("remat"),
        "rules": {k: list(v) if isinstance(v, tuple) else v
                  for k, v in rules.items()},
        "placements": {"params": placed_params, "inputs": placed_inputs,
                       "cache": placed_cache},
        "overrides": overrides or {},
        "roofline": composed,
        "ok": True,
    })
    if composed is None:
        record["roofline_reason"] = (PARTITIONER_REASON if chips > 1
                                     else "not asked for")
    if verbose:
        print(f"[{arch} x {shape_name} x {name}] state/dev={argument / 1e9:.2f} GB "
              f"analytic={analytic_hbm / 1e9:.2f} GB of {HBM_BYTES / 1e9:.0f} GB "
              f"fits={hbm_fits}")

    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    fname = f"{arch}__{shape_name}__{mesh}{artifact_suffix}.json"
    with open(os.path.join(ARTIFACT_DIR, fname), "w") as f:
        json.dump(record, f, indent=1, default=str)
    return record


def _batch_shards(mesh: Mesh, rules, batch: int | None) -> int:
    """The product of the mesh axes the batch rule names (all of them when
    `batch` is None, else as many leading ones as divide it)."""
    axes = rules.get("batch") or ()
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        if a in mesh.shape and (batch is None or batch % (n * mesh.shape[a]) == 0):
            n *= mesh.shape[a]
    return n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=(*MESHES, "both"), default="card",
                    help="both: pod and multipod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    help="weave override key=value (JSON values)")
    ap.add_argument("--suffix", default="", help="artifact filename suffix")
    args = ap.parse_args()

    overrides = _parse_set(args.sets)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    if args.all:
        todo = [(arch, shape) for arch in ARCHS for shape in cells(arch)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        todo = [(args.arch, args.shape)]

    failures = []
    for arch, shape in todo:
        if shape not in cells(arch):
            print(f"SKIP {arch} x {shape}: not supported (see DESIGN.md §5)")
            continue
        for mesh in meshes:
            try:
                lower_cell(arch, shape, mesh=mesh, overrides=dict(overrides),
                           artifact_suffix=args.suffix)
            except Exception as e:
                failures.append((arch, shape, mesh, repr(e)))
                traceback.print_exc()
    for arch, shape, reason in (skipped_cells() if args.all else []):
        print(f"NOTED SKIP {arch} x {shape}: {reason}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print(f"\nDry-run green: {len(todo)} cells x meshes={args.mesh}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
