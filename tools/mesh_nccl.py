#!/usr/bin/env python3
"""The mesh phase of `chip_smoke.py` over NCCL, one card per rank: needs
four cards of one host.

    python3 tools/mesh_nccl.py [--out FILE]   # default build/mesh_nccl.json

Builds the kernels, runs `chip_smoke.serve_phase` on the first card (the
one-card launch counts, requests and serve wall), then
`chip_smoke.mesh_phase` with `backend="nccl"`: full-width, full-depth yi-6b
served tensor-parallel on a (1, 4) mesh (each rank's launches by route equal
the one-card counts, its prefill logits at the full-depth gate against one
card), gemma-2b at `MESH_TRAIN_DEPTH` layers trained on a (2, 2) mesh
(gradients at the training gates against one card, the first batch's loss
falling), and two FSDP runs on (2, 2) (`NCCL_FSDP_RUNS`, held at the gates
of `chip_smoke.py`'s (f1)..(f4), rwkv6-3b's gradient printed): rwkv6-3b at
full depth under AutoShard's own `dp_fsdp` (43.4 GB of state, `embed` over
`(data, model)`), served and trained, and qwen2-72b at 1 of 80 layers under
`megatron_tp` with the published depth's `embed` rule over `data`, trained.
Then (n3): mixtral-8x22b at full depth (56 layers, 140.6 B parameters, 281
GB in bf16: a model one card cannot hold) served on (1, 4) under
AutoShard's own `megatron_tp`, each rank drawing its own blocks (70.3 GB a
card): two prompts past the 4096-token window through `serve_continuous`
over a paged ring pool, gated without a one-card reference — every outcome
ok, each rank's launches by route what its layer count and the server's
step counts give, the routing bit for bit the same on every rank, the
prefill logits finite — and printed: peak memory a rank, the serve wall,
the decode-step time.  Prints and writes one JSON object: the phase's
summary with the one-card serve wall beside the mesh's.

    python3 tools/mesh_nccl.py --only n3   # (n3) alone
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


NCCL_FSDP_RUNS = {
    "n1": dict(arch="qwen2-72b", layers=1, mesh=(2, 2), layout="megatron_tp",
               rules={"embed": ("data",)}, serve=None, match="attn/", attn=1,
               profile=True),
    # AutoShard's own training rule at full depth, carried to serving (whose
    # 2-byte weights alone would leave `embed` whole).  Its bf16 gradient is
    # printed beside one card's, not gated: through 32 rwkv6 layers in bf16
    # a rank's one row and one card's four round apart by more than the
    # training gates (6.5 % worst, on four H100s)
    "n2": dict(arch="rwkv6-3b", layers=32, mesh=(2, 2), layout="dp_fsdp",
               rules={"embed": ("data", "model")}, serve="double", match="time_mix/",
               attn=0, profile=False, gated=False),
}


# (n3): the MoE family at full depth over four cards (`N3["layers"]`: the
# greatest depth whose blocks, pool and activations fit a card)
N3 = dict(arch="mixtral-8x22b", layers=56, mesh=(1, 4), lens=[4500, 5000], decode=8,
          max_len=6144)


def n3_rank(run, mesh) -> dict:
    """(n3) on this rank: its blocks drawn on its card, a counted
    `serve_continuous`, the routing of every MoE call, a prefill's logits."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.program import Program
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.kernels import build
    from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.nn.module import init_params
    from repro_torch.runtime.server import Server, ServerConfig
    from repro_torch.runtime.steps import build_prefill_step

    build.library()
    cfg = get_config(run["arch"]).replace(num_layers=run["layers"], layer_groups=())
    program = Program(model=build_model(cfg), cfg=cfg, kind="serve", device="cuda")
    woven = default_weave(program, SHAPES["prefill_32k"], dict(mesh.shape),
                          extra_aspects=cuda_kernel_aspects())
    t0 = time.perf_counter()
    params = init_params(program.model, 0, woven.state.policies, "cuda",
                         shardings=param_shardings(program.model, mesh, woven.state.rules),
                         local=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = sum(p.numel() * p.element_size() for p in program.model.parameters())
    server = Server(woven, ServerConfig(max_cache_len=run["max_len"],
                                        decode_tokens=run["decode"], seed=0),
                    params=params, mesh=mesh)
    rng = np.random.default_rng(30)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int64) for n in run["lens"]]
    with cs.RouteRecorder() as rec:
        out, wall, counts, routes = cs.counted_serve(torch, lambda: server.serve_continuous(
            prompts, max_batch=len(prompts), page_size=cs.FAMILY_PAGE))
    cs.check_paged_run(server, "n3", f"rank {mesh.rank}", prompts, out, counts, routes, False)
    steps = sorted(server.decode_step_latencies)
    toks = torch.as_tensor(prompts[0][None, :512].astype(np.int32), device="cuda")
    with torch.no_grad():
        logits, cache = build_prefill_step(woven, mesh=mesh)(params, {"tokens": toks})
    del cache
    # where a decode step's time goes (B 2 over the prompt's first 512
    # tokens); under NCCL the profiler counts a rank's waits as busy
    prof = cs.profile_decode(torch, server, toks.repeat(2, 1))
    mine = {"rank": mesh.rank, "layout": woven.state.extra.get("layout"),
            "rules_embed": woven.state.rules.get("embed"), "layers": cfg.num_layers,
            "held_gb": held / 1e9, "init_s": init_s, "serve_wall_s": wall,
            "launches": {**counts, **routes}, "steps": dict(server.last_step_counts),
            "outcomes": [o["status"] for o in server.last_outcomes],
            "decode_step_ms_median": 1e3 * steps[len(steps) // 2] if steps else None,
            "decode_step_ms": [1e3 * s for s in server.decode_step_latencies],
            "ttft_s": [o["ttft_s"] for o in server.last_outcomes],
            "logits_finite": bool(torch.isfinite(logits).all()), "profile": prof,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "tokens": [o.tolist() for o in out]}
    return {"ranks": cs.every_rank(mine, mesh), "routing": cs.every_rank(rec.calls, mesh)}


def n3_phase(run=N3) -> dict:
    """(n3) on four cards, and its gates: each rank's layout `megatron_tp`,
    every outcome ok (`check_paged_run` on the ranks), every rank's routing
    and tokens bit for bit rank 0's, the logits finite."""
    import torch

    import chip_smoke as cs
    from repro_torch.launch.mesh import run_on_mesh

    t0 = time.perf_counter()
    res = run_on_mesh(partial(n3_rank, run), run["mesh"], backend="nccl", device="cuda",
                      timeout_s=1500)
    ranks, routing = res["ranks"], res["routing"]
    for r, calls in zip(ranks, routing):
        if r["layout"] != "megatron_tp" or not r["logits_finite"] \
                or set(r["outcomes"]) != {"ok"}:
            raise AssertionError(f"n3 rank {r['rank']}: layout {r['layout']}, logits finite "
                                 f"{r['logits_finite']}, outcomes {r['outcomes']}")
        if len(calls) != len(routing[0]) or not all(
                torch.equal(a, b) for a, b in zip(calls, routing[0])):
            raise AssertionError(f"n3 rank {r['rank']}: routes otherwise than rank 0")
        if r["tokens"] != ranks[0]["tokens"]:
            raise AssertionError(f"n3 rank {r['rank']}: tokens differ from rank 0's")
    summary = {"arch": run["arch"], "layers": run["layers"], "mesh": list(run["mesh"]),
               "routings": len(routing[0]), "wall_s": time.perf_counter() - t0,
               "ranks": [{k: v for k, v in r.items() if k != "tokens"} for r in ranks]}
    cs.log("n3 " + json.dumps(summary, default=float))
    return summary


def main() -> int:
    import gc

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "mesh_nccl.json"))
    ap.add_argument("--only", choices=("n3",), default=None,
                    help="run (n3) alone, without the mesh phase")
    args = ap.parse_args()
    if torch.cuda.device_count() < 4:
        print("mesh_nccl: needs four CUDA devices", file=sys.stderr)
        return 1
    os.environ["REPRO_TORCH_TUNER_CACHE"] = os.path.join(tempfile.mkdtemp(), "empty.json")
    t0 = time.perf_counter()
    build.build()
    build.library()
    if args.only == "n3":
        summary = {"n3": n3_phase()}
        summary.update(card=cs.nvidia_smi_line(), devices=torch.cuda.device_count(),
                       total_s=time.perf_counter() - t0)
        return write(args.out, summary)
    counts, server, requests = cs.serve_phase(torch)
    t1 = time.perf_counter()  # the same traffic again on one card, warm
    for p in requests["solo"]:
        server.serve(p)
    server.serve_batch(requests["batch"])
    torch.cuda.synchronize()
    one_card_serve_s = time.perf_counter() - t1
    del server
    gc.collect()
    torch.cuda.empty_cache()
    summary = cs.mesh_phase(torch, counts, requests, backend="nccl", serve_shape=(1, 4),
                            train_shapes={"dp2_tp2": (2, 2)}, fsdp_runs=NCCL_FSDP_RUNS,
                            family_runs={}, family_sp_runs={}, serve_sp_runs=(),
                            control_runs=(),
                            serve_depth=None)
    summary["one_card_serve_s"] = one_card_serve_s
    summary["n3"] = n3_phase()
    summary["card"] = cs.nvidia_smi_line()
    summary["devices"] = torch.cuda.device_count()
    summary["total_s"] = time.perf_counter() - t0
    return write(args.out, summary)


def write(path: str, summary: dict) -> int:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary, f, default=float)
    print(json.dumps({k: summary.get(k) for k in ("card", "devices", "total_s",
                                                  "one_card_serve_s", "ranks_wall_s")},
                     default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
