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
`megatron_tp` with the published depth's `embed` rule over `data`, trained.  Prints and writes one
JSON object: the phase's summary with the one-card serve wall beside the
mesh's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

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


def main() -> int:
    import gc

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "mesh_nccl.json"))
    args = ap.parse_args()
    if torch.cuda.device_count() < 4:
        print("mesh_nccl: needs four CUDA devices", file=sys.stderr)
        return 1
    os.environ["REPRO_TORCH_TUNER_CACHE"] = os.path.join(tempfile.mkdtemp(), "empty.json")
    t0 = time.perf_counter()
    build.build()
    build.library()
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
                            train_shapes={"dp2_tp2": (2, 2)}, fsdp_runs=NCCL_FSDP_RUNS)
    summary["one_card_serve_s"] = one_card_serve_s
    summary["card"] = cs.nvidia_smi_line()
    summary["devices"] = torch.cuda.device_count()
    summary["total_s"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, default=float)
    print(json.dumps({k: summary[k] for k in ("card", "devices", "total_s",
                                              "one_card_serve_s", "ranks_wall_s")},
                     default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
