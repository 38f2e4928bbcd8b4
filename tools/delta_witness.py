#!/usr/bin/env python3
"""Why K3's bf16 attention gradients part from the plain attention's in
training, on one card: the witness at one attention layer.

    python3 tools/delta_witness.py [--runs h,w] [--out chiprun_out/delta_witness.json]

Runs `chip_smoke.py`'s training runs (`TRAIN_FAMILY_RUNS`: (h)
recurrentgemma-2b, (w) whisper-small, (m) mixtral-8x22b) with all their
gates, and keeps the residuals of the first K3 call of the kernel path's
gradient — the top attention layer — and, for whisper, of its first
non-causal call (the top encoder layer).  On them it sets each backward
against the float64 plain backward on float64 residuals (delta exact):

- `K3`: the kernel, delta = rowsum(dO O) from K1's bf16 output;
- `plain_o_bf16`: `flash_attention_bwd_ref` in fp32 on the same bf16 output;
- `plain_o_fp32`: the same with the fp32 output, so delta = rowsum(P dP);
- `plain_o_fp32_rounded`: as `plain_o_fp32`, with P and dS rounded to bf16
  before their products, as the tensor-core route rounds them.

Each: dq, dk, dv's relative L2 error.  Also: the keys' common part (the
norm of the mean key times sqrt(T) over the norm of the rest), and the share
of output elements where K1's bf16 output differs from the plain one's.
Prints one JSON line a layer and writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def rounded_bwd(torch, ref, q, k, v, out, lse, do, *, causal, window, softcap):
    """`flash_attention_bwd_ref` in fp32 with P and dS rounded to bf16
    before the products that take them."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    s, mask = ref._scores_and_mask(q, k, causal=causal, window=window, softcap=softcap)
    lse5 = lse.float().reshape(B, K, G, S)[..., None]
    p = torch.exp(torch.where(mask, s, torch.full_like(s, ref.NEG_INF)) - lse5) * mask.float()
    dof = do.float().reshape(B, S, K, G, D)
    delta = torch.sum(dof * out.float().reshape(B, S, K, G, D), dim=-1)
    dp = torch.einsum("bskgd,btkd->bkgst", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if softcap is not None:
        ds = ds * (1.0 - torch.square(s / softcap))
    ds = ds.bfloat16().float()
    p = p.bfloat16().float()
    scale = 1.0 / math.sqrt(D)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, q.float().reshape(B, S, K, G, D)) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    return dq.reshape(B, S, H, D), dk, dv


def witness(torch, name, q, k, v, out, lse, do, opts) -> dict:
    from repro_torch.kernels.flash_attention import ops, ref

    mode = {key: opts[key] for key in ("causal", "window", "softcap")}
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = ref.attention_ref(q64, k64, v64, return_lse=True, **mode)
    truth = ref.flash_attention_bwd_ref(q64, k64, v64, o64, lse64, do64, **mode)
    del q64, v64, do64, o64, lse64
    o32 = ref.attention_ref(q.float(), k.float(), v.float(), **mode)
    kbar = k64.mean(dim=1, keepdim=True)
    res = {"layer": name, "q": list(q.shape), "k": list(k.shape), **mode,
           "key_common_part": (kbar.norm() * math.sqrt(k.shape[1])
                               / (k64 - kbar).norm()).item(),
           "k1_output_differs_share": (out != o32.to(out.dtype)).float().mean().item()}
    del k64, kbar
    backwards = {
        "K3": lambda: ops.flash_attention_bwd(q, k, v, out, lse, do, **opts),
        "plain_o_bf16": lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **mode),
        "plain_o_fp32": lambda: ref.flash_attention_bwd_ref(q, k, v, o32, lse, do, **mode),
        "plain_o_fp32_rounded": lambda: rounded_bwd(torch, ref, q, k, v, o32, lse, do,
                                                    **mode),
    }
    for label, fn in backwards.items():
        grads = fn()
        res[label] = {g: ((got.double() - want).norm() / want.norm()).item()
                      for g, got, want in zip(("dq", "dk", "dv"), grads, truth)}
        del grads
        torch.cuda.empty_cache()
    return res


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="h,w")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "delta_witness.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("delta_witness: no CUDA device is available", file=sys.stderr)
        return 1
    tuner_home = tempfile.mkdtemp(prefix="repro_torch_tuner_")
    os.environ["REPRO_TORCH_TUNER_CACHE"] = os.path.join(tuner_home, "empty.json")
    print(cs.nvidia_smi_line(), flush=True)
    build.build()
    build.library()

    captured = {}
    digest = cs.gradient_digest

    def capturing_digest(torch_, woven, params, mb, stacks):
        """The run's first gradient (the kernel path's) keeps K3's inputs."""
        if captured:
            return digest(torch_, woven, params, mb, stacks)
        core = ops._FlashCore.backward

        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            do = do.contiguous()
            for key, take in (("top", True), ("top_non_causal", not ctx.opts["causal"])):
                if take and key not in captured:
                    captured[key] = (q, k, v, out, lse, do, dict(ctx.opts))
            return ops.flash_attention_bwd(q, k, v, out, lse, do, **ctx.opts) + (None,) * 9

        ops._FlashCore.backward = staticmethod(backward)
        try:
            return digest(torch_, woven, params, mb, stacks)
        finally:
            ops._FlashCore.backward = staticmethod(core)

    cs.gradient_digest = capturing_digest
    rows = []
    for tag in args.runs.split(","):
        captured.clear()
        cs.train_family_run(torch, tag, cs.TRAIN_FAMILY_RUNS[tag])
        gc.collect()
        torch.cuda.empty_cache()
        for key, (q, k, v, out, lse, do, opts) in list(captured.items()):
            with torch.no_grad():
                row = witness(torch, f"{tag} {key}", q, k, v, out, lse, do, opts)
            print("delta-witness " + json.dumps(row), flush=True)
            rows.append(row)
        captured.clear()
        gc.collect()
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
