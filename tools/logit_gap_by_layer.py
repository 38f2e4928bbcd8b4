#!/usr/bin/env python3
"""Where the full-depth logit gap between the port's kernel path and its
eager path builds up, layer by layer, for full-width yi-6b on one card.

    python3 tools/logit_gap_by_layer.py

Builds the yi-6b server `chip_smoke.py` serves (random weights, seed 0) and
the same model woven to the plain implementations, prefills one B2 S512
prompt through each — and once more through the kernel server with K1
swapped for its plain fp32 version — recording every block's and every
attention's output, and prints one JSON line: for each pair of runs the RMS
of the difference over the RMS of the second, layer by layer, and the worst
prefill logit over the logit scale.  A diagnostic: nothing is gated.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def logit_gap_by_layer(torch, server, eager, toks) -> dict:
    """Where the full-depth logit gap between the kernel path and the eager
    path builds up (ROADMAP Queue 3): one prefill through each server, and
    one more through the kernel server with K1 swapped for its plain fp32
    version (exact probabilities, as K1's), each block's and each
    attention's output recorded.  For each pair: the RMS of the difference
    over the RMS of the second, layer by layer, and the worst prefill logit
    over the logit scale.  Printed, not gated."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.nn.stack import ScannedStack

    def capture(srv):
        stack = next(m for m in srv.woven.program.model.modules()
                     if isinstance(m, ScannedStack))
        attn = next(m for m in stack.template.modules() if type(m).__name__ == "Attention")
        blocks, attns = [], []
        hooks = [stack.template.register_forward_hook(
                     lambda m, i, o: blocks.append(o[0].float())),
                 attn.register_forward_hook(lambda m, i, o: attns.append(o[0].float()))]
        try:
            logits, _ = srv.prefill_vc(None, srv.params, {"tokens": toks})
        finally:
            for hook in hooks:
                hook.remove()
        return blocks, attns, logits.float()

    def plain_fwd(q, k, v, *, causal, window, softcap, return_lse, **_):
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                             return_lse=return_lse)

    plain_fwd.last_route = "fma"  # what the wrappers' route counters read

    runs = {"kernels": capture(server), "eager": capture(eager)}
    real = attn_ops.flash_attention_fwd
    attn_ops.flash_attention_fwd = plain_fwd
    try:
        runs["plain_fp32_attention"] = capture(server)
    finally:
        attn_ops.flash_attention_fwd = real

    def rel(x, y):
        return round(((x - y).pow(2).mean().sqrt() / y.pow(2).mean().sqrt()).item(), 6)

    out = {}
    for a, b in (("kernels", "eager"), ("plain_fp32_attention", "eager"),
                 ("kernels", "plain_fp32_attention")):
        (ba, aa, la), (bb, ab, lb) = runs[a], runs[b]
        out[f"{a}_vs_{b}"] = {
            "worst_logit_over_scale": (la - lb).abs().max().item() / lb.abs().max().item(),
            "block_out_rel_rms": [rel(x, y) for x, y in zip(ba, bb)],
            "attention_out_rel_rms": [rel(x, y) for x, y in zip(aa, ab)]}
    return out


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.configs.base import SHAPES
    from repro_torch.core.program import Program
    from repro_torch.launch.serve import build_server
    from repro_torch.launch.weave import default_weave
    from repro_torch.runtime.server import Server, ServerConfig

    if not torch.cuda.is_available():
        print("logit_gap_by_layer: needs one CUDA device", file=sys.stderr)
        return 1
    cfg = ServerConfig(max_cache_len=4096, decode_tokens=2, seed=0)
    server = build_server("yi-6b", reduced=False, device="cuda", cfg=cfg)
    program = Program.from_arch("yi-6b", kind="serve", reduced=False, device="cuda")
    eager = Server(default_weave(program, SHAPES["prefill_32k"], {}), cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, server.woven.program.cfg.vocab, (2, 512), dtype=np.int32)
    for srv in (server, eager):  # pins the cache length, as chip_smoke.py's serve does
        srv.serve(toks)
    out = logit_gap_by_layer(torch, server, eager, torch.as_tensor(toks, device="cuda"))
    print("logit-gap-by-layer " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
