#!/usr/bin/env python3
"""Flash decode's split route against variants of itself, on one card: the
time of the single-token shapes the serving path gives it, for each chunk
of logical slots the route could compile in and each depth of a warp's
cp.async ring.

    python3 tools/decode_chunk_variants.py [--only chunk_128 chunk_256 ...] [--logits]
                                           [--out chiprun_out/decode_chunks.json]

Each variant is a copy of `src/repro_torch/csrc/` with `kSplitChunk` or
`kSplitStages` or `kSplitStep` edited (decode_split.cuh), built into a
library of its own, with `decode.SPLIT_CHUNK` set to match.  Variants:
`chunk_128` (the shipped sources: chunks of 128 slots, two ring stages,
steps of 2048 K elements — 16 slots at head dim 128), `chunk_128_stages_3`,
`chunk_256`, `chunk_256_stages_3`, `chunk_512` and `chunk_1024` (three
stages), and `step_4096` (chunk 256, steps of 32 slots at head dim 128, two
stages; a block's shared memory holds no fourth stage at head dim 256).
With `--logits` each variant also reads chip_smoke.py's full-depth yi-6b
logit gate (prefill and first decode against the plain path, as shares of
the logit scale): the variants differ only in the order of their fp32
sums, so what moves the gap between them is rounding.  Shapes (random bf16
inputs from seed 0; the cache copied four times so that each launch finds
it cold in the L2, as a step over 32 layers does; the launches replayed
from a CUDA graph, since one is shorter than the time Python takes to
issue it):

- `yi6b_B8_T4096_ragged_bf16`: chip_smoke.py's K2 main case;
- `yi6b_B8_T4096_ragged_bf16_paged128`: the same values as a shuffled pool
  of 128-slot pages;
- `yi6b_B8_T4096_ragged_int8_paged128`: its K2d main case (int8 codes of
  the same values in such a pool);
- `yi6b_B2_T4096_index520_bf16`: a decode step of the B=2 serve profile;
- `rgemma_ring_T2048_H10_K1_D256_bf16`: recurrentgemma-2b's ring decode.

Every output is held to the plain version within chip_smoke.py's bf16
gate.  Prints one JSON line per variant, with the card's name and power
limit, and writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# variant -> (kSplitChunk, kSplitStages, kSplitStep)
VARIANTS = {"chunk_128": (128, 2, 2048), "chunk_128_stages_3": (128, 3, 2048),
            "chunk_256": (256, 2, 2048), "chunk_256_stages_3": (256, 3, 2048),
            "chunk_512": (512, 3, 2048), "chunk_1024": (1024, 3, 2048),
            "step_4096": (256, 2, 4096)}
RAGGED = [199, 511, 1023, 1500, 2047, 2999, 3500, 4095]
SHAPES = [  # name, indices, T, H, K, D, pool: None (dense), "bf16" or "int8" (paged 128)
    ("yi6b_B8_T4096_ragged_bf16", RAGGED, 4096, 32, 4, 128, None),
    ("yi6b_B8_T4096_ragged_bf16_paged128", RAGGED, 4096, 32, 4, 128, "bf16"),
    ("yi6b_B8_T4096_ragged_int8_paged128", RAGGED, 4096, 32, 4, 128, "int8"),
    ("yi6b_B2_T4096_index520_bf16", [520, 521], 4096, 32, 4, 128, None),
    ("rgemma_ring_T2048_H10_K1_D256_bf16",
     [231, 631, 1031, 1431, 1831, 2231, 2631, 3031], 2048, 10, 1, 256, None),
]


def cases(torch, chip_smoke):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
    from repro_torch.kernels.flash_attention.ref import decode_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for name, idx, T, H, K, D, pool in SHAPES:
        B = len(idx)
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        kw, elt = {}, 2
        if pool is not None:
            ps, nb = 128, T // 128
            perm = torch.randperm(B * nb, generator=gen, device="cuda")
            kw = dict(tables=perm.reshape(B, nb).to(torch.int32), kv_len=T)
            pooled = {}
            for key, x in (("k", k), ("v", v)):
                pages = x.reshape(B * nb, ps, K, D)
                if pool == "int8":
                    sc = ops.kv_scale_from_absmax(
                        pages.float().abs().amax(dim=(1, 3)), torch.int8)
                    pages = ops.quantize_kv_write(pages, sc[:, None, :], torch.int8)
                    pooled[key + "_scale"] = torch.empty_like(sc)
                    pooled[key + "_scale"][perm] = sc
                pooled[key] = torch.empty_like(pages)
                pooled[key][perm] = pages
            k, v = pooled.pop("k"), pooled.pop("v")
            kw.update(pooled)  # the scales of an int8 pool
            elt = k.element_size()
        got = ops.flash_decode(q, k, v, index, **kw)
        torch.cuda.synchronize()
        if flash_decode_fwd.last_route != "tc_split":
            raise AssertionError(f"{name}: route {flash_decode_fwd.last_route}")
        err, rms = chip_smoke.check_close(torch, name, got, decode_ref(q, k, v, index, **kw),
                                          chip_smoke.BF16_TOL)
        copies = [(k, v)] + [(k.clone(), v.clone()) for _ in range(3)]
        ms = chip_smoke.time_ms(torch, [
            (lambda kk=kk, vv=vv: ops.flash_decode(q, kk, vv, index, **kw))
            for kk, vv in copies], 50, graph=True)
        slots = sum(max(1, min(T, i + 1)) for i in idx)
        nbytes = slots * K * D * 2 * elt + 2 * q.numel() * 2
        out[name] = {"ms": ms, "bound_ms": nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3,
                     "gb_s": nbytes / ms / 1e6, "err_over_rms": err / rms}
        del copies, q, k, v
        torch.cuda.empty_cache()
    return out


def logit_servers(torch, wanted: bool):
    """chip_smoke.py serve_phase's pair — full-width yi-6b (random weights
    from seed 0) woven to the kernels and to the plain path — and its prompt
    (B=2 x 512 tokens), for `chip_smoke.logit_gap`; () if not `wanted`."""
    if not wanted:
        return ()
    import numpy as np

    from repro_torch.configs.base import SHAPES
    from repro_torch.core.program import Program
    from repro_torch.launch.serve import build_server
    from repro_torch.launch.weave import default_weave
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = ServerConfig(max_cache_len=4096, decode_tokens=32, seed=0)
    server = build_server("yi-6b", reduced=False, device="cuda", cfg=cfg)
    program = Program.from_arch("yi-6b", kind="serve", reduced=False, device="cuda")
    eager = Server(default_weave(program, SHAPES["prefill_32k"], {}), cfg)
    vocab = server.woven.program.cfg.vocab
    toks = np.random.default_rng(0).integers(0, vocab, (2, 512), dtype=np.int32)
    return server, eager, torch.as_tensor(toks, device="cuda")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", nargs="*", default=None, help="variant names")
    parser.add_argument("--logits", action="store_true",
                        help="also read serve_phase's full-depth yi-6b logit gap")
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                      "decode_chunks.json"))
    args = parser.parse_args()

    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import decode

    if not torch.cuda.is_available():
        print("decode_chunk_variants: needs one CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.nvidia_smi_line()
    src = Path(build.CSRC)
    servers = logit_servers(torch, args.logits)
    results = []
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for name, (chunk, stages, step) in VARIANTS.items():
            if args.only and name not in args.only:
                continue
            csrc = Path(tmp) / name / "csrc"
            shutil.copytree(src, csrc)
            path = csrc / "decode_split.cuh"
            text = path.read_text()
            for const, value in (("kSplitChunk", chunk), ("kSplitStages", stages),
                                 ("kSplitStep", step)):
                text, n = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
                if n != 1:
                    raise RuntimeError(f"{const} is not in decode_split.cuh once")
            path.write_text(text)
            build.CSRC = csrc
            build.build_dir = lambda d=Path(tmp) / name / "build": d
            build.library.cache_clear()
            decode.SPLIT_CHUNK = chunk
            _, seconds = build.build()
            build.library()
            row = {"variant": name, "chunk": chunk, "stages": stages, "step": step,
                   "card": card, "build_s": seconds, "cases": cases(torch, chip_smoke)}
            if servers:
                gap = chip_smoke.logit_gap(torch, *servers, "kernels vs plain, bf16")
                row["yi6b_logits_vs_eager_over_scale"] = {
                    what: {"max": gap[what]["max_abs_err"] / gap[what]["logit_scale"],
                           "rms": gap[what]["rms_err"] / gap[what]["logit_scale"]}
                    for what in ("prefill", "first_decode")}
            print(json.dumps(row), flush=True)
            results.append(row)
            build.library.cache_clear()
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
