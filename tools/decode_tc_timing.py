#!/usr/bin/env python3
"""K2's tensor-core route over a whole cache, timed in two checkouts on one
card: whether a change to the route's kernel moved the time of the calls
that do not use what it added.

    python3 tools/decode_tc_timing.py [--compare OTHER_CHECKOUT] [--out FILE]

Without `--compare` it builds this checkout's kernels and times the cases
below once.  With `--compare` it times the other checkout's package and
this one's, in the order other, this, this, other, each in a process of
its own that builds (or reuses) that checkout's library, and prints each
run's times and the ratio of this checkout's mean to the other's.
Cases (random inputs from seed 0, bf16 q, no softcap, no window):

- `gemma2b_int8_suffix512_D256`: gemma-2b's int8 pool suffix prefill, 512
  tokens over a 1024-token prefix, B1 H8 K1 D256, page 128, shuffled
  tables (K2d widened over codes at D 256);
- `gemma2b_int8_verify_S3_B8_D256`: a k = 2 verify step over the int8
  pool, B8 S3 at ragged positions up to 4095, same heads and pages;
- `gemma2b_bf16_suffix512_D256`: the first case over bf16 values;
- `yi6b_int8_suffix512_D128`: `chip_smoke.py`'s K2d widened row, B1 H32
  K4 D128.

Each time is the mean of one call over 50 calls between CUDA events, the
least of five such runs.  Prints one JSON line per run (with the card's
name and power limit) and writes them all to `--out` (default
`chiprun_out/decode_tc_timing.json`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {  # name: (H, K, D, code type or None, S, first positions)
    "gemma2b_int8_suffix512_D256": (8, 1, 256, "int8", 512, [1024]),
    "gemma2b_int8_verify_S3_B8_D256": (8, 1, 256, "int8", 3,
                                       [197, 509, 1021, 1498, 2045, 2997, 3498, 4093]),
    "gemma2b_bf16_suffix512_D256": (8, 1, 256, None, 512, [1024]),
    "yi6b_int8_suffix512_D128": (32, 4, 128, "int8", 512, [1024]),
}
PAGE = 128


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def case_inputs(torch, gen, H, K, D, codes, S, idx):
    """q and a shuffled page pool holding each request's first idx + S
    slots (values, or int8 codes with their page scales)."""
    from repro_torch.kernels.flash_attention.ops import kv_scale_from_absmax, quantize_kv_write

    B = len(idx)
    nb = -(-(max(idx) + S) // PAGE)
    P = B * nb + 16
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(P, generator=gen, device="cuda")[:B * nb]
    tables = perm.reshape(B, nb).to(torch.int32)
    kw = dict(tables=tables, kv_len=nb * PAGE)
    pools = []
    for _ in range(2):
        x = torch.randn((B * nb, PAGE, K, D), generator=gen, device="cuda")
        if codes is None:
            pool = torch.zeros((P, PAGE, K, D), dtype=torch.bfloat16, device="cuda")
            pool[perm] = x.to(torch.bfloat16)
            pools.append((pool, None))
            continue
        scale = kv_scale_from_absmax(x.abs().amax(dim=(1, 3)), torch.int8)  # (pages, K)
        pool = torch.zeros((P, PAGE, K, D), dtype=torch.int8, device="cuda")
        pool[perm] = quantize_kv_write(x, scale[:, None, :], torch.int8)
        sc = torch.ones((P, K), device="cuda")
        sc[perm] = scale
        pools.append((pool, sc))
    (pk, ks), (pv, vs) = pools
    if codes is not None:
        kw.update(k_scale=ks, v_scale=vs)
    index = torch.tensor(idx, dtype=torch.int32, device="cuda")
    return q, pk, pv, index, kw


def run_here() -> dict:
    """This checkout's kernels built and every case timed."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import flash_decode

    _, build_s = build.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {"checkout": ROOT, "card": card(), "build_s": build_s, "ms": {}}
    for name, spec in CASES.items():
        q, pk, pv, index, kw = case_inputs(torch, gen, *spec)
        fn = lambda: flash_decode(q, pk, pv, index, **kw)  # noqa: E731
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        best = None
        for _ in range(5):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                fn()
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop) / 50
            best = ms if best is None else min(best, ms)
        out["ms"][name] = best
        del q, pk, pv
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare", default=None,
                    help="another checkout of the repo, timed before and after this one")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "decode_tc_timing.json"))
    args = ap.parse_args(argv)
    if args.compare is None:
        print(json.dumps(run_here()), flush=True)
        return 0
    other = os.path.abspath(args.compare)
    runs = []
    for tree in (other, ROOT, ROOT, other):  # this script, importing `tree`'s package
        env = dict(os.environ, DECODE_TC_TIMING_ROOT=tree)
        got = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree-run"],
                             env=env, capture_output=True, text=True)
        if got.returncode != 0:
            raise RuntimeError(f"timing {tree} failed:\n{got.stderr[-4000:]}")
        runs.append(json.loads(got.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    ratio = {name: (runs[1]["ms"][name] + runs[2]["ms"][name])
             / (runs[0]["ms"][name] + runs[3]["ms"][name]) for name in CASES}
    summary = {"this_over_other": ratio, "card": runs[0]["card"]}
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"runs": runs, **summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    if "--tree-run" in sys.argv:
        ROOT = os.environ["DECODE_TC_TIMING_ROOT"]
        print(json.dumps(run_here()), flush=True)
        sys.exit(0)
    sys.exit(main())
