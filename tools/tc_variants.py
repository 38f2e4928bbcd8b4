#!/usr/bin/env python3
"""K1 and K3's tensor-core route against variants of itself, on one card:
what each design choice buys in time and in accuracy, and whether the
kernel gate of `chip_smoke.py` tells a lower-precision kernel from the
shipped one.

    python3 tools/tc_variants.py [--out chiprun_out/tc_variants.json]

Each variant is a copy of `src/repro_torch/csrc/` with one edit, built into
a library of its own; `chip_smoke.py`'s K1 cases (`prefill_cases`) and
K1-with-lse / K3 cases (`flash_bwd_cases`) then run on it with the same
seeded inputs, every output held to the float64 plain version as
`check_exact` holds it — here recorded instead of raised, so that a variant
over the gate is read to its end.  Variants:

- `shipped`: the sources as they are;
- `p_one_part_rounded`: P (and dS in K3) enters its product as one bf16
  value rounded to nearest — the eager path's rounding of the probabilities;
- `p_one_part_truncated`: one bf16 part, its top 16 bits (a cheaper and
  cruder rounding: the control the gate should catch first);
- `p_two_parts`: two bf16 parts (16 significant bits of P);
- `sum_in_mma`: every product accumulated by the tensor cores into the
  running sum itself (no separate IEEE fp32 add);
- `d256_one_warp_set`: K1 at D = 256 with four warps holding all 256 output
  columns (128 fp32 sums a thread), the layout that spilled.

Prints one JSON line per variant and writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

RN_PART = ("const uint32_t xb = __float_as_uint(x) & 0xffff0000u;",
           "const uint32_t xb = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x)) << 16;",
           "const uint32_t yb = __float_as_uint(y) & 0xffff0000u;",
           "const uint32_t yb = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(y)) << 16;")
PARTS = {"attend_tc.cuh": "constexpr int kTcParts = 3;",
         "flash_bwd.cu": "constexpr int kTcParts = 3;"}


def parts(n):
    return {f: [(old, old.replace("3", str(n)))] for f, old in PARTS.items()}


VARIANTS = {
    "shipped": {},
    "p_one_part_rounded": {**parts(1), "mma_tile.cuh": [RN_PART[:2], RN_PART[2:]]},
    "p_one_part_truncated": parts(1),
    "p_two_parts": parts(2),
    "sum_in_mma": {"mma_tile.cuh": [
        ("""  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a, b0, b1);
  d[0] += t[0]; d[1] += t[1]; d[2] += t[2]; d[3] += t[3];""", "  mma(d, a, b0, b1);"),
        ("""  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = NP - 1; j >= 0; --j) mma(t, a[j], b0, b1);
  d[0] += t[0]; d[1] += t[1]; d[2] += t[2]; d[3] += t[3];""",
         """#pragma unroll
  for (int j = NP - 1; j >= 0; --j) mma(d, a[j], b0, b1);""")]},
    "d256_one_warp_set": {"attend_tc.cuh": [
        ("static constexpr int NS = DP > 128 ? 2 : 1;", "static constexpr int NS = 1;")]},
}


def make_sources(src, dst, edits):
    shutil.copytree(src, dst)
    for name, pairs in edits.items():
        path = os.path.join(dst, name)
        text = open(path).read()
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to edit is not there once: {old!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "tc_variants.json"))
    parser.add_argument("--only", nargs="*", default=None, help="variant names")
    args = parser.parse_args()

    import torch
    from pathlib import Path

    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("tc_variants: needs one CUDA device", file=sys.stderr)
        return 1
    readings = []

    def recording_check(torch_, name, got, want, rel_tol):
        if got.shape != want.shape or not torch_.isfinite(got).all():
            raise AssertionError(f"{name}: wrong shape or not finite")
        err, rms = chip_smoke.exact_error(torch_, got, want)
        readings.append({"case": name, "err_over_rms": err / rms, "passes": err <= rel_tol * rms})
        return err, rms

    chip_smoke.check_exact = recording_check
    card = chip_smoke.nvidia_smi_line()
    src = Path(build.CSRC)
    results = []
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for name, edits in VARIANTS.items():
            if args.only and name not in args.only:
                continue
            csrc = Path(tmp) / name / "csrc"
            make_sources(src, csrc, edits)
            build.CSRC = csrc
            build.build_dir = lambda d=Path(tmp) / name / "build": d
            build.library.cache_clear()
            _, seconds = build.build()
            build.library()
            spills = [line for line in chip_smoke.ptxas_summary(build.build_log())
                      if "_tc_" in line]
            readings.clear()
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            t0 = time.perf_counter()
            pre = chip_smoke.prefill_cases(torch, gen)
            lse_c, dq_c, dkv_c = chip_smoke.flash_bwd_cases(torch, gen)
            tc = [r for r in readings if "fp32" not in r["case"]]  # the bf16 route
            row = {
                "variant": name, "card": card, "build_s": seconds, "ptxas_tc": spills,
                "worst_err_over_rms": max(r["err_over_rms"] for r in tc),
                "cases_over_gate": [r["case"] for r in tc if not r["passes"]],
                "k1_ms": {c["case"]: c["ms"] for c in pre},
                "k1_lse_ms": {c["case"]: c["ms"] for c in lse_c},
                "k3_both_passes_ms": {c["case"]: c["ms_both_passes"] for c in dq_c},
                "sdpa_ms": {c["case"]: c["library_ms"] for c in pre},
                "readings": readings[:], "seconds": time.perf_counter() - t0,
            }
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
