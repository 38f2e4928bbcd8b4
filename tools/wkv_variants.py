#!/usr/bin/env python3
"""K6's chunk-parallel WKV kernel against variants of itself, on one card:
where its time goes and what its compiled-in choices buy.

    python3 tools/wkv_variants.py [--out FILE]

Each variant is a copy of `src/repro_torch/csrc/wkv6.cu` (and the
`mma_tile.cuh` it includes) with one edit, built alone into a library of its
own.  Each is run at `chip_smoke.py`'s main shape (B1 S2048 H40, bf16 r / k /
v) — the whole call timed by CUDA events, each of its three launches by
`torch.profiler` — and at rwkv6-3b's prefill shape (B2 S512 H40), with its
worst error against the sequential plain version.  Variants:

- `shipped`: the source as it is (chunks of 32 steps, eight warps a block);
- `chunk64`: chunks of 64 steps;
- `warps4`: four warps a block;
- `diag_exp`: A's diagonal sub-blocks from exp(li_{i-1} - li_j) per pair
  and channel instead of the running product of the decays.

Prints one JSON line per variant and writes them all to `--out`
(default `build/wkv_variants.json`, beside the kernel build).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

DIAG_EXP = (
    """            part += rs[i * kWkvLD + c0 + e] * kj[e] * d[e];
            d[e] *= wc[i * kWkvLD + c0 + e];""",
    """            part += rs[i * kWkvLD + c0 + e] * kj[e] *
                    expf(fminf(li[(i - 1) * kWkvLD + c0 + e] - li[j * kWkvLD + c0 + e], 0.f));""")
CHUNK64 = ("constexpr int kWkvChunk = 32;", "constexpr int kWkvChunk = 64;")
VARIANTS = {  # name: (the chunk the edited source compiles in, its edits)
    "shipped": (32, []),
    "chunk64": (64, [CHUNK64]),
    "warps4": (32, [("constexpr int kWkvWarps = 8;", "constexpr int kWkvWarps = 4;")]),
    "diag_exp": (32, [DIAG_EXP]),
}


def build_variant(nvcc, flags, src_dir, out_dir, edits):
    os.makedirs(out_dir)
    for name in ("wkv6.cu", "mma_tile.cuh"):
        shutil.copy(os.path.join(src_dir, name), out_dir)
    path = os.path.join(out_dir, "wkv6.cu")
    text = open(path).read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the text to edit is not there once: {old!r}")
        text = text.replace(old, new)
    open(path, "w").write(text)
    cmd = [nvcc, *flags, "-shared", path, "-o", os.path.join(out_dir, "lib.so")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "wkv_variants.json"))
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6.ref import wkv_scan

    if not torch.cuda.is_available():
        print("wkv_variants: needs one CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.nvidia_smi_line()
    nvcc = build.find_nvcc()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def inputs(B, S, H, C=64):
        r, k, v = (torch.randn((B, S, H, C), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        w = torch.exp(-torch.exp(0.5 * torch.randn((B, S, H, C), generator=gen,
                                                   device="cuda")))
        u = 0.5 * torch.randn((H, C), generator=gen, device="cuda")
        s0 = torch.randn((B, H, C, C), generator=gen, device="cuda")
        return (r, k, v, w, u, s0), wkv_scan(r, k, v, w, u, s0)[0]

    shapes = {"main_B1_S2048_H40": inputs(1, 2048, 40), "prefill_B2_S512_H40": inputs(2, 512, 40)}
    rows = []
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        started = {name: build_variant(nvcc, build.NVCC_FLAGS, str(build.CSRC),
                                       os.path.join(tmp, name), edits)
                   for name, (_, edits) in VARIANTS.items()}  # every nvcc at once
        for name, proc in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: nvcc failed:\n{log[-4000:]}")
            lib = ctypes.CDLL(os.path.join(tmp, name, "lib.so"))
            lib.repro_torch_wkv6.argtypes = build.SIGNATURES["repro_torch_wkv6"]
            lib.repro_torch_wkv6.restype = ctypes.c_int
            build.library = lambda lib=lib: lib
            ptxas = [line.strip() for line in log.splitlines() if "registers" in line
                     or "spill" in line]
            wkv_kernel.CHUNK = VARIANTS[name][0]  # sizes the scratch as the source does
            row = {"variant": name, "chunk": wkv_kernel.CHUNK, "card": card, "ptxas": ptxas}
            for shape, (x, y_ref) in shapes.items():
                def call(x=x):
                    return wkv_kernel.wkv_fwd(*x)

                y = call()[0]
                torch.cuda.synchronize()
                row[f"{shape}_ms"] = chip_smoke.time_ms(torch, [call], 20)
                row[f"{shape}_max_abs_err"] = (y.float() - y_ref.float()).abs().max().item()
                if shape.startswith("main"):
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(10):
                            call()
                        torch.cuda.synchronize()
                    row["main_phases_ms"] = {
                        ev.key.split("(")[0].split("<")[0].split("::")[-1]:
                            getattr(ev, "device_time_total", 0.0) / 10 / 1e3
                        for ev in prof.key_averages() if "wkv6" in ev.key}
            print(json.dumps(row), flush=True)
            rows.append(row)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
