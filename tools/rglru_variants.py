#!/usr/bin/env python3
"""K5's slab walk against variants of itself and against the kernel it
replaced, on one card: what its compiled-in choices buy, and that none of
them changes a bit.

    python3 tools/rglru_variants.py [--out FILE]

Each variant is a copy of a feed's source (and the `mma_tile.cuh` it
includes) with its constants edited — slab width (`kLruSlab`, channels a
block), tile length (`kLruTile`, time steps a stage) and ring depth
(`kLruStages`) — built alone into a library of its own, every `nvcc` at
once.  The feeds: `src/repro_torch/csrc/rglru.cu`, the shipped kernel
(cp.async, 16 B a lane), and `tools/rglru_bulk_feed.cu` (1D bulk copies and
bulk stores, one a tile row).  So is `tools/rglru_thread_per_channel.cu`, one
thread per channel, the baseline.  Each is timed at `chip_smoke.py`'s main shape
(B1 S2048 D2560, three copies of the inputs past the L2) and at every prefill
shape of the recurrent serve (B2 S512, then B1 S200..3000), whose times x
the 18 RG-LRU layers give its kernel time over that serve: CUDA events
around a CUDA graph's replay (`chip_smoke.rglru_time`), and at the main
shape also the kernel's own device time from `torch.profiler`.  Every variant's
y and h_last must equal the baseline's bit for bit on every shape, ragged
ones included (a D that is no multiple of the slab, one that is no multiple
of 4, one step); the baseline must equal the plain scan bit for bit.

Prints one JSON line per variant and writes them all to `--out` (default
`build/rglru_variants.json`, beside the kernel build).
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

BASELINE = "thread_per_channel"
SHIPPED = {"slab": 16, "tile": 64, "stages": 6}  # rglru.cu's constants
FEEDS = {"cp_async": ("rglru.cu", os.path.join(ROOT, "src", "repro_torch", "csrc")),
         "bulk": ("rglru_bulk_feed.cu", os.path.join(ROOT, "tools"))}
SMEM_LIMIT = 232448  # shared memory one block may opt into on an H100
RECURRENT_LAYERS = 18  # recurrentgemma-2b's RG-LRU blocks: one launch a prefill each
BITS_ONLY = [(1, 1, 2560), (1, 257, 2568), (3, 33, 1001), (2, 37, 300)]


def smem_bytes(slab, tile, stages) -> int:
    return stages * 2 * tile * slab * 4 + 3 * stages * 8


def variants() -> dict:
    """name: the feed and the constants' edits, over every combination the
    ring fits."""
    out = {}
    for slab, tile, stages, feed in itertools.product((8, 16, 32), (64, 128), (4, 6, 8), FEEDS):
        if smem_bytes(slab, tile, stages) > SMEM_LIMIT:
            continue
        name = f"slab{slab}_tile{tile}_stages{stages}_{feed}"
        out[name] = {"slab": slab, "tile": tile, "stages": stages, "feed": feed}
    return out


def edits(v) -> list[tuple[str, str]]:
    return [(f"constexpr int kLruSlab = {SHIPPED['slab']};",
             f"constexpr int kLruSlab = {v['slab']};"),
            (f"constexpr int kLruTile = {SHIPPED['tile']};",
             f"constexpr int kLruTile = {v['tile']};"),
            (f"constexpr int kLruStages = {SHIPPED['stages']};",
             f"constexpr int kLruStages = {v['stages']};")]


def build_variant(nvcc, flags, src_dir, out_dir, src_name, edit_list):
    os.makedirs(out_dir)
    shutil.copy(os.path.join(src_dir, src_name), os.path.join(out_dir, "rglru.cu"))
    shutil.copy(os.path.join(ROOT, "src", "repro_torch", "csrc", "mma_tile.cuh"), out_dir)
    path = os.path.join(out_dir, "rglru.cu")
    text = open(path).read()
    for old, new in edit_list:
        if text.count(old) != 1:
            raise RuntimeError(f"the text to edit is not there once: {old!r}")
        text = text.replace(old, new)
    open(path, "w").write(text)
    cmd = [nvcc, *flags, "-shared", path, "-o", os.path.join(out_dir, "lib.so")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "rglru_variants.json"))
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru import kernel as lru_kernel
    from repro_torch.kernels.rglru.ref import rglru_scan

    if not torch.cuda.is_available():
        print("rglru_variants: needs one CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.nvidia_smi_line()
    nvcc = build.find_nvcc()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    timed = {"main_B1_S2048": (1, 2048)}
    timed.update({f"serve_B{B}_S{S}": (B, S) for B, S in
                  [chip_smoke.SERVE_SOLO] + [(1, n) for n in chip_smoke.SERVE_BATCH_LENS]})
    shapes = {name: (B, S, 2560) for name, (B, S) in timed.items()}
    shapes.update({f"bits_B{B}_S{S}_D{D}": (B, S, D) for B, S, D in BITS_ONLY})
    inputs = {name: chip_smoke.rglru_inputs(torch, gen, *shape) for name, shape in shapes.items()}

    table = {BASELINE: ("rglru_thread_per_channel.cu", os.path.join(ROOT, "tools"), [], {})}
    for name, v in variants().items():
        table[name] = (*FEEDS[v["feed"]], edits(v), v)
    rows, want = [], {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        started = {name: build_variant(nvcc, build.NVCC_FLAGS, src_dir, os.path.join(tmp, name),
                                       src, edit_list)
                   for name, (src, src_dir, edit_list, _) in table.items()}  # every nvcc at once
        for name, proc in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: nvcc failed:\n{log[-4000:]}")
            lib = ctypes.CDLL(os.path.join(tmp, name, "lib.so"))
            lib.repro_torch_rglru.argtypes = build.SIGNATURES["repro_torch_rglru"]
            lib.repro_torch_rglru.restype = ctypes.c_int
            build.library = lambda lib=lib: lib
            v = table[name][3]
            row = {"variant": name, **v, "card": card,
                   "smem_bytes": smem_bytes(v["slab"], v["tile"], v["stages"]) if v else 0,
                   "ptxas": [line.strip() for line in log.splitlines()
                             if "registers" in line or "spill" in line]}
            equal = []
            for shape, (a, b, h0) in inputs.items():
                got = lru_kernel.rglru_fwd(a, b, h0)
                torch.cuda.synchronize()
                if name == BASELINE:
                    plain = rglru_scan(a, b, h0)
                    if not all(torch.equal(x, y) for x, y in zip(got, plain)):
                        raise AssertionError(f"the baseline is not the plain scan at {shape}")
                    want[shape] = got
                equal.append(all(torch.equal(x, y) for x, y in zip(got, want[shape])))
                if shape in timed:
                    row[f"{shape}_ms"] = chip_smoke.rglru_time(torch, a, b, h0)
            # the main shape twice more, for the spread between readings
            row["main_B1_S2048_ms_repeats"] = [
                chip_smoke.rglru_time(torch, *inputs["main_B1_S2048"]) for _ in range(2)]
            row["bitwise_equal_to_baseline"] = all(equal)
            a, b, h0 = inputs["main_B1_S2048"]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    lru_kernel.rglru_fwd(a, b, h0)
                torch.cuda.synchronize()
            row["main_B1_S2048_profiler_ms"] = sum(
                getattr(ev, "device_time_total", 0.0) for ev in prof.key_averages()
                if "rglru" in ev.key) / 10 / 1e3
            nbytes = chip_smoke.rglru_bytes(*shapes["main_B1_S2048"])
            row["main_gb_s"] = nbytes / row["main_B1_S2048_ms"] / 1e6
            row["serve_kernel_ms"] = RECURRENT_LAYERS * sum(
                row[f"{shape}_ms"] for shape in timed if shape.startswith("serve"))
            print(json.dumps(row), flush=True)
            rows.append(row)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    unequal = [r["variant"] for r in rows if not r["bitwise_equal_to_baseline"]]
    if unequal:
        print(f"rglru_variants: not bit for bit the baseline: {unequal}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
