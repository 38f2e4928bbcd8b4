#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, `nvcc`, and nothing from the network.  It

1. prints the card's name and power limit and the toolchain's versions;
2. builds the hand-written kernels from `src/repro_torch/csrc/`;
3. holds every kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it.  The worst error is gated relative to
   the root-mean-square of the plain version's output, bf16 within 5e-2 and
   fp32 within 1e-4 of it: the kernels and the plain versions both
   accumulate in fp32, so what is left is the order of the sums and the
   rounding of the output (one bf16 step of a value at 4x the RMS is 3e-2 of
   the RMS), while a dropped KV block moves a long-context row by more.  It
   times both, times the one-call PyTorch library function where there is
   one, and computes the least time the card could take (the roofline bound);
4. serves the launchers' reduced configuration (head_dim 16) on the card and
   checks that the attention kernels were launched there too;
5. serves full-width, full-depth yi-6b (random weights from a seed) through
   `Server.serve` and `Server.serve_batch`, checks that the launch counters
   of the three kernels moved by exactly the expected amounts and that no
   plain version ran, and compares logits with the same server woven to the
   plain (`eager`) implementations; then reads a few decode steps with
   `torch.profiler`: the device's busy and idle share of a step and the
   kernels that take most of its time.

Any failed phase ends the run with a non-zero exit code.  The last line of
the output is `{"ok": true, "device": {...}}`; the line before the card's
line is one JSON object describing every kernel.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# published peaks of one H100 SXM (dense): what `bound_ms` is computed against
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}

# worst error of a kernel case, as a share of the RMS of the plain output
BF16_TOL = 5e-2
FP32_TOL = 1e-4
# Full-depth bf16 logits of the kernel path against the plain path, as shares
# of the largest logit: the worst logit within 2e-2, the root-mean-square
# error within 1e-2 (an H100 reads 1.8e-2 and 4e-3).
LOGIT_MAX_TOL = 2e-2
LOGIT_RMS_TOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def ptxas_summary(build_log: str) -> list[str]:
    """One line per compiled kernel: registers, spills, static shared memory."""
    out, name, spills = [], "?", ""
    for line in build_log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "spill stores" in line:
            spills = line
        elif line.startswith("ptxas info") and "Used" in line:
            out.append(f"{name[:72]}: {line.split(':', 1)[1].strip()}; {spills}")
    return out


def time_ms(torch, fns, iters: int, graph: bool = False) -> float:
    """Mean device time of one call, by CUDA events around `iters` calls that
    cycle through `fns` (several copies of the inputs keep the L2 cold where
    the real caller finds it cold).  With `graph` the calls are captured into
    one CUDA graph first and the events go around its replay: for a call
    shorter than the time Python takes to issue it, that is the only way the
    events see the device's time and not the host's."""
    for fn in fns:
        fn()  # warm up
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            fns[i % len(fns)]()

    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            run()
        run = captured.replay
        run()  # warm up the replay
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(bytes_moved: float, flops: float, peak: str) -> tuple[float, str]:
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[peak] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def check_close(torch, name, got, want, rel_tol) -> tuple[float, float]:
    """Worst absolute error of `got`, gated at `rel_tol` times the
    root-mean-square of `want`; returns the error and that RMS."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: shape/dtype {got.shape} {got.dtype} vs "
                             f"{want.shape} {want.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got.float() - want.float()).abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    if not err <= rel_tol * rms:
        raise AssertionError(f"{name}: max abs error {err} exceeds {rel_tol} of the "
                             f"reference's RMS {rms}")
    return err, rms


def live_pairs(S, T, causal, window) -> int:
    """(q, k) pairs the mask keeps, for self-aligned positions."""
    total = 0
    for qp in range(S):
        hi = min(T, qp + 1) if causal else T
        lo = max(0, qp - window + 1) if (causal and window) else 0
        total += max(0, hi - lo)
    return total


def rmsnorm_cases(torch, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    cases = []
    for name, rows, d, dtype, tol, main in [
        ("decode_rows_8x4096_bf16", 8, 4096, torch.bfloat16, BF16_TOL, False),
        ("prefill_rows_2048x4096_bf16", 2048, 4096, torch.bfloat16, BF16_TOL, True),
        ("rows_100x2048_fp32", 100, 2048, torch.float32, FP32_TOL, False),
    ]:
        x = torch.randn((rows, d), generator=gen, device="cuda", dtype=torch.float32).to(dtype)
        w = 1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
        got = rmsnorm(x, w, eps=1e-6)
        want = rmsnorm_ref(x, w, eps=1e-6)
        torch.cuda.synchronize()
        err, rms = check_close(torch, name, got, want, tol)
        # a launch takes less time than Python needs to issue it, so all three
        # are timed inside a CUDA graph; four copies of the input (4 x 2 x 17 MB
        # read and written at the main shape) keep the 50 MB L2 cold
        xs = [x] + [x.clone() for _ in range(3)]
        ms = time_ms(torch, [(lambda xx=xx: rmsnorm(xx, w, eps=1e-6)) for xx in xs],
                     40, graph=True)
        plain = time_ms(torch, [(lambda xx=xx: rmsnorm_ref(xx, w, eps=1e-6)) for xx in xs],
                        20, graph=True)
        lib = None
        if hasattr(F, "rms_norm"):
            wl = w.to(dtype)
            lib = time_ms(torch, [(lambda xx=xx: F.rms_norm(xx, (d,), wl, 1e-6))
                                  for xx in xs], 40, graph=True)
        b_ms, b_by = bound(2 * rows * d * x.element_size() + 4 * d, 3 * rows * d, "fp32")
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return cases


def prefill_cases(torch, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    cases = []
    for name, S, H, K, D, dtype, kw, tol, main in [
        ("yi6b_S2048_H32_K4_D128_bf16", 2048, 32, 4, 128, torch.bfloat16, {}, BF16_TOL, True),
        ("gemma_S2048_H8_K1_D256_bf16", 2048, 8, 1, 256, torch.bfloat16, {}, BF16_TOL, False),
        ("window512_S2048_bf16", 2048, 32, 4, 128, torch.bfloat16, dict(window=512), BF16_TOL, False),
        ("softcap30_S1024_bf16", 1024, 32, 4, 128, torch.bfloat16, dict(softcap=30.0), BF16_TOL, False),
        ("ragged_S1000_bf16", 1000, 32, 4, 128, torch.bfloat16, {}, BF16_TOL, False),
        ("unpruned_S1000_bf16", 1000, 32, 4, 128, torch.bfloat16, dict(pruned=False), BF16_TOL, False),
        ("S512_H8_K2_D64_fp32", 512, 8, 2, 64, torch.float32, {}, FP32_TOL, False),
    ]:
        q = torch.randn((1, S, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, S, K, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((1, S, K, D), generator=gen, device="cuda").to(dtype)
        ref_kw = {a: b for a, b in kw.items() if a != "pruned"}
        got = flash_attention(q, k, v, causal=True, **kw)
        want = attention_ref(q, k, v, causal=True, **ref_kw)
        torch.cuda.synchronize()
        err, rms = check_close(torch, name, got, want, tol)
        ms = time_ms(torch, [lambda: flash_attention(q, k, v, causal=True, **kw)], 5)
        plain = time_ms(torch, [lambda: attention_ref(q, k, v, causal=True, **ref_kw)], 3)
        lib = None
        if "softcap" not in kw:  # one library call; it has no softcap
            qt = q.transpose(1, 2)
            G = H // K
            kt = k.transpose(1, 2).repeat_interleave(G, dim=1)
            vt = v.transpose(1, 2).repeat_interleave(G, dim=1)
            if "window" in kw:  # a boolean mask built outside the timed region
                pos = torch.arange(S, device="cuda")
                delta = pos[:, None] - pos[None]
                mask_kw = dict(attn_mask=(delta >= 0) & (delta < kw["window"]))
            else:
                mask_kw = dict(is_causal=True)
            lib = time_ms(torch, [lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **mask_kw)], 5)
            del kt, vt
        pairs = live_pairs(S, S, True, kw.get("window"))
        flops = 4.0 * D * pairs * H
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        b_ms, b_by = bound(nbytes, flops, "bf16" if dtype == torch.bfloat16 else "fp32")
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return cases


def decode_cases(torch, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_decode
    from repro_torch.kernels.flash_attention.ref import decode_ref

    def make(B, S, T, H, K, D, dtype):
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, T, K, D), generator=gen, device="cuda").to(dtype)
        return q, k, v

    def live_slots(index, S, T, window):
        out = 0
        for i in index:
            hi = max(1, min(T, i + S))
            lo = max(0, i + 1 - window) if window else 0
            out += max(0, hi - lo)
        return out

    cases = []
    B, T, H, K, D = 8, 4096, 32, 4, 128
    ragged = [199, 511, 1023, 1500, 2047, 2999, 3500, 4095]
    for name, idx, S, Tc, window, dtype, tol, main in [
        ("yi6b_B8_T4096_ragged_bf16", ragged, 1, T, None, torch.bfloat16, BF16_TOL, True),
        ("ring_T1024_wrapped_bf16", [7, 1023, 1024, 5000, 70000, 12, 900, 2048], 1, 1024,
         None, torch.bfloat16, BF16_TOL, False),
        ("window512_T4096_bf16", ragged, 1, T, 512, torch.bfloat16, BF16_TOL, False),
        ("q_span4_T4096_bf16", [i - 3 for i in ragged], 4, T, None, torch.bfloat16,
         BF16_TOL, False),
        ("unpruned_T4096_bf16", ragged, 1, T, None, torch.bfloat16, BF16_TOL, False),
        ("T1000_fp32", [0, 17, 999, 500, 63, 64, 65, 998], 1, 1000, 300, torch.float32,
         FP32_TOL, False),
    ]:
        q, k, v = make(B, S, Tc, H, K, D, dtype)
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        kw = dict(window=window, pruned=not name.startswith("unpruned"))
        got = flash_decode(q, k, v, index, **kw)
        want = decode_ref(q, k, v, index, **kw)
        torch.cuda.synchronize()
        err, rms = check_close(torch, name, got, want, tol)
        # four copies of the cache (4 x 67 MB at the main shape) so that each
        # launch finds it cold in the 50 MB L2, as a step over 32 layers does
        copies = [(k, v)] + [(k.clone(), v.clone()) for _ in range(3 if main else 0)]
        ms = time_ms(torch, [
            (lambda kk=kk, vv=vv: flash_decode(q, kk, vv, index, **kw)) for kk, vv in copies], 20)
        plain = time_ms(torch, [lambda: decode_ref(q, k, v, index, **kw)], 2)
        # one library call with a per-request boolean mask, (B, 1, S, T), built
        # outside the timed region: token s of request b sees the slots
        # kp < clip(index + s + 1, 1, T), above index + s - window if windowed
        G = H // K
        qt = q.transpose(1, 2)
        last = (index[:, None] + torch.arange(S, device="cuda"))[:, None, :, None]
        kp = torch.arange(Tc, device="cuda")
        mask = kp < (last + 1).clamp(1, Tc)
        if window is not None:
            mask = mask & (kp > last - window)
        libs = [(kk.transpose(1, 2).repeat_interleave(G, dim=1),
                 vv.transpose(1, 2).repeat_interleave(G, dim=1)) for kk, vv in copies[:2]]
        lib = time_ms(torch, [
            (lambda kk=kk, vv=vv: F.scaled_dot_product_attention(qt, kk, vv, attn_mask=mask))
            for kk, vv in libs], 10)
        del libs
        slots = live_slots(idx, S, Tc, window)
        nbytes = (slots * K * D * 2 + 2 * q.numel()) * q.element_size()
        flops = 4.0 * D * slots * S * H
        b_ms, b_by = bound(nbytes, flops, "bf16" if dtype == torch.bfloat16 else "fp32")
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        del copies

    # paged == dense, bit for bit: shuffled tables, dead pages poisoned
    q, k, v = make(B, 1, T, H, K, D, torch.bfloat16)
    index = torch.tensor(ragged, dtype=torch.int32, device="cuda")
    for name, S, window in [("paged_T4096_page128_bf16", 1, None),
                            ("paged_window512_q_span4_bf16", 4, 512)]:
        from repro_torch.kernels.flash_attention.decode import paged_decode_schedule

        qq = q if S == 1 else make(B, S, T, H, K, D, torch.bfloat16)[0]
        idx = [i - (S - 1) for i in ragged]
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        ps = 128
        nb = T // ps
        perm = torch.randperm(B * nb + 16, generator=gen, device="cuda")[:B * nb]
        tables = perm.reshape(B, nb).to(torch.int32)
        pk = torch.full((B * nb + 16, ps, K, D), float("nan"), device="cuda", dtype=torch.bfloat16)
        pv = torch.full_like(pk, float("nan"))
        pk[perm] = k.reshape(B * nb, ps, K, D)
        pv[perm] = v.reshape(B * nb, ps, K, D)
        live = set()
        host_tables = tables.cpu().tolist()
        for b, i in enumerate(idx):
            live |= {p for p, _ in paged_decode_schedule(T, i, 64, ps, host_tables[b],
                                                         window=window, q_span=S)}
        dead = torch.tensor([p for p in range(pk.shape[0]) if p not in live], device="cuda")
        pk[dead] = float("nan")
        pv[dead] = float("nan")
        dense = flash_decode(qq, k, v, index, window=window)
        paged = flash_decode(qq, pk, pv, index, window=window, tables=tables, kv_len=T)
        torch.cuda.synchronize()
        if not torch.isfinite(paged).all():
            raise AssertionError(f"{name}: a dead page reached the output")
        if not torch.equal(dense, paged):
            raise AssertionError(f"{name}: paged output differs from dense output")
        want = decode_ref(qq, pk, pv, index, window=window, tables=tables, kv_len=T)
        err, rms = check_close(torch, name, paged, want, BF16_TOL)
        ms = time_ms(torch, [lambda: flash_decode(qq, pk, pv, index, window=window,
                                                  tables=tables, kv_len=T)], 20)
        cases.append(dict(case=name, main=False, max_abs_err=err, ref_rms=rms, ms=ms, plain_ms=None,
                          bound_ms=None, bound_by=None, library_ms=None,
                          bitwise_equal_to_dense=True))
    return cases


def kernel_entry(name, source, replaces, cases, launches):
    main = next(c for c in cases if c["main"])
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_err_over_ref_rms": max(c["max_abs_err"] / c["ref_rms"] for c in cases),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "shape": main["case"],
        "cases": [{k: v for k, v in c.items() if k != "main"} for c in cases],
    }


# ---------------------------------------------------------------------------
# phase 4: serve full-width yi-6b
# ---------------------------------------------------------------------------


def profile_decode(torch, server, toks, steps: int = 4) -> dict:
    """Where one decode step's time goes: `steps` steps timed on the host's
    clock without the profiler, then the same steps under `torch.profiler`
    for the device's busy time and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    B, S = toks.shape
    logits, cache = server.prefill_vc(None, server.params, {"tokens": toks})
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    pos = S

    def run(n):
        nonlocal cache, pos
        for _ in range(n):
            positions = torch.full((B, 1), pos, dtype=torch.int32, device="cuda")
            _, cache = server.decode_vc(None, server.params,
                                        {"tokens": tok, "positions": positions}, cache)
            pos += 1
        torch.cuda.synchronize()

    run(2)  # warm up
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)

    def device_us(event):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(event, attr):
                return float(getattr(event, attr))
        return 0.0

    # kernel rows only: an operator's row repeats the time of the kernels it launched
    rows = sorted(((device_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    if busy_ms <= 0:  # the profiler saw no kernel: a reading, not a failed phase
        return {"decode_step_wall_ms_B2": wall_ms, "device_busy_ms_per_step": None,
                "device_idle_share": None, "note": "the profiler recorded no device time"}
    return {
        "decode_step_wall_ms_B2": wall_ms, "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_step": sum(r[1] for r in rows) / steps,
        "top_kernels_ms_per_step": [
            {"kernel": key[:80], "ms": us / 1e3 / steps, "calls": count / steps}
            for us, count, key in rows[:8]],
    }


def reduced_phase(torch):
    """The launchers' default: the reduced configuration (head_dim 16) on the
    card.  Woven to `"cuda"` it launches the attention kernels like any other
    width; nothing gives way to the plain attention."""
    import numpy as np

    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_decode
    from repro_torch.launch.serve import build_server
    from repro_torch.runtime.server import ServerConfig

    tokens = 4
    server = build_server("yi-6b", reduced=True, device="cuda",
                          cfg=ServerConfig(max_cache_len=32, decode_tokens=tokens))
    mcfg = server.woven.program.cfg
    before = (flash_attention.launches, flash_decode.launches)
    out = server.serve(np.random.default_rng(1).integers(0, mcfg.vocab, (2, 8), dtype=np.int32))
    got = (flash_attention.launches - before[0], flash_decode.launches - before[1])
    expected = (mcfg.num_layers, mcfg.num_layers * tokens)
    log(f"reduced: yi-6b reduced, head_dim {mcfg.head_dim}: attention launches {got}, "
        f"expected {expected}")
    if got != expected:
        raise AssertionError(f"reduced configuration: launches {got} != {expected}")
    if out.shape != (2, tokens) or out.min() < 0 or out.max() >= mcfg.vocab:
        raise AssertionError("reduced configuration: tokens of the wrong shape or range")


def serve_phase(torch):
    import numpy as np

    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_decode
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.launch.serve import build_server
    from repro_torch.core.program import Program
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.weave import default_weave
    from repro_torch.runtime.server import Server, ServerConfig

    decode_tokens = 32
    cfg = ServerConfig(max_cache_len=4096, decode_tokens=decode_tokens, seed=0)
    t0 = time.perf_counter()
    server = build_server("yi-6b", reduced=False, device="cuda", cfg=cfg)
    torch.cuda.synchronize()
    mcfg = server.woven.program.cfg
    layers = mcfg.num_layers
    n_params = sum(p.numel() for p in server.woven.program.model.parameters())
    log(f"serve: yi-6b full width: {layers} layers, d_model {mcfg.d_model}, "
        f"{n_params / 1e9:.2f} B parameters on the card in {time.perf_counter() - t0:.1f} s; "
        f"impls {server.woven.state.impls}")
    if layers != 32 or mcfg.d_model != 4096 or mcfg.vocab != 64000:
        raise AssertionError("not the published yi-6b configuration")

    rng = np.random.default_rng(0)
    solo = [rng.integers(0, mcfg.vocab, (2, 512), dtype=np.int32) for _ in range(2)]
    lens = [200, 600, 1000, 1400, 1800, 2200, 2600, 3000]
    batch = [rng.integers(0, mcfg.vocab, n).astype(np.int64) for n in lens]

    # a short warm-up outside the counted window (cuBLAS handles, the build)
    server.serve(rng.integers(0, mcfg.vocab, (1, 16), dtype=np.int32), decode_tokens=2)

    # -- the main path, counted: no plain version may run ----------------------
    def forbidden(*a, **k):
        raise AssertionError("a plain version ran on the card's main path")

    saved = (attn_ops.attention_ref, attn_ops.decode_ref, norm_ops.rmsnorm_ref)
    attn_ops.attention_ref = attn_ops.decode_ref = norm_ops.rmsnorm_ref = forbidden
    try:
        flash_attention.launches = flash_decode.launches = rmsnorm.launches = 0
        solo_out = [server.serve(p) for p in solo]
        solo_s = list(server.latencies)[-2:]
        batch_out = server.serve_batch(batch)
        batch_s = server.latencies[-1]
        counts = {"flash_attention": flash_attention.launches,
                  "flash_decode": flash_decode.launches, "rmsnorm": rmsnorm.launches}
    finally:
        attn_ops.attention_ref, attn_ops.decode_ref, norm_ops.rmsnorm_ref = saved

    prefills = len(solo) + len(batch)
    steps = decode_tokens * (len(solo) + 1)
    expected = {"flash_attention": layers * prefills, "flash_decode": layers * steps,
                "rmsnorm": (2 * layers + 1) * (prefills + steps)}
    log(f"serve: launches {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(f"launch counters {counts} != expected {expected}")
    for out in solo_out:
        if out.shape != (2, decode_tokens) or out.min() < 0 or out.max() >= mcfg.vocab:
            raise AssertionError("serve returned tokens of the wrong shape or range")
    if len(batch_out) != len(batch) or any(o.shape != (decode_tokens,) for o in batch_out):
        raise AssertionError("serve_batch returned tokens of the wrong shape")

    # -- against the same server woven to the plain implementations ------------
    program = Program.from_arch("yi-6b", kind="serve", reduced=False, device="cuda")
    eager = Server(default_weave(program, SHAPES["prefill_32k"], {}), cfg)
    if eager.woven.state.impls:
        raise AssertionError("the comparison server must run the plain implementations")
    for a, b in zip(server.woven.program.model.parameters(),
                    eager.woven.program.model.parameters()):
        if not torch.equal(a, b):
            raise AssertionError("the two servers drew different weights from one seed")

    # serving first also pins the cache length on the weave state, as every
    # `serve` call does, so the step functions below build 4096-slot caches
    eager_solo = eager.serve(solo[0])
    agree_eager = float((eager_solo == solo_out[0]).mean())
    eager_s = eager.latencies[-1]

    toks = torch.as_tensor(solo[0], device="cuda")
    results = {}
    tok = None
    for tag, srv in (("cuda", server), ("eager", eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = srv.prefill_vc(None, srv.params, {"tokens": toks})
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        if tok is None:  # both paths decode the same token
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        pos = torch.full((2, 1), toks.shape[1], dtype=torch.int32, device="cuda")
        logits2, cache = srv.decode_vc(None, srv.params, {"tokens": tok, "positions": pos}, cache)
        torch.cuda.synchronize()
        results[tag] = (logits.float(), logits2.float(), ttft)
        del cache
    report = {}
    for i, what in enumerate(("prefill", "first_decode")):
        a, b = results["cuda"][i], results["eager"][i]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{what} logits are not finite")
        if a.shape != b.shape or a.shape[-1] != mcfg.vocab:
            raise AssertionError(f"{what} logits have shape {a.shape}")
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        rms = (a - b).pow(2).mean().sqrt().item()
        report[what] = {"max_abs_err": err, "rms_err": rms, "logit_scale": scale}
        log(f"serve: {what} logits, cuda vs eager: max abs error {err}, rms {rms}, "
            f"at scale {scale}")
        if not (err <= LOGIT_MAX_TOL * scale and rms <= LOGIT_RMS_TOL * scale):
            raise AssertionError(f"{what} logits differ by {err} (rms {rms}) at scale {scale}")

    del eager
    torch.cuda.empty_cache()
    log("profile " + json.dumps(profile_decode(torch, server, toks)))
    solo_again = [server.serve(p[None].astype(np.int32))[0] for p in batch[:2]]
    agree_batch = float(np.mean([(a == b).mean() for a, b in zip(solo_again, batch_out[:2])]))

    ttft_ms = results["cuda"][2] * 1e3
    per_tok = (solo_s[1] * 1e3 - ttft_ms) / decode_tokens
    summary = {
        "model": "yi-6b", "layers": layers, "params_b": n_params / 1e9,
        "launches": counts, "logits_vs_eager": report,
        "token_agreement_vs_eager": agree_eager,
        "token_agreement_batch_vs_solo": agree_batch,
        "ttft_ms_B2_S512": ttft_ms, "eager_ttft_ms_B2_S512": results["eager"][2] * 1e3,
        "solo_serve_s_B2_S512_N32": solo_s, "eager_solo_serve_s": eager_s,
        "decode_ms_per_token_B2": per_tok,
        "batch_serve_s_B8_N32": batch_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("serve " + json.dumps(summary))
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs one card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = nvidia_smi_line()
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-2]
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {nvcc.strip()}")
    log(f"env: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB, "
        f"{torch.cuda.device_count()} device(s)")

    lib_path, seconds = build.build()
    build.library()
    log(f"build: {os.path.relpath(lib_path, HERE)} in {seconds:.1f} s (set-up)")
    for line in ptxas_summary(build.build_log()):
        log("build: " + line)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    norm = rmsnorm_cases(torch, gen)
    pre = prefill_cases(torch, gen)
    dec = decode_cases(torch, gen)
    for c in norm + pre + dec:
        log("kernel-case " + json.dumps({k: v for k, v in c.items() if k != "main"}))

    reduced_phase(torch)
    counts = serve_phase(torch)

    kernels = [
        kernel_entry("flash_attention", "src/repro_torch/csrc/flash_prefill.cu",
                     "src/repro/kernels/flash_attention/kernel.py:490", pre,
                     counts["flash_attention"]),
        kernel_entry("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/decode.py:454", dec,
                     counts["flash_decode"]),
        kernel_entry("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
                     "src/repro/kernels/rmsnorm/kernel.py:37", norm, counts["rmsnorm"]),
    ]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
