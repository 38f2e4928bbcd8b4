#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, `nvcc`, and nothing from the network.  It

1. prints the card's name and power limit and the toolchain's versions;
2. builds the hand-written kernels from `src/repro_torch/csrc/`;
3. holds every kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it (the WKV kernel at the reference test's
   own scale-aware tolerance, see `wkv_cases`).  The worst error is gated relative to
   the root-mean-square of the plain version's output, bf16 within 5e-2 and
   fp32 within 1e-4 of it: the kernels and the plain versions both
   accumulate in fp32, so what is left is the order of the sums and the
   rounding of the output (one bf16 step of a value at 4x the RMS is 3e-2 of
   the RMS), while a dropped KV block moves a long-context row by more.  It
   times both, times the one-call PyTorch library function where there is
   one, and computes the least time the card could take (the roofline bound).
   The quantized mode of flash decode (int8 / fp8 pages with fp32 scales) is
   held to its plain version, to the dense layout of the same codes bit for
   bit, and to flash decode over the bf16 values it quantizes;
4. serves the launchers' reduced configuration (head_dim 16) on the card and
   checks that the attention kernels were launched there too;
5. serves full-width, full-depth yi-6b (random weights from a seed) through
   `Server.serve` and `Server.serve_batch`, checks that the launch counters
   of the three kernels moved by exactly the expected amounts and that no
   plain version ran, and compares logits with the same server woven to the
   plain (`eager`) implementations; then reads a few decode steps with
   `torch.profiler`: the device's busy and idle share of a step and the
   kernels that take most of its time;
6. serves the same model through the main path proper, `serve_continuous`
   and `serve_stream` over the paged pool — a bf16 and an int8 pool, prefix
   sharing on and off, chunked prefill — with exact launch counts, and
   profiles one continuous wave at batch 8 (`continuous_phase`);
7. serves full-width, full-depth recurrentgemma-2b (RG-LRU kernel K5, and
   the attention and RMSNorm kernels over its local-attention rings) and
   rwkv6-3b (WKV kernel K6) through `serve` and `serve_batch`, with exact
   launch counts, no K5 / K6 launch in decode, the logit gates against the
   plain implementations, and a decode-step profile each
   (`recurrent_phase`);
8. trains full-width, full-depth gemma-2b (random weights from seed 0,
   global batch 4 x 1024 in two microbatches, remat `full`, six steps)
   through the training launcher's builder — the attention through K1 with
   its `lse` output and the fused backward K3, held to their plain versions
   with the other kernels in step 3 — with exact launch counts per step, a
   falling loss, one gradient against the same model woven to the plain
   attention, step time, tokens/s, MFU, peak memory and the device's busy
   share of a step; then a checkpoint resume at the reduced configuration
   (`train_phase`).

Any failed phase ends the run with a non-zero exit code.  The last line of
the output is `{"ok": true, "device": {...}}`; the line before the card's
line is one JSON object describing every kernel.
"""

from __future__ import annotations

import gc
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
# K2 over an int8 pool against K2 over the bf16 values it quantizes: worst
# absolute error (the reference's bound for int8, benchmarks/quantized_cache.py
# :53; fp8's error is printed, as the reference keeps it a tuning column)
QUANT_VS_FP_TOL = 0.05
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
        # recurrentgemma-2b's local attention: G = 10, window 2048, a prompt past it
        ("rgemma_S3000_H10_K1_D256_w2048_bf16", 3000, 10, 1, 256, torch.bfloat16,
         dict(window=2048), BF16_TOL, False),
        ("window512_S2048_bf16", 2048, 32, 4, 128, torch.bfloat16, dict(window=512), BF16_TOL, False),
        ("softcap30_S1024_bf16", 1024, 32, 4, 128, torch.bfloat16, dict(softcap=30.0), BF16_TOL, False),
        ("ragged_S1000_bf16", 1000, 32, 4, 128, torch.bfloat16, {}, BF16_TOL, False),
        ("unpruned_S1000_bf16", 1000, 32, 4, 128, torch.bfloat16, dict(pruned=False), BF16_TOL, False),
        ("S512_H8_K2_D64_fp32", 512, 8, 2, 64, torch.float32, {}, FP32_TOL, False),
        # the int8 pool's first prefill: bf16 q over the dequantized fp32 K/V
        ("fp32_kv_S1024_bf16", 1024, 32, 4, 128, (torch.bfloat16, torch.float32), {},
         BF16_TOL, False),
    ]:
        dtype, kv_dtype = dtype if isinstance(dtype, tuple) else (dtype, dtype)
        q = torch.randn((1, S, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, S, K, D), generator=gen, device="cuda").to(kv_dtype)
        v = torch.randn((1, S, K, D), generator=gen, device="cuda").to(kv_dtype)
        ref_kw = {a: b for a, b in kw.items() if a != "pruned"}
        got = flash_attention(q, k, v, causal=True, **kw)
        want = attention_ref(q, k, v, causal=True, **ref_kw)
        torch.cuda.synchronize()
        err, rms = check_close(torch, name, got, want, tol)
        ms = time_ms(torch, [lambda: flash_attention(q, k, v, causal=True, **kw)], 5)
        plain = time_ms(torch, [lambda: attention_ref(q, k, v, causal=True, **ref_kw)], 3)
        lib = None
        # one library call; it has no softcap and takes one dtype
        if "softcap" not in kw and kv_dtype == dtype:
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
        nbytes = 2 * q.numel() * q.element_size() + (k.numel() + v.numel()) * k.element_size()
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
    yi, rg = (H, K, D), (10, 1, 256)  # yi-6b; recurrentgemma-2b's MQA, G = 10
    for name, idx, S, Tc, window, dtype, tol, main, (Hc, Kc, Dc) in [
        ("yi6b_B8_T4096_ragged_bf16", ragged, 1, T, None, torch.bfloat16, BF16_TOL, True, yi),
        ("ring_T1024_wrapped_bf16", [7, 1023, 1024, 5000, 70000, 12, 900, 2048], 1, 1024,
         None, torch.bfloat16, BF16_TOL, False, yi),
        ("window512_T4096_bf16", ragged, 1, T, 512, torch.bfloat16, BF16_TOL, False, yi),
        ("q_span4_T4096_bf16", [i - 3 for i in ragged], 4, T, None, torch.bfloat16,
         BF16_TOL, False, yi),
        ("unpruned_T4096_bf16", ragged, 1, T, None, torch.bfloat16, BF16_TOL, False, yi),
        ("T1000_fp32", [0, 17, 999, 500, 63, 64, 65, 998], 1, 1000, 300, torch.float32,
         FP32_TOL, False, yi),
        # recurrentgemma-2b's decode: per-request index over ring caches of
        # its window (the serve_batch prompts of 200..3000 tokens, 32 steps on)
        ("rgemma_ring_T2048_H10_K1_D256_bf16", [231, 631, 1031, 1431, 1831, 2231, 2631, 3031],
         1, 2048, None, torch.bfloat16, BF16_TOL, False, rg),
    ]:
        q, k, v = make(B, S, Tc, Hc, Kc, Dc, dtype)
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
        G = Hc // Kc
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
        nbytes = (slots * Kc * Dc * 2 + 2 * q.numel()) * q.element_size()
        flops = 4.0 * Dc * slots * S * Hc
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


def quantized_decode_cases(torch, gen):
    """K2d: flash decode over int8 / fp8 codes with fp32 per-page scales, at
    the K2 main case's shapes.  Each case is held against its plain version;
    besides, a paged pool and a dense cache of the same codes and scales must
    agree bit for bit (shuffled tables, dead pages poisoned), and the int8
    output must stay within 0.05 of K2 over the bf16 values it quantizes
    (the reference's bound, benchmarks/quantized_cache.py:53)."""
    from repro_torch.kernels.flash_attention.decode import paged_decode_schedule
    from repro_torch.kernels.flash_attention.ops import (
        flash_decode,
        kv_scale_from_absmax,
        quantize_kv_write,
        resolve_cache_dtype,
    )
    from repro_torch.kernels.flash_attention.ref import decode_ref

    B, T, H, K, D, ps = 8, 4096, 32, 4, 128, 128
    nb = T // ps
    ragged = [199, 511, 1023, 1500, 2047, 2999, 3500, 4095]

    def quantize(x, dt):
        """(B, T, K, D) values -> codes and their (B, NP, K) page scales."""
        pages = x.float().reshape(B, nb, ps, K, D)
        scale = kv_scale_from_absmax(pages.abs().amax(dim=(2, 4)), dt)
        return quantize_kv_write(pages, scale[:, :, None, :], dt).reshape(B, T, K, D), scale

    def to_pool(kc, ks, vc, vs, live_of):
        """The same codes and scales as a shuffled page pool; every page that
        no request's schedule names holds NaN scales and garbage codes.  The
        pool is assembled through an int8 view (bytes are bytes)."""
        P = B * nb + 16
        perm = torch.randperm(P, generator=gen, device="cuda")[:B * nb]
        tables = perm.reshape(B, nb).to(torch.int32)
        live = live_of(tables.cpu().tolist())
        dead = torch.tensor([p for p in range(P) if p not in live], device="cuda")
        out = []
        for codes, scale in ((kc, ks), (vc, vs)):
            pool = torch.full((P, ps, K, D), 0x7f, device="cuda", dtype=torch.int8)
            sc = torch.full((P, K), float("nan"), device="cuda")
            pool[perm] = codes.view(torch.int8).reshape(B * nb, ps, K, D)
            sc[perm] = scale.reshape(B * nb, K)
            sc[dead] = float("nan")
            out += [pool.view(codes.dtype), sc]
        return (*out, tables)

    cases = []
    k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    for name, dtype_name, S, main in [
        ("paged_int8_T4096_page128", "int8", 1, True),
        ("paged_float8_e4m3fn_T4096_page128", "float8_e4m3fn", 1, False),
        ("paged_int8_q_span4_T4096_page128", "int8", 4, False),
    ]:
        dt = resolve_cache_dtype(dtype_name)
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        idx = [i - (S - 1) for i in ragged]
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        kc, ks = quantize(k, dt)
        vc, vs = quantize(v, dt)

        def live_of(host_tables):
            live = set()
            for b, i in enumerate(idx):
                live |= {p for p, _ in paged_decode_schedule(T, i, 64, ps, host_tables[b],
                                                             q_span=S)}
            return live

        pk, pks, pv, pvs, tables = to_pool(kc, ks, vc, vs, live_of)
        kw = dict(tables=tables, kv_len=T, k_scale=pks, v_scale=pvs)
        got = flash_decode(q, pk, pv, index, **kw)
        dense = flash_decode(q, kc, vc, index, k_scale=ks, v_scale=vs, scale_page=ps)
        want = decode_ref(q, pk, pv, index, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: a dead page reached the output")
        if not torch.equal(got, dense):
            raise AssertionError(f"{name}: paged output differs from dense output")
        err, rms = check_close(torch, name, got, want, BF16_TOL)
        # against K2 over the bf16 values the codes quantize
        fp = flash_decode(q, k, v, index)
        vs_fp = (got.float() - fp.float()).abs().max().item()
        if dtype_name == "int8" and not vs_fp <= QUANT_VS_FP_TOL:
            raise AssertionError(f"{name}: {vs_fp} from the bf16 cache's output "
                                 f"(bound {QUANT_VS_FP_TOL})")
        ms = time_ms(torch, [lambda: flash_decode(q, pk, pv, index, **kw)], 20)
        plain = time_ms(torch, [lambda: decode_ref(q, pk, pv, index, **kw)], 2)
        slots = sum(max(0, max(1, min(T, i + S))) for i in idx)
        pages = sum(-(-max(1, min(T, i + S)) // ps) for i in idx)
        nbytes = (slots * K * D * 2 * pk.element_size() + pages * K * 2 * 4
                  + 2 * q.numel() * q.element_size())
        b_ms, b_by = bound(nbytes, 4.0 * D * slots * S * H, "bf16")
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                          bitwise_equal_to_dense=True, max_abs_err_vs_bf16_cache=vs_fp))
        del pk, pv, kc, vc

    # a dense int8 cache, one scale row per 128 slots
    dt = torch.int8
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    index = torch.tensor(ragged, dtype=torch.int32, device="cuda")
    kc, ks = quantize(k, dt)
    vc, vs = quantize(v, dt)
    kw = dict(k_scale=ks, v_scale=vs, scale_page=ps)
    got = flash_decode(q, kc, vc, index, **kw)
    want = decode_ref(q, kc, vc, index, **kw)
    torch.cuda.synchronize()
    err, rms = check_close(torch, "dense_int8_scale_page128", got, want, BF16_TOL)
    ms = time_ms(torch, [lambda: flash_decode(q, kc, vc, index, **kw)], 20)
    cases.append(dict(case="dense_int8_scale_page128", main=False, max_abs_err=err,
                      ref_rms=rms, ms=ms, plain_ms=None, bound_ms=None, bound_by=None,
                      library_ms=None))
    return cases


def shared_prefill_identity(torch, gen) -> dict:
    """The design property behind "a prefix-shared admission serves the same
    tokens as an unshared one": the prefill kernel over a whole prompt and
    the widened-q decode kernel over its suffix, against the prefix resident
    in a shuffled page pool, walk the same 64-slot blocks with the same
    online softmax — so the suffix rows agree bit for bit.  Checked at yi-6b's
    shapes (prefix 1024, suffix 200), over a bf16 pool and an int8 pool (the
    prefill kernel then reads the dequantized fp32 values, as the first
    prefill of a quantized pool does)."""
    from repro_torch.kernels.flash_attention.ops import (
        dequantize_kv,
        flash_attention,
        flash_decode,
    )
    from repro_torch.runtime.pages import build_linear_pool, quantize_linear_pool

    P, S, H, K, D = 1024, 1224, 32, 4, 128
    q = torch.randn((1, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((S, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((S, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    pk, pv, tables, _ = build_linear_pool([k], [v], 128, max_len=S, num_pages=24)
    index = torch.tensor([P], dtype=torch.int32, device="cuda")
    out = {}
    for pool in ("bf16", "int8"):
        if pool == "bf16":
            kk, vv, kw = k[None], v[None], {}
            ck, cv = pk, pv
        else:
            ck, cv, ksc, vsc = quantize_linear_pool(pk, pv, "int8")
            kw = dict(k_scale=ksc, v_scale=vsc)
            kk = dequantize_kv(ck, ksc[:, None, :]).reshape(-1, K, D)[None, :S]
            vv = dequantize_kv(cv, vsc[:, None, :]).reshape(-1, K, D)[None, :S]
        full = flash_attention(q, kk, vv, causal=True)
        suffix = flash_decode(q[:, P:], ck, cv, index, tables=tables, kv_len=S, **kw)
        torch.cuda.synchronize()
        if not torch.equal(full[:, P:], suffix):
            diff = (full[:, P:].float() - suffix.float()).abs().max().item()
            raise AssertionError(f"{pool} pool: suffix-over-prefix rows differ from the "
                                 f"whole-prompt prefill by up to {diff}")
        out[f"{pool}_pool_suffix_rows_bitwise_equal"] = True
    return out


def rglru_cases(torch, gen):
    """K5: the RG-LRU scan against its plain version, fp32 with a nonzero
    initial state.  The kernel repeats the plain version's two roundings per
    step, so the two agree bit for bit (printed); gated at the fp32 bound."""
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rglru.ref import rglru_scan

    cases = []
    for name, B, S, D, main in [("rgemma_B1_S2048_D2560_fp32", 1, 2048, 2560, True),
                                ("B1_S17_D2560_fp32", 1, 17, 2560, False),
                                ("B2_S1000_D2560_fp32", 2, 1000, 2560, False)]:
        a = torch.rand((B, S, D), generator=gen, device="cuda")
        b = torch.randn((B, S, D), generator=gen, device="cuda")
        h0 = torch.randn((B, D), generator=gen, device="cuda")
        y, h_last = rglru(a, b, h0)
        y_ref, h_ref = rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        err, rms = check_close(torch, name, y, y_ref, FP32_TOL)
        check_close(torch, name + "/h_last", h_last, h_ref, FP32_TOL)
        # two copies: 2 x 63 MB read and written, past the 50 MB L2
        copies = [(a, b)] + [(a.clone(), b.clone()) for _ in range(1 if main else 0)]
        ms = time_ms(torch, [(lambda aa=aa, bb=bb: rglru(aa, bb, h0)) for aa, bb in copies], 20)
        plain = time_ms(torch, [lambda: rglru_scan(a, b, h0)], 1)
        b_ms, b_by = bound(4 * (3 * B * S * D + 2 * B * D), 2.0 * B * S * D, "fp32")
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                          bitwise_equal=bool(torch.equal(y, y_ref) and torch.equal(h_last, h_ref))))
        del copies
    return cases


def wkv_cases(torch, gen):
    """K6: the WKV recurrence against its plain version, bf16 r / k / v, fp32
    decays and a nonzero fp32 initial state; a ragged length and strong decays
    (w = exp(-exp(3 N(0,1)))) besides the main case.  Gated at the reference
    test's own scale-aware tolerance (tests/test_kernels.py, TestWKV6):
    rtol 5e-3, atol 5e-3 (max |y| + 1) for y, 5e-3 for the last state."""
    from repro_torch.kernels.rwkv6.ops import wkv
    from repro_torch.kernels.rwkv6.ref import wkv_scan

    cases = []
    for name, B, S, H, decay, main in [("rwkv6_B1_S2048_H40_C64_bf16", 1, 2048, 40, 0.5, True),
                                       ("ragged_B2_S1000_H40_C64_bf16", 2, 1000, 40, 0.5, False),
                                       ("strong_decay_B1_S512_H40_C64_bf16", 1, 512, 40, 3.0,
                                        False)]:
        C = 64
        r, k, v = (torch.randn((B, S, H, C), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        w = torch.exp(-torch.exp(decay * torch.randn((B, S, H, C), generator=gen, device="cuda")))
        u = 0.5 * torch.randn((H, C), generator=gen, device="cuda")
        s0 = torch.randn((B, H, C, C), generator=gen, device="cuda")
        y, s_last = wkv(r, k, v, w, u, s0)
        y_ref, s_ref = wkv_scan(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        if y.shape != y_ref.shape or y.dtype != y_ref.dtype or s_last.dtype != torch.float32:
            raise AssertionError(f"{name}: output {y.shape} {y.dtype} {s_last.dtype}")
        if not (torch.isfinite(y.float()).all() and torch.isfinite(s_last).all()):
            raise AssertionError(f"{name}: kernel output is not finite")
        scale = y_ref.float().abs().max().item() + 1.0
        dy = (y.float() - y_ref.float()).abs()
        ds = (s_last - s_ref).abs()
        if not (bool((dy <= 5e-3 * scale + 5e-3 * y_ref.float().abs()).all())
                and bool((ds <= 5e-3 + 5e-3 * s_ref.abs()).all())):
            raise AssertionError(f"{name}: y off by {dy.max().item()} at scale {scale}, "
                                 f"state off by {ds.max().item()}")
        err, rms = dy.max().item(), y_ref.float().pow(2).mean().sqrt().item()
        ms = time_ms(torch, [lambda: wkv(r, k, v, w, u, s0)], 10)
        plain = time_ms(torch, [lambda: wkv_scan(r, k, v, w, u, s0)], 1)
        nbytes = B * S * H * C * (3 * 2 + 4 + 2) + 4 * H * C + 2 * 4 * B * H * C * C
        flops = B * S * H * (5.0 * C * C + 4.0 * C)
        b_ms, b_by = bound(nbytes, flops, "fp32")
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                          max_abs_err_state=ds.max().item(), y_scale=scale))
    return cases


def flash_bwd_cases(torch, gen):
    """K1's lse mode and the two passes of K3, at the training path's shapes
    (gemma-2b's microbatch is the main case) and at yi-6b's, a window, a
    softcap, a ragged length and fp32.  Each case runs K1 with lse on
    random q / k / v, holds out and lse to the plain forward, then runs K3
    on those residuals and a random dO and holds dq, dk, dv to the plain
    backward on the same residuals — every output within the forward cases'
    gates.  Timed: K1 with lse; each pass alone (pass 1 also writes delta;
    pass 2 reads it) and both together, as training launches them; the
    plain forward and backward; and, in the causal cases without a window
    or softcap, the one-call library backward (SDPA's, through
    `torch.autograd.grad`).  Bounds: K1 four flops per D per live pair and
    head; pass 1 three products of 2 D (QK^T, dO V^T, dS K), pass 2 four
    (QK^T, dO V^T, P^T dO, dS^T Q), the pair five, each against the bytes
    it must read and write."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_ref, flash_attention_bwd_ref

    lse_cases, dq_cases, dkv_cases = [], [], []
    for name, B, S, H, K, D, dtype, kw, tol, main in [
        ("gemma_B2_S1024_H8_K1_D256_bf16", 2, 1024, 8, 1, 256, torch.bfloat16, {},
         BF16_TOL, True),
        ("yi6b_B1_S2048_H32_K4_D128_bf16", 1, 2048, 32, 4, 128, torch.bfloat16, {},
         BF16_TOL, False),
        ("window512_S2048_bf16", 1, 2048, 32, 4, 128, torch.bfloat16, dict(window=512),
         BF16_TOL, False),
        ("softcap30_S1024_bf16", 1, 1024, 32, 4, 128, torch.bfloat16, dict(softcap=30.0),
         BF16_TOL, False),
        ("ragged_S1000_bf16", 1, 1000, 32, 4, 128, torch.bfloat16, {}, BF16_TOL, False),
        ("S512_H8_K2_D64_fp32", 1, 512, 8, 2, 64, torch.float32, {}, FP32_TOL, False),
    ]:
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, K, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, K, D), generator=gen, device="cuda").to(dtype)
        do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        out, lse = fa_kernel.flash_attention_fwd(q, k, v, causal=True, return_lse=True, **kw)
        want_out, want_lse = attention_ref(q, k, v, causal=True, return_lse=True, **kw)
        torch.cuda.synchronize()
        err, rms = check_close(torch, name + " out", out, want_out, tol)
        err_lse, rms_lse = check_close(torch, name + " lse", lse, want_lse, tol)
        got = flash_attention_bwd(q, k, v, out, lse, do, causal=True, **kw)
        want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True, **kw)
        torch.cuda.synchronize()
        errs = {g: check_close(torch, f"{name} {g}", a, b, tol)
                for g, a, b in zip(("dq", "dk", "dv"), got, want)}

        peak = "bf16" if dtype == torch.bfloat16 else "fp32"
        pairs = live_pairs(S, S, True, kw.get("window")) * B
        el = q.element_size()
        qbytes, kvbytes, stat = q.numel() * el, k.numel() * el, B * H * S * 4
        ms_fwd = time_ms(torch, [lambda: fa_kernel.flash_attention_fwd(
            q, k, v, causal=True, return_lse=True, **kw)], 5)
        ms_no_lse = time_ms(torch, [lambda: fa_kernel.flash_attention_fwd(
            q, k, v, causal=True, **kw)], 5)
        plain_fwd = time_ms(torch, [lambda: attention_ref(
            q, k, v, causal=True, return_lse=True, **kw)], 3)
        delta = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        run_pass = lambda p: fa_kernel.flash_attention_bwd(
            q, k, v, out, lse, do, causal=True, passes=p, delta=delta, **kw)
        ms_dq = time_ms(torch, [lambda: run_pass(1)], 5)
        ms_dkv = time_ms(torch, [lambda: run_pass(2)], 5)  # delta from pass 1
        ms_pair = time_ms(torch, [lambda: run_pass(3)], 5)
        plain_bwd = time_ms(torch, [lambda: flash_attention_bwd_ref(
            q, k, v, out, lse, do, causal=True, **kw)], 3)
        lib_fwd = lib_bwd = None
        if not kw:  # one library call: causal, no window, no softcap
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            lib_fwd = time_ms(torch, [lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)], 5)
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            dot = do.transpose(1, 2)
            lib_bwd = time_ms(torch, [lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dot, retain_graph=True)], 5)
            del qt, kt, vt, ot
        no_lib = None if not kw else "SDPA takes no sliding window or softcap in one call"
        b_ms, b_by = bound(2 * qbytes + 2 * kvbytes + stat, 4.0 * D * pairs * H, peak)
        lse_cases.append(dict(case=name, main=main, max_abs_err=max(err, err_lse),
                              ref_rms=rms, max_abs_err_lse=err_lse, ref_rms_lse=rms_lse,
                              ms=ms_fwd, ms_without_lse=ms_no_lse, plain_ms=plain_fwd,
                              bound_ms=b_ms, bound_by=b_by, library_ms=lib_fwd,
                              library_ms_note=no_lib))
        pair_b, pair_by = bound(3 * qbytes + 2 * kvbytes + stat + qbytes + 2 * kvbytes,
                                10.0 * D * pairs * H, peak)
        both = dict(ms_both_passes=ms_pair, bound_ms_both_passes=pair_b,
                    bound_by_both_passes=pair_by, plain_ms_note=(
                        "the plain backward computes dq, dk and dv together"),
                    library_ms_note=no_lib or "the library backward gives dq, dk and dv together")
        # pass 1 reads q, k, v, o, dO, lse and writes dq and delta
        b1, by1 = bound(3 * qbytes + 2 * kvbytes + 2 * stat + qbytes, 6.0 * D * pairs * H, peak)
        dq_cases.append(dict(case=name, main=main, max_abs_err=errs["dq"][0],
                             ref_rms=errs["dq"][1], ms=ms_dq, plain_ms=plain_bwd,
                             bound_ms=b1, bound_by=by1, library_ms=lib_bwd, **both))
        # pass 2 reads q, k, v, dO, lse, delta and writes dk and dv
        b2, by2 = bound(2 * qbytes + 2 * kvbytes + 2 * stat + 2 * kvbytes,
                        8.0 * D * pairs * H, peak)
        worse = max(errs["dk"], errs["dv"], key=lambda e: e[0] / e[1])
        dkv_cases.append(dict(case=name, main=main,
                              max_abs_err=worse[0], ref_rms=worse[1],
                              max_abs_err_dk=errs["dk"][0], ref_rms_dk=errs["dk"][1],
                              max_abs_err_dv=errs["dv"][0], ref_rms_dv=errs["dv"][1],
                              ms=ms_dkv, plain_ms=plain_bwd, bound_ms=b2, bound_by=by2,
                              library_ms=lib_bwd, **both))
        del q, k, v, do, out, lse, got, want, want_out, want_lse, delta
        torch.cuda.empty_cache()
    return lse_cases, dq_cases, dkv_cases


def kernel_entry(name, source, replaces, cases, launches, launches_by_run):
    main = next(c for c in cases if c["main"])
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "launches_by_run": launches_by_run,
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


def profile_wave(torch, gen, batch: int) -> tuple[dict, dict]:
    """Where one continuous wave's time goes: `gen` (a `serve_stream`
    generator) has just yielded a wave's closing event, so the next `next()`
    runs the following wave whole and yields its first event only after the
    wave's tokens are on the host (the device is done).  That call runs under
    `torch.profiler`; returns the event and the reading."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        first = next(gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((_device_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    return first, {
        "wave": first["wave"], "batch_before": batch, "wave_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms > 0 else None,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms > 0 else None,
        "device_launches_per_wave": sum(r[1] for r in rows),
        "top_kernels_ms": [{"kernel": key[:80], "ms": us / 1e3, "calls": count}
                           for us, count, key in rows[:8]],
    }


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def continuous_phase(torch, server) -> dict:
    """The main path proper, at full width and depth: `serve_continuous` and
    `serve_stream` over the paged pool, with a bf16 and an int8 pool.

    Traffic: ten requests of 32 greedy tokens, max_batch 8.  Eight share a
    1024-token system prefix, with distinct suffixes of 64..1024 tokens; the
    last two are one identical prompt (the prefix and 100 more tokens).  Six
    arrive at wave 0, two at wave 2 (admitted into the running batch), the
    identical pair at wave 4: it waits for the first six to retire and is
    admitted beside the two still decoding — a prefix-shared suffix prefill,
    then a full-prompt re-score whose first decode write splits the shared
    tail page copy-on-write.

    Runs: (a) bf16 pool, sharing on; (b) sharing off; (c) int8 pool, sharing
    on, twice; (d) (a) through `serve_stream` with prefill_chunk 512, its
    tenth wave (eight decoding) profiled; and the prompts through
    `serve_batch`; then `sharing_diagnostic`.  Gates: every outcome ok; tokens in range; each kernel's
    launch counter moved by exactly what the server's own step counts say,
    with no plain version run; (c) gives the same tokens twice; the int8
    pool's peak bytes at most 0.55x the bf16 pool's; prefix hits >= 8 in
    (a) and none in (b).  Printed, not gated: token agreement between runs,
    wall time, TTFT and the largest gap per request, peak memory."""
    import numpy as np

    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_decode
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    mcfg = server.woven.program.cfg
    layers, n = mcfg.num_layers, server.cfg.decode_tokens
    rng = np.random.default_rng(1)
    system = rng.integers(0, mcfg.vocab, 1024)
    suffixes = [64, 200, 330, 460, 600, 730, 860, 1024]
    prompts = [np.concatenate([system, rng.integers(0, mcfg.vocab, s)]) for s in suffixes]
    twin = np.concatenate([system, rng.integers(0, mcfg.vocab, 100)])
    prompts += [twin, twin.copy()]
    arrivals = [0] * 6 + [2, 2, 4, 4]
    kw = dict(max_batch=8, page_size=128, arrival_waves=arrivals)

    def forbidden(*a, **k):
        raise AssertionError("a plain version ran on the card's main path")

    def counted(fn):
        """Run `fn` with the launch counters at 0 and no plain version."""
        saved = (attn_ops.attention_ref, attn_ops.decode_ref, norm_ops.rmsnorm_ref)
        attn_ops.attention_ref = attn_ops.decode_ref = norm_ops.rmsnorm_ref = forbidden
        flash_attention.launches = flash_decode.launches = rmsnorm.launches = 0
        flash_decode.quantized_launches = 0
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            attn_ops.attention_ref, attn_ops.decode_ref, norm_ops.rmsnorm_ref = saved
        return out, wall, {"flash_attention": flash_attention.launches,
                           "flash_decode": flash_decode.launches,
                           "flash_decode_quantized": flash_decode.quantized_launches,
                           "rmsnorm": rmsnorm.launches}

    def check_run(tag, out, counts, quantized):
        bad = [o for o in server.last_outcomes if o["status"] != "ok"]
        if bad or len(out) != len(prompts):
            raise AssertionError(f"{tag}: outcomes {bad}")
        for o in out:
            if o.shape != (n,) or o.min() < 0 or o.max() >= mcfg.vocab:
                raise AssertionError(f"{tag}: tokens of the wrong shape or range")
        st = server.last_step_counts
        calls = sum(st.values())
        k2 = layers * (st["decode"] + st["suffix_prefill"] + st["rescore"])
        want = {"flash_attention": layers * (st["probe"] + st["prefill"]),
                "flash_decode": k2, "flash_decode_quantized": k2 if quantized else 0,
                "rmsnorm": (2 * layers + 1) * calls}
        log(f"continuous {tag}: launches {counts}, expected {want} from steps {st}")
        if counts != want:
            raise AssertionError(f"{tag}: launch counters {counts} != expected {want}")

    runs, report = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for tag, share, dtype in (("a_bf16_shared", True, None), ("b_bf16_unshared", False, None),
                              ("c_int8_shared", True, "int8"), ("c_int8_shared_again", True, "int8")):
        server.cfg.cache_dtype = dtype
        try:
            out, wall, counts = counted(lambda: server.serve_continuous(
                prompts, prefix_sharing=share, **kw))
        finally:
            server.cfg.cache_dtype = None
        check_run(tag, out, counts, dtype is not None)
        runs[tag] = out
        report[tag] = {"wall_s": wall, "launches": counts, "steps": server.last_step_counts,
                       "pool": server.last_pool_stats,
                       "ttft_s": [o["ttft_s"] for o in server.last_outcomes],
                       "tok_gap_max_s": [o["tok_gap_max_s"] for o in server.last_outcomes],
                       "decode_step_s_mean": float(np.mean(server.decode_step_latencies))}

    # (d): the event loop itself, chunked; its tenth wave (batch 8, every
    # prompt resident by then) runs under the profiler
    events, profiled = [], {}

    def stream():
        gen = server.serve_stream(prompts, prefill_chunk=512, **kw)
        while True:
            try:
                if events and events[-1]["event"] == "wave" and events[-1]["wave"] == 9:
                    ev, profiled["wave"] = profile_wave(torch, gen, events[-1]["batch"])
                else:
                    ev = next(gen)
            except StopIteration as stop:
                return stop.value
            events.append(ev)

    out, wall, counts = counted(stream)
    # the same wave's neighbours ran without the profiler (batch 8, no
    # admission): the wall time the idle share is read against
    near = [e["dt_s"] for e in events if e["event"] == "wave"
            and e["wave"] in (8, 9, 11, 12) and e["batch"] == 8]
    wave = profiled["wave"]
    if near and wave["device_busy_ms"]:
        wave["unprofiled_wave_wall_ms"] = 1e3 * sum(near) / len(near)
        wave["device_idle_share_unprofiled"] = \
            1.0 - wave["device_busy_ms"] / wave["unprofiled_wave_wall_ms"]
    check_run("d_stream_chunk512", out, counts, False)
    runs["d_stream_chunk512"] = out
    report["d_stream_chunk512"] = {
        "wall_s": wall, "launches": counts, "steps": server.last_step_counts,
        "prefill_chunk_events": sum(e["event"] == "prefill_chunk" for e in events)}
    if not report["d_stream_chunk512"]["prefill_chunk_events"]:
        raise AssertionError("the chunked stream ran no chunk")
    batch_out, wall, _ = counted(lambda: server.serve_batch(prompts))
    runs["serve_batch"] = batch_out
    report["serve_batch"] = {"wall_s": wall}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    a, c = report["a_bf16_shared"]["pool"], report["c_int8_shared"]["pool"]
    if any(not np.array_equal(x, y) for x, y in zip(runs["c_int8_shared"],
                                                    runs["c_int8_shared_again"])):
        raise AssertionError("the int8 pool gave other tokens on a second run")
    ratio = c["peak_pool_hbm_bytes"] / a["peak_pool_hbm_bytes"]
    if not ratio <= 0.55:
        raise AssertionError(f"int8 pool peak bytes {ratio} of the bf16 pool's (bound 0.55)")
    if a["prefix_hits"] < 8 or report["b_bf16_unshared"]["pool"]["prefix_hits"] != 0:
        raise AssertionError(f"prefix hits {a['prefix_hits']} (a), "
                             f"{report['b_bf16_unshared']['pool']['prefix_hits']} (b)")
    if a["cow_splits"] < 1 or report["a_bf16_shared"]["steps"]["rescore"] != 1:
        raise AssertionError("the identical pair was not re-scored and split")

    def agree(x, y):
        return float(np.mean([(p == q).mean() for p, q in zip(runs[x], runs[y])]))

    summary = {
        "model": "yi-6b", "layers": layers, "requests": len(prompts),
        "prompt_tokens": [len(p) for p in prompts], "decode_tokens": n,
        "token_agreement": {
            "a_vs_b_shared_unshared": agree("a_bf16_shared", "b_bf16_unshared"),
            "a_vs_serve_batch": agree("a_bf16_shared", "serve_batch"),
            "d_vs_a_chunked_stream": agree("d_stream_chunk512", "a_bf16_shared"),
            "c_vs_a_int8_vs_bf16": agree("c_int8_shared", "a_bf16_shared")},
        "int8_over_bf16_peak_pool_bytes": ratio, "peak_memory_gb": peak_gb,
        "runs": report,
    }
    log("continuous " + json.dumps(summary))
    log("continuous-diagnostic " + json.dumps(sharing_diagnostic(torch, server, prompts)))
    log("profile-wave " + json.dumps(profiled["wave"]))
    return {tag: report[tag]["launches"] for tag in ("a_bf16_shared", "c_int8_shared")}


def sharing_diagnostic(torch, server, prompts) -> dict:
    """Where the shared and the unshared runs part (printed, not gated): the
    first-token logits of each prefix sharer, admitted over its donor's pages
    and admitted alone, and whether a GEMM row depends on the row count —
    the prefill projections of a suffix-only and a whole-prompt admission
    run at different M, as the decode GEMMs of batches of 8 and 10 do."""
    from repro_torch.runtime.pages import PagedCacheManager

    captured = {}
    first_token = server._first_token

    def capture(manager, rid, logits):
        captured[rid] = logits[0, -1].float().clone()
        return first_token(manager, rid, logits)

    server._first_token = capture
    try:
        logits = {}
        for share in (True, False):
            manager = PagedCacheManager(256, 128, max_len=server.cfg.max_cache_len,
                                        prefix_sharing=share)
            captured.clear()
            for rid in range(8):
                server._paged_admit(manager, rid, prompts[rid], len(prompts[rid]) + 1, None)
            logits[share] = dict(captured)
            del manager
    finally:
        server._first_token = first_token
    rows = []
    for rid in range(1, 8):
        a, b = logits[True][rid], logits[False][rid]
        top2 = b.topk(2).values
        rows.append({"rid": rid, "bitwise_equal": bool(torch.equal(a, b)),
                     "max_abs_diff": (a - b).abs().max().item(),
                     "argmax_equal": int(a.argmax()) == int(b.argmax()),
                     "unshared_top2_margin": (top2[0] - top2[1]).item()})
    gemm = {}
    wq = server.params["blocks0"]["block"]["attn"]["wq"][0].to(torch.bfloat16)
    x = torch.randn((1224, wq.shape[0]), device=wq.device).to(torch.bfloat16)
    gemm["prefill_rows_1024_of_1224_vs_alone_200"] = bool(
        torch.equal((x @ wq)[1024:], x[1024:] @ wq))
    gemm["decode_rows_8_of_10_vs_alone_8"] = bool(torch.equal((x[:10] @ wq)[:8], x[:8] @ wq))
    gemm["decode_rows_6_of_8_vs_alone_6"] = bool(torch.equal((x[:8] @ wq)[:6], x[:6] @ wq))
    return {"first_token_logits_shared_vs_unshared": rows, "gemm_row_independence": gemm}


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
    return counts, server


# ---------------------------------------------------------------------------
# phase 7: serve full-width recurrentgemma-2b and rwkv6-3b
# ---------------------------------------------------------------------------


def counted_run(torch, fn):
    """Run `fn` with every launch counter at 0 and every plain version a
    kernel wrapper could take forbidden; returns fn's result and the counts."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.rglru import ops as lru_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops

    def forbidden(*a, **k):
        raise AssertionError("a plain version ran on the card's main path")

    plain = [(attn_ops, "attention_ref"), (attn_ops, "decode_ref"),
             (attn_ops, "flash_attention_bwd_ref"),
             (norm_ops, "rmsnorm_ref"), (lru_ops, "rglru_scan"), (wkv_ops, "wkv_scan")]
    saved = [getattr(mod, name) for mod, name in plain]
    counters = {"flash_attention": attn_ops.flash_attention,
                "flash_attention_bwd": attn_ops.flash_attention_bwd,
                "flash_decode": attn_ops.flash_decode, "rmsnorm": norm_ops.rmsnorm,
                "rglru": lru_ops.rglru, "wkv": wkv_ops.wkv}
    for mod, name in plain:
        setattr(mod, name, forbidden)
    for fn_ in counters.values():
        fn_.launches = 0
    attn_ops.flash_attention.lse_launches = 0
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for (mod, name), value in zip(plain, saved):
            setattr(mod, name, value)
    counts = {name: fn_.launches for name, fn_ in counters.items()}
    counts["flash_attention_lse"] = attn_ops.flash_attention.lse_launches
    return out, counts


def recurrent_phase(torch) -> dict:
    """Full-width, full-depth recurrentgemma-2b (26 layers, 18 RG-LRU and 8
    local-attention blocks) and rwkv6-3b (32 layers), random weights from
    seed 0, through `serve` and `serve_batch`; see `serve_recurrent`."""
    out = {}
    for arch, published in (("recurrentgemma-2b", (26, 2560, 256000)),
                            ("rwkv6-3b", (32, 2560, 65536))):
        out[arch] = serve_recurrent(torch, arch, published)
        torch.cuda.empty_cache()
    return out


def recurrent_server(torch, arch, cfg, *, kernels: bool, policy=None, wkv=None):
    """A full-width server built as `launch/serve.build_server` builds it,
    woven to the CUDA kernels or to the plain implementations (`wkv` picks
    the plain WKV form), at the `half` policy or the given one."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.program import Program
    from repro_torch.core.strategies.kernels import KernelAspect
    from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
    from repro_torch.nn.dtypes import PolicyResolver
    from repro_torch.runtime.server import Server

    program = Program.from_arch(arch, kind="serve", reduced=False, device="cuda")
    aspects = cuda_kernel_aspects() if kernels else (
        [KernelAspect("*", "wkv", wkv)] if wkv else None)
    woven = default_weave(program, SHAPES["prefill_32k"], {}, extra_aspects=aspects)
    if not kernels and any(impl == "cuda" for _, _, impl in woven.state.impls):
        raise AssertionError("the comparison server must run the plain implementations")
    if policy is not None:
        woven.state.policies = PolicyResolver.default(policy)
    return Server(woven, cfg)


def logit_gap(torch, a, b, toks, pair: str) -> dict:
    """Prefill logits of `toks` and the first decode step's logits (both
    servers decode a's first token), a against b, over b's largest logit;
    `pair` names the two."""
    results, first = [], None
    for srv in (a, b):
        srv._begin()  # pins the cache length on the weave state, as `serve` does
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = srv.prefill_vc(None, srv.params, {"tokens": toks})
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        if first is None:
            first = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        pos = torch.full((toks.shape[0], 1), toks.shape[1], dtype=torch.int32, device="cuda")
        logits2, cache = srv.decode_vc(None, srv.params, {"tokens": first, "positions": pos},
                                       cache)
        torch.cuda.synchronize()
        results.append((logits.float(), logits2.float(), ttft * 1e3))
        del cache
    out = {"pair": pair, "ttft_ms_a": results[0][2], "ttft_ms_b": results[1][2]}
    for i, what in enumerate(("prefill", "first_decode")):
        x, y = results[0][i], results[1][i]
        if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
            raise AssertionError(f"{what} logits are not finite")
        if x.shape != y.shape:
            raise AssertionError(f"{what} logits have shapes {x.shape}, {y.shape}")
        out[what] = {"max_abs_err": (x - y).abs().max().item(),
                     "rms_err": (x - y).pow(2).mean().sqrt().item(),
                     "logit_scale": y.abs().max().item()}
    return out


def serve_recurrent(torch, arch, published) -> dict:
    """One solo `serve` of B=2 x 512 tokens and one `serve_batch` of the
    dense phase's eight prompts (200..3000 tokens: recurrentgemma's longer
    prompts prefill into rings of its 2048-token window, the shorter ones
    join them as rings), 32 greedy tokens each, cache 4096 slots.  Gates:
    every launch counter moved by exactly what the structure says, with no
    plain version run; K5 and K6 launch at prefill only (a counted run of
    decode steps reads zero); full-depth prefill and first-decode logits
    within 2e-2 (worst) and 1e-2 (RMS) of the logit scale of the same model
    woven to the plain implementations — in bf16 for recurrentgemma, in
    fp32 for rwkv6, whose bf16 reading is printed beside that of two plain
    WKV forms against each other.  Printed: batch-vs-solo token agreement
    and a decode-step profile."""
    import numpy as np

    from repro_torch.launch.serve import build_server
    from repro_torch.models.lm import RecBlock
    from repro_torch.runtime.server import ServerConfig

    decode_tokens = 32
    cfg = ServerConfig(max_cache_len=4096, decode_tokens=decode_tokens, seed=0)
    t0 = time.perf_counter()
    server = build_server(arch, reduced=False, device="cuda", cfg=cfg)
    torch.cuda.synchronize()
    model, mcfg = server.woven.program.model, server.woven.program.cfg
    layers = mcfg.num_layers
    n_params = sum(p.numel() for p in model.parameters())
    log(f"recurrent: {arch} full width: {layers} layers, d_model {mcfg.d_model}, "
        f"{n_params / 1e9:.2f} B parameters on the card in {time.perf_counter() - t0:.1f} s; "
        f"impls {server.woven.state.impls}")
    if (layers, mcfg.d_model, mcfg.vocab) != published:
        raise AssertionError(f"not the published {arch} configuration")
    hybrid = mcfg.family == "hybrid"
    rec = sum(isinstance(p, RecBlock) for p in model.trunk) if hybrid else 0
    attn = layers - rec if hybrid else 0
    norms = 2 * layers + 1 if hybrid else 0  # RMSNorm; rwkv6 runs LayerNorms

    def per_call(prefill: bool) -> dict:
        """Launches of one prefill or one decode step."""
        return {"flash_attention": attn if prefill else 0,
                "flash_attention_lse": 0, "flash_attention_bwd": 0,
                "flash_decode": 0 if prefill else attn, "rmsnorm": norms,
                "rglru": rec if prefill else 0,
                "wkv": layers if prefill and not hybrid else 0}

    rng = np.random.default_rng(0)
    solo = rng.integers(0, mcfg.vocab, (2, 512), dtype=np.int32)
    lens = [200, 600, 1000, 1400, 1800, 2200, 2600, 3000]
    batch = [rng.integers(0, mcfg.vocab, n).astype(np.int64) for n in lens]
    server.serve(rng.integers(0, mcfg.vocab, (1, 16), dtype=np.int32), decode_tokens=2)

    def main_path():
        solo_out = server.serve(solo)
        solo_s = server.latencies[-1]
        return solo_out, solo_s, server.serve_batch(batch), server.latencies[-1]

    (solo_out, solo_s, batch_out, batch_s), counts = counted_run(torch, main_path)
    prefills, steps = 1 + len(batch), 2 * decode_tokens
    expected = {k: prefills * per_call(True)[k] + steps * per_call(False)[k]
                for k in counts}
    log(f"recurrent: {arch} launches {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(f"{arch}: launch counters {counts} != expected {expected}")
    if solo_out.shape != (2, decode_tokens) or solo_out.min() < 0 \
            or solo_out.max() >= mcfg.vocab:
        raise AssertionError(f"{arch}: serve returned tokens of the wrong shape or range")
    if len(batch_out) != len(batch) or any(o.shape != (decode_tokens,) for o in batch_out):
        raise AssertionError(f"{arch}: serve_batch returned tokens of the wrong shape")

    # decode steps alone: the recurrences run their plain one-step updates
    toks = torch.as_tensor(solo, device="cuda")
    logits, cache = server.prefill_vc(None, server.params, {"tokens": toks})
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)

    def decode_steps(n=4):
        nonlocal cache
        for i in range(n):
            pos = torch.full((2, 1), 512 + i, dtype=torch.int32, device="cuda")
            _, cache = server.decode_vc(None, server.params,
                                        {"tokens": tok, "positions": pos}, cache)

    _, dec_counts = counted_run(torch, decode_steps)
    want_dec = {k: 4 * v for k, v in per_call(False).items()}
    log(f"recurrent: {arch} 4 decode steps: launches {dec_counts}, expected {want_dec}")
    if dec_counts != want_dec:
        raise AssertionError(f"{arch}: decode launches {dec_counts} != {want_dec}")
    del cache

    # -- against the same model woven to the plain implementations ------------
    eager = recurrent_server(torch, arch, cfg, kernels=False)
    for a, b in zip(model.parameters(), eager.woven.program.model.parameters()):
        if not torch.equal(a, b):
            raise AssertionError("the two servers drew different weights from one seed")
    agree_eager = float((eager.serve(solo) == solo_out).mean())
    agree_fp32 = None
    report = {"bf16": logit_gap(torch, server, eager, toks, "kernels vs plain, bf16")}
    if hybrid:
        gated = "bf16"
    else:
        # rwkv6 in bf16 parts by ~10 % of the logit scale (worst) between ANY
        # two plain WKV forms at full depth (sequential vs chunked, chunk 16
        # vs 32): the fp32 reorderings of the recurrence, rounded to bf16,
        # grow through 32 layers of random weights.  The reading is printed;
        # the gate holds the kernel path to the plain path in fp32, where
        # the two forms agree within 2e-5 (ROADMAP Queue 3).
        scan = recurrent_server(torch, arch, cfg, kernels=False, wkv="scan")
        report["bf16_plain_scan_vs_plain_chunked"] = logit_gap(
            torch, scan, eager, toks, "plain sequential WKV vs plain chunked WKV, bf16")
        del scan, eager
        torch.cuda.empty_cache()
        k32 = recurrent_server(torch, arch, cfg, kernels=True, policy="double")
        e32 = recurrent_server(torch, arch, cfg, kernels=False, policy="double")
        report["fp32"] = logit_gap(torch, k32, e32, toks, "kernels vs plain, fp32")
        del e32
        # the same batch-vs-solo reading in fp32: what the bf16 one owes to
        # rounding, and what it would owe to the batched layout
        picks = (0, len(batch) - 1)
        fp32_batch = k32.serve_batch([batch[i] for i in picks])
        agree_fp32 = float(np.mean([
            (k32.serve(batch[i][None].astype(np.int32))[0] == b).mean()
            for i, b in zip(picks, fp32_batch)]))
        del k32
        gated = "fp32"
    for tag, gap in report.items():
        for what in ("prefill", "first_decode"):
            g = gap[what]
            log(f"recurrent: {arch} {what} logits ({tag}), {gap['pair']}: max abs error "
                f"{g['max_abs_err']}, rms {g['rms_err']}, at scale {g['logit_scale']}")
    for what in ("prefill", "first_decode"):
        g = report[gated][what]
        err, rms, scale = g["max_abs_err"], g["rms_err"], g["logit_scale"]
        if not (err <= LOGIT_MAX_TOL * scale and rms <= LOGIT_RMS_TOL * scale):
            raise AssertionError(f"{arch}: {what} logits ({gated}) differ by {err} "
                                 f"(rms {rms}) at scale {scale}")
    eager = None
    torch.cuda.empty_cache()

    log(f"profile-{arch} " + json.dumps(profile_decode(torch, server, toks)))
    picks = (0, len(batch) - 1)  # the shortest (a linear cache alone) and the longest prompt
    solo_again = [server.serve(batch[i][None].astype(np.int32))[0] for i in picks]
    agree_batch = float(np.mean([(a == batch_out[i]).mean()
                                 for a, i in zip(solo_again, picks)]))
    ttft_ms = report["bf16"]["ttft_ms_a"]
    summary = {
        "model": arch, "layers": layers, "params_b": n_params / 1e9,
        "launches": counts, "decode_launches_4_steps": dec_counts,
        "logits_vs_eager": report, "gated_logits": gated,
        "token_agreement_vs_eager": agree_eager,
        "token_agreement_batch_vs_solo": agree_batch,
        "token_agreement_batch_vs_solo_fp32": agree_fp32,
        "ttft_ms_B2_S512": ttft_ms, "eager_ttft_ms_B2_S512": report["bf16"]["ttft_ms_b"],
        "solo_serve_s_B2_S512_N32": solo_s,
        "decode_ms_per_token_B2": (solo_s * 1e3 - ttft_ms) / decode_tokens,
        "batch_serve_s_B8_N32": batch_s, "batch_prompt_tokens": lens,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("recurrent " + json.dumps(summary))
    del server
    return counts


# ---------------------------------------------------------------------------
# phase 8: train full-width gemma-2b
# ---------------------------------------------------------------------------

# One gradient of the kernel path against the same model woven to the plain
# attention (relative): the loss, the global gradient norm, and each attention
# weight's gradient (L2, per layer).
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_GNORM_REL_TOL = 2e-2
TRAIN_WGRAD_REL_TOL = 5e-2
# a resumed run's losses against a straight run's (relative)
RESUME_LOSS_REL_TOL = 1e-3


def forward_only_refusal(torch) -> None:
    """The forward-only kernels (K4, K5, K6) raise under autograd on the
    card instead of returning a result cut off from the graph."""
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rwkv6.ops import wkv

    x = torch.randn((4, 64), device="cuda", requires_grad=True)
    a = torch.rand((1, 4, 64), device="cuda", requires_grad=True)
    r = torch.randn((1, 4, 2, 16), device="cuda", requires_grad=True)
    calls = {
        "rmsnorm": lambda: rmsnorm(x, torch.ones(64, device="cuda")),
        "rglru": lambda: rglru(a, a.detach(), torch.zeros((1, 64), device="cuda")),
        "wkv": lambda: wkv(r, r.detach(), r.detach(), torch.rand_like(r.detach()),
                           torch.zeros((2, 16), device="cuda"),
                           torch.zeros((1, 2, 16, 16), device="cuda")),
    }
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "forward-only" not in str(e):
                raise
        else:
            raise AssertionError(f"{name}: the forward-only kernel returned a "
                                 "result under autograd")
    log("train: rmsnorm, rglru and wkv refuse autograd on the card")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def kernel_vs_eager_gradient(torch, trainer, overrides) -> dict:
    """One microbatch (B 2 x 1024) of the next batch, on the trainer's
    current state: the gradient through the kernels against the gradient
    of the same model woven to the plain attention (`eager`)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.weave import default_weave
    from repro_torch.runtime.steps import build_grad_fn

    eager = default_weave(trainer.woven.program, SHAPES["train_4k"], {},
                          overrides=dict(overrides))
    if any(impl == "cuda" for _, _, impl in eager.state.impls):
        raise AssertionError("the comparison weave must run the plain attention")
    nxt = trainer.pipeline.batch_at(trainer.pipeline.step)
    mb = {k: torch.as_tensor(v[:2]).to("cuda") for k, v in nxt.items()}
    (loss_k, _), g_k = build_grad_fn(trainer.woven)(trainer.params, mb)
    (loss_e, _), g_e = build_grad_fn(eager)(trainer.params, mb)
    loss_k, loss_e = loss_k.item(), loss_e.item()
    norm = lambda tree: sum(g.float().pow(2).sum() for _, g in _paths(tree)).sqrt().item()
    gn_k, gn_e = norm(g_k), norm(g_e)
    worst = {}
    e_paths = dict(_paths(g_e))
    for path, gk in _paths(g_k):
        if "/attn/" not in path:
            continue
        ge = e_paths[path].float()
        gk = gk.float()
        per_layer = ((gk - ge).flatten(1).norm(dim=1) / ge.flatten(1).norm(dim=1))
        worst[path] = per_layer.max().item()
    out = {"loss_kernels": loss_k, "loss_eager": loss_e,
           "loss_rel_err": abs(loss_k - loss_e) / abs(loss_e),
           "grad_norm_kernels": gn_k, "grad_norm_eager": gn_e,
           "grad_norm_rel_err": abs(gn_k - gn_e) / gn_e,
           "attn_grad_rel_l2_worst_layer": worst}
    log("train-vs-eager " + json.dumps(out))
    if not (out["loss_rel_err"] <= TRAIN_LOSS_REL_TOL
            and out["grad_norm_rel_err"] <= TRAIN_GNORM_REL_TOL
            and all(v <= TRAIN_WGRAD_REL_TOL for v in worst.values())):
        raise AssertionError(f"kernel-path gradient differs from the plain path: {out}")
    if len(worst) != 4:
        raise AssertionError(f"expected the four attention weights, got {sorted(worst)}")
    return out


def resume_phase(torch) -> dict:
    """Checkpoint resume on the card at the reduced gemma-2b (attention
    through K1 and K3 at head_dim 16): save after 4 steps, restore into a
    fresh `Trainer`, run 2 more; the losses equal a straight 6-step run's.
    Full width would write the whole training state, ~35 GB, to disk."""
    import tempfile
    from functools import partial

    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.trainer import TrainerConfig

    def make(ckpt, steps):
        return build_trainer(
            "gemma-2b", reduced=True, device="cuda", batch=8, seq=64,
            overrides={"accum_steps": 2}, lr_fn=partial(constant, peak=3e-4),
            tcfg=TrainerConfig(steps=steps, log_every=0, ckpt_dir=ckpt, ckpt_every=0))

    with tempfile.TemporaryDirectory() as ckpt:
        first = make(ckpt, 4)
        first.run()
        first.save(blocking=True)
        resumed = make(ckpt, 2)
        if not (resumed.maybe_restore() and resumed.step == 4
                and resumed.pipeline.step == 4):
            raise AssertionError("the resumed trainer did not pick up step 4")
        tail = [h["loss"] for h in resumed.run(2)]
    straight = [h["loss"] for h in make(None, 6).run()][4:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(tail, straight))
    out = {"resumed_losses": tail, "straight_losses": straight, "max_rel_err": rel}
    log("train-resume " + json.dumps(out))
    if not rel <= RESUME_LOSS_REL_TOL:
        raise AssertionError(f"resumed losses {tail} differ from the straight run's "
                             f"{straight}")
    return out


def train_phase(torch) -> dict:
    """Full-width, full-depth gemma-2b (18 layers, d_model 2048, MQA 8 q / 1
    KV head of 256, vocab 256000; random weights from seed 0) trained
    through the launcher's own builder: policy `half`, remat `full`, global
    batch 4 x 1024 in 2 microbatches, the `lcg` pipeline, a constant 3e-4,
    6 steps.  Each step is a counted run: K1 (with lse) runs once per layer
    and microbatch in the forward and once more in the remat recompute, K3
    once per layer and microbatch, and nothing else — no K2 / K4 / K5 / K6
    launch and no plain version.  Gates: finite losses, the last below the
    first; the kernel path's gradient against the plain attention's; the
    reduced checkpoint resume.  Printed: step time (synchronised), tokens/s,
    MFU against 989 TFLOP/s, peak memory, and the device's busy share of one
    more step under `torch.profiler`."""
    from functools import partial

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import build_trainer
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.trainer import TrainerConfig

    forward_only_refusal(torch)
    torch.cuda.reset_peak_memory_stats()
    steps, batch, seq, accum = 6, 4, 1024, 2
    overrides = {"accum_steps": accum, "remat": "full", "precision": "half"}
    t0 = time.perf_counter()
    trainer = build_trainer("gemma-2b", reduced=False, device="cuda", batch=batch,
                            seq=seq, mode="lcg", overrides=overrides,
                            tcfg=TrainerConfig(steps=steps, log_every=0, seed=0),
                            lr_fn=partial(constant, peak=3e-4))
    trainer.init_state()
    torch.cuda.synchronize()
    woven, mcfg = trainer.woven, trainer.woven.program.cfg
    n_params = sum(p.numel() for p in woven.program.model.parameters())
    kernels_woven = [i for i in woven.state.impls if i[2] == "cuda"]
    log(f"train: gemma-2b full width: {mcfg.num_layers} layers, d_model {mcfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters and AdamW state on the card in "
        f"{time.perf_counter() - t0:.1f} s; kernels woven {kernels_woven}, remat "
        f"{woven.state.extra.get('remat')}, accum {woven.state.extra.get('accum_steps')}")
    if (mcfg.num_layers, mcfg.d_model, mcfg.vocab, mcfg.n_heads, mcfg.kv_heads,
            mcfg.resolved_head_dim, mcfg.d_ff) != (18, 2048, 256000, 8, 1, 256, 16384):
        raise AssertionError("not the published gemma-2b configuration")
    if kernels_woven != [("*", "attention", "cuda")]:
        raise AssertionError(f"training must weave the attention kernels alone: {kernels_woven}")

    layers = mcfg.num_layers
    want = {"flash_attention": 2 * accum * layers, "flash_attention_lse": 2 * accum * layers,
            "flash_attention_bwd": accum * layers, "flash_decode": 0, "rmsnorm": 0,
            "rglru": 0, "wkv": 0}
    step_s, totals = [], {k: 0 for k in want}
    for i in range(steps):
        t = time.perf_counter()
        _, counts = counted_run(torch, lambda: trainer.run(1))
        step_s.append(time.perf_counter() - t)
        h = trainer.history[-1]
        log(f"train: step {h['step']}: loss {h['loss']:.6f}, accuracy {h['accuracy']:.4f}, "
            f"grad norm {h['grad_norm']:.4f}, {step_s[-1] * 1e3:.1f} ms, launches {counts}")
        if counts != want:
            raise AssertionError(f"step {i + 1}: launch counters {counts} != expected {want}")
        for k in totals:
            totals[k] += counts[k]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in trainer.history]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")

    steady = step_s[1:]  # the first step pays one-time set-up (cuBLAS, allocator)
    step_mean = sum(steady) / len(steady)
    step_median = float(np.median(steady))
    tokens = batch * seq
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run(1)
        torch.cuda.synchronize()
    rows = sorted(((_device_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    profile_out = {
        "device_busy_ms_per_step": busy_ms if busy_ms > 0 else None,
        # against the median unprofiled step: the profiler slows the host
        "device_idle_share": 1.0 - busy_ms / (step_median * 1e3) if busy_ms > 0 else None,
        "device_launches_per_step": sum(r[1] for r in rows),
        "top_kernels_ms_per_step": [{"kernel": key[:80], "ms": us / 1e3, "calls": count}
                                    for us, count, key in rows[:10]],
    }
    log("profile-train " + json.dumps(profile_out))

    compare = kernel_vs_eager_gradient(torch, trainer, overrides)
    summary = {
        "model": "gemma-2b", "layers": layers, "params_b": n_params / 1e9,
        "global_batch": batch, "seq": seq, "accum_steps": accum, "steps": steps,
        "losses": losses, "step_s": step_s, "step_s_mean_steps_2_to_6": step_mean,
        "step_s_median_steps_2_to_6": step_median,
        "tokens_per_s": tokens / step_mean,
        "mfu": trainer.info["flops_per_step"] / step_mean / PEAK_FLOPS["bf16"],
        "tokens_per_s_median_step": tokens / step_median,
        "mfu_median_step": trainer.info["flops_per_step"] / step_median / PEAK_FLOPS["bf16"],
        "model_flops_per_step": trainer.info["flops_per_step"],
        "peak_memory_gb_6_steps": peak_gb,
        "launches_per_step": want, "launches_6_steps": totals,
        "profile": profile_out, "vs_eager": compare,
    }
    log("train " + json.dumps(summary))
    del trainer
    torch.cuda.empty_cache()
    summary["resume"] = resume_phase(torch)
    return summary


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
    quant = quantized_decode_cases(torch, gen)
    lru = rglru_cases(torch, gen)
    wkv6 = wkv_cases(torch, gen)
    lse_c, dq_c, dkv_c = flash_bwd_cases(torch, gen)
    for c in norm + pre + dec + quant + lru + wkv6 + lse_c + dq_c + dkv_c:
        log("kernel-case " + json.dumps({k: v for k, v in c.items() if k != "main"}))
    log("shared-prefill-identity " + json.dumps(shared_prefill_identity(torch, gen)))

    reduced_phase(torch)
    serve_counts, server = serve_phase(torch)
    cont = continuous_phase(torch, server)
    del server
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = recurrent_phase(torch)
    gc.collect()  # the serving phases' models may sit in reference cycles
    torch.cuda.empty_cache()
    train = train_phase(torch)

    # `launches`: the continuous main path, bf16 pool (run a); the quantized
    # mode over the int8 pool (run c).  Every counted run is listed beside.
    a, c = cont["a_bf16_shared"], cont["c_int8_shared"]

    def by_run(key):
        return {"serve_and_serve_batch": serve_counts.get(key, 0),
                "continuous_a_bf16": a.get(key, 0), "continuous_c_int8": c.get(key, 0),
                "recurrentgemma_serve": rec["recurrentgemma-2b"].get(key, 0),
                "rwkv6_serve": rec["rwkv6-3b"].get(key, 0),
                "train_gemma_6_steps": train["launches_6_steps"].get(key, 0)}

    kernels = [
        kernel_entry("flash_attention", "src/repro_torch/csrc/flash_prefill.cu",
                     "src/repro/kernels/flash_attention/kernel.py:490", pre,
                     a["flash_attention"], by_run("flash_attention")),
        kernel_entry("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/decode.py:454", dec,
                     a["flash_decode"], by_run("flash_decode")),
        kernel_entry("flash_decode_quantized", "src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/decode.py:454", quant,
                     c["flash_decode_quantized"], by_run("flash_decode_quantized")),
        kernel_entry("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
                     "src/repro/kernels/rmsnorm/kernel.py:37", norm, a["rmsnorm"],
                     by_run("rmsnorm")),
    ]
    # K5 and K6 launch on their own families' path only: their `launches`
    # are that path's counted run
    kernels += [
        kernel_entry("rglru", "src/repro_torch/csrc/rglru.cu",
                     "src/repro/kernels/rglru/kernel.py:65", lru,
                     rec["recurrentgemma-2b"]["rglru"], by_run("rglru")),
        kernel_entry("wkv6", "src/repro_torch/csrc/wkv6.cu",
                     "src/repro/kernels/rwkv6/kernel.py:108", wkv6,
                     rec["rwkv6-3b"]["wkv"], by_run("wkv")),
    ]
    # K1's lse mode and K3 launch on the training path only: their
    # `launches` are the six counted training steps
    t = train["launches_6_steps"]
    kernels += [
        kernel_entry("flash_attention_lse", "src/repro_torch/csrc/flash_prefill.cu",
                     "src/repro/kernels/flash_attention/kernel.py:490", lse_c,
                     t["flash_attention_lse"], by_run("flash_attention_lse")),
        kernel_entry("flash_attention_bwd_dq", "src/repro_torch/csrc/flash_bwd.cu",
                     "src/repro/kernels/flash_attention/kernel.py:763", dq_c,
                     t["flash_attention_bwd"], by_run("flash_attention_bwd")),
        kernel_entry("flash_attention_bwd_dkv", "src/repro_torch/csrc/flash_bwd.cu",
                     "src/repro/kernels/flash_attention/kernel.py:809", dkv_c,
                     t["flash_attention_bwd"], by_run("flash_attention_bwd")),
    ]
    kernels[2]["library_ms_note"] = ("no single PyTorch call attends over an int8 "
                                     "paged pool")
    kernels[4]["library_ms_note"] = "no single PyTorch call computes a linear recurrence"
    kernels[5]["library_ms_note"] = "no single PyTorch call computes the WKV recurrence"
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
