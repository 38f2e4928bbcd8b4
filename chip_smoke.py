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
   the RMS), while a dropped KV block moves a long-context row by more.
   K1, K3 and K2's widened-q mode (over bf16 values and over int8 / e4m3 /
   e5m2 codes, `widened_codes_cases`), whose bf16 route sums on the tensor
   cores in another order than the plain version, are held to the plain
   version evaluated in float64 (`exact`, `check_exact`), with the same
   tolerances: the fp32 plain version's own rounding of its largest
   outputs already reaches the gate there.  The kernels' entry points
   report the route each launch took (`route_counts`): in every counted
   run every bf16 K1 / K3 launch is a tensor-core launch, and K3 must give
   the same bits twice.  It
   times both, times the one-call PyTorch library function where there is
   one, and computes the least time the card could take (the roofline bound).
   K2's block mode (a rank's share of a sequence-split cache, returning o
   and lse) is held on every route at the main-path shape cut into 2 and 4
   shares, dense and paged, and at every shape the serving runs under
   fsdp_sp give it (gemma-2b's D 256 pool, whisper's cross caches,
   mixtral's ring) cut in two (`block_decode_cases`): each share's o and lse
   against the plain version, the merged shares against the whole cache,
   a share past the index exactly 0 / -inf, the whole cache as one share
   bit for bit the call without the block mode.
   The quantized mode of flash decode (int8 / fp8 pages with fp32 scales) is
   held to its plain version, to the dense layout of the same codes bit for
   bit, and to flash decode over the bf16 values it quantizes.  Every
   single-token flash decode case with a bf16 q (over bf16 values or codes)
   must report the split route, give the same bits on a second call, and
   give the shortest and the longest request's rows bit for bit when that
   request is called alone (`split_gates`); its achieved GB/s is printed;
   and the widened-q case prints how far a single-token row lies from the
   widened row of the same token.  Every widened bf16 q over codes (a
   quantized pool's suffixes and first prefills) must report the
   tensor-core route; a prefix-shared suffix must equal the whole prompt's
   rows bit for bit over a bf16 and an int8 pool, both on the tensor cores
   (`shared_prefill_identity`).  The RG-LRU scan (K5) is held bit for bit
   to its plain version on every case, one CUDA launch a call, and its
   kernel time over the recurrent serve's prefills is printed
   (`rglru_cases`, `rglru_serve_times`).  The chunk-parallel WKV kernel is held at
   the reference test's tolerance, and in fp32 at FP32_TOL against its
   twin in its own order of sums; one call's CUDA launches are counted from
   a profiler trace;
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
   profiles one continuous wave at batch 8 (`continuous_phase`); the int8
   and bf16 pools' first-prefill logits are read against the plain
   (`eager`) path over the same pool at the full-depth logit gate, its RMS
   half gated, on four prompts (`pool_prefill_logit_gate`); then serves
   the same traffic speculatively and under the resilience layer
   (`speculative_phase`: self-draft at k = 2 / 4 over the bf16 pool and k =
   2 over the int8 pool with exact launch counts, fp32 at a depth of 4
   against plain greedy bit for bit, four injected-fault runs under
   `pool_audit`, gemma-2b drafting for yi-6b) and profiles one verify wave;
   K2's widened mode at the verify shape is held and timed with the other
   kernel cases (`verify_decode_cases`); then serves the same traffic under
   the QoS governor (`qos_phase`: mARGOt re-planning max_batch, prefill
   chunk, draft length and the modeled DVFS point every wave — reactive
   off twice with the same operating points, SLOs on the model's scale
   moving the draft length and replaying the draft, reactive on, a modeled
   power budget, fp32 at a depth of 4 bit for bit ungoverned) and through a
   two-replica fleet with a hot spare over one copy of the weights
   (`fleet_phase`: clean, a replica lost mid-decode, a drain, fp32 at a
   depth of 4 bit for bit one server), exact launch counts in every run;
   every K2 shape those runs launched is held against its plain version
   (`governed_shape_cases`); then runs the kernel tuner's loop
   (`tuner_phase`: tunes the card's knobs — yi-6b's page size, pool dtype
   and draft length at its continuous signature, K3's `dkv_n_split` at
   gemma-2b's microbatch — into a cache file of its own, holds every
   tuned value against its plain version, serves the same model through
   second woven servers over the same weights that weave the tuned rows
   (a page size other than the default gives the same bf16 tokens bit for
   bit), with exact launch counts, and feeds the observed latencies back);
   every phase before it weaves the tuner's aspect over an empty cache;
   then serves mixtral-8x22b (MoE, sliding window
   4096: a linear and a ring page pool), grok-1-314b (MoE, soft-cap),
   qwen2-72b and nemotron-4-340b (head_dim 192) at their published widths
   and the depth one card holds through `serve_continuous`, with exact
   launch counts, MoE's refusal of sharing, chunking and speculation, the
   ring pool's page bound and the logit gate against the plain path
   (`families_phase`; its K1 / K2 shapes are cases of step 3); then runs
   whisper-small (encoder-decoder, 12 + 12 layers) and internvl2-1b (an
   image prefix, 24 layers) at full width and depth through the woven
   prefill / decode steps in a greedy loop, with exact launches by route
   (K1 non-causal in the encoder, K2 over the cross cache at index T - 1),
   the cross cache unwritten, the logit gate against the eager twin, and
   internvl2-1b's text-only requests through `serve_continuous`
   (`frontends_phase`; its K1 / K2 shapes are `frontend_kernel_cases`);
7. serves full-width, full-depth recurrentgemma-2b (RG-LRU kernel K5, and
   the attention and RMSNorm kernels over its local-attention rings) and
   full-width rwkv6-3b at `RWKV_SERVE_LAYERS` (8 of 32) layers (WKV kernel
   K6) through `serve` and `serve_batch`, with exact
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
   share of a step; one microbatch's gradient under the remat policies
   `full`, `dots` and `dots_no_batch`, bit for bit alike, with the launches
   each implies (`remat_policy_runs`); then a checkpoint resume at the
   reduced configuration (`train_phase`);
9. trains the hybrid, ssm, MoE and encoder-decoder families at published
   width (`train_families_phase`, `TRAIN_FAMILY_RUNS`): recurrentgemma-2b
   at full depth and rwkv6-3b cut to 4 layers through the launcher's
   trainer, mixtral-8x22b cut to one layer, whisper-small through
   `build_train_step` with frames from a seed — three counted steps each
   (rwkv6-3b two) with exact launches (every bf16 K1 / K3 launch on the
   tensor cores), finite losses, the first batch's loss falling, step
   time, tokens/s, MFU, peak memory and the busy share of a profiled step,
   and the kernel-vs-eager gradient in fp32 on the same weights; in bf16
   the recurrentgemma and whisper kernels' gradient against K1's and K3's
   plain formula, with the witness of delta's rounding beside (rwkv6-3b,
   which runs no kernel, must move every parameter).  K1 with lse and K3 are
   held at the families' shapes with the other kernel cases (step 3);
10. holds the port's roofline (`roofline/`, composed on the meta device on
   the card mesh) against measured device-busy time: right after step 5,
   (r1) a yi-6b decode step at B8 against 4096-slot caches (K2's split
   route, K4) and (r2) a B1 x 2048 prefill (K1, K4), counted runs with
   exact launches, and (r2)'s attention core over the peak equal to K1's
   `bound_ms`; the serve phase's dense requests again through a `Server`
   on the card mesh over the same weights (tokens bit for bit, launches by
   route the same); after step 9, (r3) step 8's training step.  Each cell
   prints its terms, MFU and roofline_share = step_s / busy, gated at
   1.05.  Step 8's checkpoint resume also restores the checkpoint onto the
   card mesh (`reshard_params`, bit for bit), and one dry-run record
   (yi-6b decode_32k on the card mesh) must say its state does not fit;
11. runs the four examples of `examples_torch/` through their own functions
   at the reference's sizes, between step 9 and (r3) (`examples_phase`):
   quickstart (reduced yi-6b, 30 steps of 8 x 32) and train_100m at its
   documented full run (`CFG_100M` at full width, 300 steps of 16 x 256,
   checkpoints every 100 steps) as counted runs — K1 with lse and K3 once an
   attention layer and step, every launch on the tensor cores — with a
   falling loss, and train_100m's newest checkpoint restored into a fresh
   trainer bit for bit; navigation_serve (reduced gemma-2b, 12 serves over 6
   routes under mARGOt and the memo) as a counted run of K1, K2 on its split
   route and K4, 6 of the 12 answered by the memo; drug_discovery's LAT
   exploration (5 chunkings x 3 tests), mARGOt over its knowledge base and
   64 ligands docked, every score against float64 numpy and the settled
   point within its budget.  One `examples` line each: step time (the
   trainer's synchronised sensor, and host wall and profiler busy over five
   more steps), tokens/s, MFU, peak memory; serve latencies; the DSE table;
12. runs two ranks on the one card over gloo (`run_on_mesh`, `mesh_phase`):
   full-width yi-6b at `MESH_SERVE_DEPTH` (2 of 32) layers served
   tensor-parallel on a (1, 2) mesh through `serve` / `serve_batch` (step
   5's requests) and a short `serve_continuous` over the paged pool — each
   rank's launches by route equal to step 5's one-card counts scaled to
   the depth (`depth_counts`), its collectives counted, its decode step
   profiled — with the prefill logits held at the full-depth logit gate
   against a one-card server of the same depth and weights; then gemma-2b at
   full width, cut to `MESH_TRAIN_DEPTH` layers so both ranks' state fits,
   trained two steps on a (2, 1) and a (1, 2) mesh: K1 with lse and K3
   counted per step, the first batch's loss falling, and the meshed
   gradient at the training gradient gates against one card's; then
   AutoShard's FSDP layouts on the same ranks (`FSDP_RUNS`): (f1)
   qwen2-72b at 1 of 80 layers on (2, 1), `megatron_tp` with `embed` over
   `data`; (f2) rwkv6-3b at 2 layers on (1, 2) and (f3) recurrentgemma-2b
   at 3 layers on (2, 1) under `dp_fsdp`, each served (`serve_batch` of
   the serving traffic's prompts, each rank its rows: launches by route
   equal to one card's on those rows, K5's output bit for bit one card's,
   the prefill logits at the logit gate, rwkv6 in fp32) and trained; (f4)
   gemma-2b at 2 layers on (1, 2) under `fsdp_sp` — each trained one
   counted step (the first batch's loss falling, the meshed gradient at
   the training gates against one card's, each rank holding only its
   blocks and their AdamW state, the FSDP gathers and reduce-scatters
   counted), (f4)'s dense logits against one card's; then the MoE,
   encoder-decoder and VLM families on (1, 2) under AutoShard's own
   `megatron_tp` (`FAMILY_MESH_RUNS`): (g1) mixtral-8x22b at 1 of 56
   layers, two prompts past its window through `serve_continuous` (a paged
   ring pool); (g2) whisper-small at full depth, two clips of 1500 frames
   through `serve`; (g3) internvl2-1b at full depth, two requests of 256
   image embeddings through `serve` — each rank's launches by route equal
   to one card's on the same traffic, the MoE routing bit for bit the same
   on both ranks (the share of tokens one card routes elsewhere printed),
   the prefill logits at the logit gate against one card's (mixtral's and
   internvl2-1b's in fp32), whisper's cross caches left unwritten on a
   rank's heads — and each trained two counted steps (whisper through
   `build_train_step` with frames): the first batch's loss falling, the
   meshed gradient at the training gates against one card's; then the same
   families trained under `fsdp_sp` on (1, 2), each rank on its block of
   the sequence (`FAMILY_SP_RUNS`): (p1) internvl2-1b at full depth, 2 x
   (256 image embeddings + 256 tokens), and (p2) whisper-small at full
   depth, 2 x 448 tokens over 1500 frames, through `build_train_step`,
   two counted steps; (p3) mixtral-8x22b at 1 of 56 layers with
   AutoShard's own FSDP `embed` rule, 2 x 512 through the `Trainer`, one
   counted step — the first batch's dense logits with K1 and K4 woven
   (fp32 for internvl and mixtral) at the logit gate against one card's,
   their launches by route one card's, mixtral's keep masks bit for bit
   one card's and alike on both ranks; K1 with lse and K3 on the gathered
   sequence counted per step, the first batch's loss falling, the
   sequence's gathers (and mixtral's FSDP gathers and reduce-scatters)
   counted, each rank's resident blocks, the meshed gradient at the
   training gates against one card's; then serving under `fsdp_sp` on
   (1, 2), each rank holding its share of every KV cache and page pool
   (`SERVE_SP_RUNS`): (s1) gemma-2b at 4 of 18 layers, the continuous
   traffic chunked in bf16, over the int8 pool plain and at k = 2, at 2
   layers in fp32, and a `serve_batch` of a 1024- and a 1023-token prompt;
   (s2)-(s4) (g2), (g3) and (g1)'s traffic — each rank's launches by route
   one card's with every K2 launch in the block mode, its pool bytes and
   cache slots half one card's (an int8 pool's scales whole), the prefill
   and first-decode logits at the logit gate (fp32 within 1e-5 of the
   scale, fp32 tokens one card's), the int8 pool's first logits on the
   gate's RMS half, MoE routing alike on both ranks, whisper's cross caches
   (750 frames a rank) unwritten, the ranks' merges counted; then
   quantized and speculative serving, int8 weights and int8 gradient
   compression on (1, 2) (`QUANT_MESH_RUNS`): (q1) the full yi-6b server's
   continuous prompts again over an int8 pool, plain and self-drafted at
   k = 2 (K2d on a rank's KV heads, K2's widened verify over its codes;
   launches by route from the step counts, every outcome ok, a rank's int8
   page at most 0.55x its bf16 page, the spec stats against the step
   counts; agreement with one card's (c) and (s3) printed); (q2) yi-6b at
   4 layers in fp32 over an int8 pool, plain and at k = 2 (speculative bit
   for bit plain on the mesh), its first prefill's logits against one
   card's — over the fp32 pool within 1e-5 of the scale, over the int8
   pool at the logit gate with every code at most one step from one
   card's; (q3) the same model under `fixed` (int8 MLP weights, bf16):
   every row-parallel weight's codes and scales bit for bit one card's rows
   and the prefill logits at the logit gate; (q4) gemma-2b at
   `MESH_TRAIN_DEPTH` layers trained two steps under `CompressionAspect`:
   the first batch's loss falling, the compressed gradient at the training
   gates against one card's, `ef` shaped as a rank's blocks; then the
   serving control plane on (1, 2), every host decision rank 0's
   (`CONTROL_MESH_RUNS`): (d1) the first 8 prompts of the continuous
   traffic through (q2)'s fp32 4-layer server, ungoverned and under the
   planned governor (`QOS_BASE` + `QOS_MODEL_SLO`): the governed tokens bit
   for bit the ungoverned, the draft length at 0 and later above it, the
   `op_history`, switches and distinct operating points one card's; (d2)
   four short prompts through the full bf16 server under `QOS_BASE` +
   `QOS_POWER`, reactive on: `freq` below 1 in force, rank 0's host time
   per `decide` beside its broadcast; (d3) `FLEET` over replicas of the
   fp32 server on the mesh (one copy of a rank's shards): clean, a replica
   lost mid-decode, a drain — the tokens one meshed server's, the peak
   memory over resident below a rank's shards; (d4) a preemption that
   reaches one rank only (rank 0's reading drains every rank alike), and
   `refine_kernel_tuner` / `refine_speculative` after rank 0 tunes their
   signatures (one cache write, rank 0's knobs on every rank) — each
   rank's launches by route from its step counts, every outcome ok, every
   rank's operating points, outcomes, events and tokens rank 0's.  Two
   ranks on one card time-slice its SMs: their times are no parallel
   speed-up.

Any failed phase ends the run with a non-zero exit code.  The last line of
the output is `{"ok": true, "device": {...}}`; the line before the card's
line is one JSON object describing every kernel.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# published peaks of one H100 SXM (dense), from the port's roofline: what
# `bound_ms`, the MFU and the roofline phase are computed against
from repro_torch.roofline import hw  # noqa: E402

PEAK_BYTES_PER_S = hw.HBM_BW
PEAK_FLOPS = {"bf16": hw.PEAK_FLOPS_BF16, "fp32": hw.PEAK_FLOPS_FP32}
L2_BYTES = 50_000_000  # one H100's L2 cache

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
# the recurrent serve's traffic (`serve_recurrent`): one solo `serve` of
# B2 x 512 tokens, then a `serve_batch` of prompts of these lengths
SERVE_SOLO = (2, 512)
SERVE_BATCH_LENS = [200, 600, 1000, 1400, 1800, 2200, 2600, 3000]


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


def exact(fn, tensors, **kw):
    """A plain version evaluated in float64 on float64 copies of its inputs:
    the reference K1, K3 and K2's widened-q mode are held to (`check_exact`).
    On the card the fp32 plain version, rounded to bf16, misses the exact
    result by a bf16 step of its largest outputs at these shapes (up to 8 %
    of the output's RMS: causal rows over a few keys keep values 40x the
    RMS), so a kernel as accurate as fp32 whose sums run in another order
    could not be held to it within 5e-2."""
    return fn(*(t.double() for t in tensors), **kw)


def exact_error(torch, got, want) -> tuple[float, float]:
    """Worst error of `got` against the exact (float64) result `want` beyond
    the rounding `got`'s type forces on it — |got - want| less half the
    spacing of that type at `want`, so a correctly rounded output reads 0
    and one whose fp32 sums land next to a rounding tie and round the other
    way reads only its fp32 error — and the exact result's RMS."""
    bits = {torch.bfloat16: 8, torch.float32: 24}[got.dtype]  # significant bits
    _, e = torch.frexp(want)  # want = m 2^e, 1/2 <= |m| < 1
    half = torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(want), e - bits - 1))
    err = ((got.double() - want).abs() - half).clamp(min=0).max().item()
    return err, want.pow(2).mean().sqrt().item()


def exact_codes(fn, q, k, v, index, kw):
    """`exact` over a quantized cache: q and the scales in float64, the codes
    as they are, so that every value code x scale enters exactly."""
    kw = {**kw, "k_scale": kw["k_scale"].double(), "v_scale": kw["v_scale"].double()}
    return fn(q.double(), k, v, index, **kw)


def check_exact(torch, name, got, want, rel_tol) -> tuple[float, float]:
    """`check_close` against an exact result, as `exact_error` measures it."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err, rms = exact_error(torch, got, want)
    if not err <= rel_tol * rms:
        raise AssertionError(f"{name}: max abs error {err} exceeds {rel_tol} of the "
                             f"exact result's RMS {rms}")
    return err, rms


def live_pairs(S, T, causal, window) -> int:
    """(q, k) pairs the mask keeps, for self-aligned positions."""
    total = 0
    for qp in range(S):
        hi = min(T, qp + 1) if causal else T
        lo = max(0, qp - window + 1) if (causal and window) else 0
        total += max(0, hi - lo)
    return total


ROUTE_COUNTERS = ("flash_attention_tc", "flash_attention_fma", "flash_attention_bwd_tc",
                  "flash_attention_bwd_fma", "flash_decode_tc", "flash_decode_split",
                  "flash_decode_fma", "flash_decode_block")


def route_counts(reset: bool = False) -> dict:
    """The route counters of K1, K3 and K2 (widened q and single token on
    the tensor cores, an fp32 q on the FMA body) — each launch counted by
    the route its kernel's entry point reported — with K2's launches over a
    rank's share of a sequence-split cache beside them (`block`, on every
    route), and, with `reset`, set to 0 first."""
    from repro_torch.kernels.flash_attention import ops

    out = {}
    for key in ROUTE_COUNTERS:
        name, attr = key.rsplit("_", 1)
        wrapper = getattr(ops, name)
        if reset:
            setattr(wrapper, attr + "_launches", 0)
        out[key] = getattr(wrapper, attr + "_launches")
    return out


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


def by_kv_head(fn):
    """`fn` (an attention of q (B, S, H, D) over K / V (B, T, K, D)) taken one
    KV head and its q group at a time, the outputs joined on the head axis:
    the same function in 1/K of the plain version's memory (mixtral's
    6000-token prompt holds 13.8 GB of float64 scores over all 48 heads)."""
    import torch

    def run(q, k, v, **kw):
        G = q.shape[2] // k.shape[2]
        return torch.cat([fn(q[:, :, g * G:(g + 1) * G], k[:, :, g:g + 1], v[:, :, g:g + 1],
                             **kw) for g in range(k.shape[2])], dim=2)

    return run


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
        # the families phase's admissions: mixtral's longest prompt past its
        # 4096-token window (G = 6), grok's soft-cap at its longest prompt,
        # nemotron's G = 12 at head_dim 192 (the D-256 instantiation, 64
        # columns of padding)
        ("mixtral_S6000_H48_K8_D128_w4096_bf16", 6000, 48, 8, 128, torch.bfloat16,
         dict(window=4096), BF16_TOL, False),
        ("grok_S2000_H48_K8_D128_softcap30_bf16", 2000, 48, 8, 128, torch.bfloat16,
         dict(softcap=30.0), BF16_TOL, False),
        ("nemotron_S2000_H96_K8_D192_bf16", 2000, 96, 8, 192, torch.bfloat16, {}, BF16_TOL,
         False),
    ]:
        dtype, kv_dtype = dtype if isinstance(dtype, tuple) else (dtype, dtype)
        ref = by_kv_head(attention_ref) if S * S * H > 1e9 else attention_ref
        q = torch.randn((1, S, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, S, K, D), generator=gen, device="cuda").to(kv_dtype)
        v = torch.randn((1, S, K, D), generator=gen, device="cuda").to(kv_dtype)
        ref_kw = {a: b for a, b in kw.items() if a != "pruned"}
        got = flash_attention(q, k, v, causal=True, **kw)
        want = exact(ref, (q, k, v), causal=True, **ref_kw)
        plain_out = ref(q, k, v, causal=True, **ref_kw)
        torch.cuda.synchronize()
        err, rms = check_exact(torch, name, got, want, tol)
        # printed beside: against the fp32 plain version, and that version's
        # own error against the exact result
        err_plain = (got.float() - plain_out.float()).abs().max().item()
        plain_err = exact_error(torch, plain_out, want)[0]
        del want, plain_out
        ms = time_ms(torch, [lambda: flash_attention(q, k, v, causal=True, **kw)], 5)
        plain = time_ms(torch, [lambda: ref(q, k, v, causal=True, **ref_kw)], 3)
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
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms,
                          max_abs_err_vs_fp32_plain=err_plain,
                          fp32_plain_max_abs_err=plain_err, ms=ms, plain_ms=plain,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                          ms_over_library_ms=ms / lib if lib else None))
    return cases


def split_gates(torch, name, got, call, one, idx) -> dict:
    """The split route's bit gates on a single-token case `got` (the batch
    at first-token positions `idx`): it reported the split route, a second
    `call()` gives the same bits, and the shortest and the longest request
    alone (`one(b)`) give their rows of the batch bit for bit."""
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd

    if flash_decode_fwd.last_route != "tc_split":
        raise AssertionError(f"{name}: launched the {flash_decode_fwd.last_route} route")
    again = call()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two calls gave other bits")
    for b in {idx.index(min(idx)), idx.index(max(idx))}:
        alone = one(b)
        torch.cuda.synchronize()
        if not torch.equal(alone, got[b:b + 1]):
            raise AssertionError(f"{name}: request {b}'s rows depend on its batch")
    return {"route": "tc_split", "bitwise_two_calls": True, "bitwise_batch_invariant": True}


def decode_cases(torch, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
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
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:  # one bf16 token: the split route
            extra = split_gates(
                torch, name, got, lambda: flash_decode(q, k, v, index, **kw),
                lambda b: flash_decode(q[b:b + 1], k[b:b + 1], v[b:b + 1], index[b:b + 1],
                                       **kw), idx)
        elif flash_decode_fwd.last_route != "fma":
            raise AssertionError(f"{name}: launched the {flash_decode_fwd.last_route} route")
        else:
            extra = {"route": "fma"}
        want = decode_ref(q, k, v, index, **kw)
        torch.cuda.synchronize()
        err, rms = check_close(torch, name, got, want, tol)
        # four copies of the cache (4 x 67 MB at the main shape) so that each
        # launch finds it cold in the 50 MB L2, as a step over 32 layers does;
        # the launches replay from a CUDA graph, since one is shorter than
        # the time Python takes to issue it
        copies = [(k, v)] + [(k.clone(), v.clone()) for _ in range(3 if main else 0)]
        ms = time_ms(torch, [
            (lambda kk=kk, vv=vv: flash_decode(q, kk, vv, index, **kw)) for kk, vv in copies],
            20, graph=True)
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
            for kk, vv in libs], 10, graph=True)
        del libs
        slots = live_slots(idx, S, Tc, window)
        nbytes = (slots * Kc * Dc * 2 + 2 * q.numel()) * q.element_size()
        flops = 4.0 * Dc * slots * S * Hc
        b_ms, b_by = bound(nbytes, flops, "bf16" if dtype == torch.bfloat16 else "fp32")
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                          gb_s=nbytes / ms / 1e6, **extra))
        del copies

    # paged == dense, bit for bit: shuffled tables, dead pages poisoned
    q, k, v = make(B, 1, T, H, K, D, torch.bfloat16)
    index = torch.tensor(ragged, dtype=torch.int32, device="cuda")
    name = "paged_T4096_page128_bf16"
    pk, pv, tables = poisoned_pool(torch, gen, k, v, ragged, 128, None, 1)
    dense = flash_decode(q, k, v, index)
    paged = flash_decode(q, pk, pv, index, tables=tables, kv_len=T)
    torch.cuda.synchronize()
    extra = split_gates(
        torch, name, paged, lambda: flash_decode(q, pk, pv, index, tables=tables, kv_len=T),
        lambda b: flash_decode(q[b:b + 1], pk, pv, index[b:b + 1], tables=tables[b:b + 1],
                               kv_len=T), ragged)
    if not torch.isfinite(paged).all():
        raise AssertionError(f"{name}: a dead page reached the output")
    if not torch.equal(dense, paged):
        raise AssertionError(f"{name}: paged output differs from dense output")
    want = decode_ref(q, pk, pv, index, tables=tables, kv_len=T)
    err, rms = check_close(torch, name, paged, want, BF16_TOL)
    ms = time_ms(torch, [lambda: flash_decode(q, pk, pv, index, tables=tables, kv_len=T)], 20,
                 graph=True)
    cases.append(dict(case=name, main=False, max_abs_err=err, ref_rms=rms, ms=ms, plain_ms=None,
                      bound_ms=None, bound_by=None, library_ms=None,
                      bitwise_equal_to_dense=True, **extra))

    # the families and frontends phases' decode steps, each over a page pool
    # of 128 (shuffled tables, dead pages poisoned) and bit for bit the dense
    # layout of the same slots (the paged == stacked identity): mixtral's ring
    # pool past its 4096-token window (K2's paged ring mode) and its linear
    # pool under the window, grok's soft-cap, nemotron's G = 12 at head_dim
    # 192 (the D-256 instantiation), internvl2-1b's G = 7 at head_dim 64
    B4 = 4
    for name, idx, Tc, window, softcap, (Hc, Kc, Dc) in [
        ("mixtral_paged_ring_B4_W4096_H48_K8_D128_bf16", [4500, 5000, 5500, 6000], 4096,
         None, None, (48, 8, 128)),
        ("mixtral_paged_window4096_B4_T4096_H48_K8_D128_bf16", [1000, 1700, 2300, 3000], 4096,
         4096, None, (48, 8, 128)),
        ("grok_paged_softcap30_B4_T2048_H48_K8_D128_bf16", [512, 1000, 1500, 2030], 2048,
         None, 30.0, (48, 8, 128)),
        ("nemotron_paged_B4_T2048_H96_K8_D192_bf16", [512, 1000, 1500, 2030], 2048, None,
         None, (96, 8, 192)),
        ("internvl_paged_B4_T2048_H14_K2_D64_bf16", [256, 900, 1500, 2047], 2048, None,
         None, (14, 2, 64)),
    ]:
        q, k, v = make(B4, 1, Tc, Hc, Kc, Dc, torch.bfloat16)
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        pk, pv, tables = poisoned_pool(torch, gen, k, v, idx, 128, window, 1)
        kw = dict(window=window, softcap=softcap)
        paged = flash_decode(q, pk, pv, index, tables=tables, kv_len=Tc, **kw)
        torch.cuda.synchronize()
        extra = split_gates(
            torch, name, paged,
            lambda: flash_decode(q, pk, pv, index, tables=tables, kv_len=Tc, **kw),
            lambda b: flash_decode(q[b:b + 1], pk, pv, index[b:b + 1], tables=tables[b:b + 1],
                                   kv_len=Tc, **kw), idx)
        dense = flash_decode(q, k, v, index, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(paged).all():
            raise AssertionError(f"{name}: a dead page reached the output")
        if not torch.equal(dense, paged):
            raise AssertionError(f"{name}: paged output differs from the dense layout's")
        want = decode_ref(q, pk, pv, index, tables=tables, kv_len=Tc, **kw)
        err, rms = check_close(torch, name, paged, want, BF16_TOL)
        ms = time_ms(torch, [lambda: flash_decode(q, pk, pv, index, tables=tables, kv_len=Tc,
                                                  **kw)], 20, graph=True)
        plain = time_ms(torch, [lambda: decode_ref(q, pk, pv, index, tables=tables, kv_len=Tc,
                                                   **kw)], 2)
        lib = None
        if softcap is None:  # one library call over the dense slots, mask prebuilt
            G = Hc // Kc
            last = index[:, None, None, None]
            kp = torch.arange(Tc, device="cuda")
            mask = kp < (last + 1).clamp(1, Tc)
            if window is not None:
                mask = mask & (kp > last - window)
            kt = k.transpose(1, 2).repeat_interleave(G, dim=1)
            vt = v.transpose(1, 2).repeat_interleave(G, dim=1)
            qt = q.transpose(1, 2)
            lib = time_ms(torch, [lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)], 10, graph=True)
            del kt, vt
        slots = live_slots(idx, 1, Tc, window)
        nbytes = (slots * Kc * Dc * 2 + 2 * q.numel()) * q.element_size()
        b_ms, b_by = bound(nbytes, 4.0 * Dc * slots * Hc, "bf16")
        cases.append(dict(case=name, main=False, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                          gb_s=nbytes / ms / 1e6, bitwise_equal_to_dense=True, **extra,
                          **({} if lib is not None else {
                              "library_ms_note": "no single PyTorch call soft-caps scores"})))
        del pk, pv
    return cases


# K2's block mode: the worst |lse| error of a rank's share against its plain
# version, by q's type (a bf16 q's products round otherwise on the tensor
# cores; an fp32 q's run in fp32 on the FMA body)
BLOCK_LSE_TOL = {"bf16": 1e-3, "fp32": 1e-5}
BLOCK_RAGGED = [199, 511, 1023, 1500, 2047, 2999, 3500, 4095]
# the shapes a rank of the serving runs under fsdp_sp gives K2's block mode:
# name, (B, T, H, K, D), the requests' last positions, layouts, share
# counts, routes
BLOCK_SHAPES = (
    # the main-path shape (yi-6b's decode step), every route, 2 and 4 shares
    ("yi6b", (8, 4096, 32, 4, 128), BLOCK_RAGGED, ("dense", "paged"), (2, 4),
     ("split_bf16", "split_int8", "tc_widened_S3_bf16", "fma_fp32")),
    # (s1)'s gemma-2b: MQA at D 256 over its pool of page 128 split in two —
    # the decode tokens over values and codes, the widened suffixes and
    # verify steps over values and codes, the fp32 run
    ("gemma2b", (8, 4096, 8, 1, 256), BLOCK_RAGGED, ("paged",), (2,),
     ("split_bf16", "split_int8", "tc_widened_S3_bf16", "tc_widened_S3_int8", "fma_fp32")),
    # (s2)'s whisper-small cross caches at index T - 1: 750 of 1500 frames
    ("whisper_cross", (2, 1500, 12, 12, 64), [1499, 1499], ("dense",), (2,),
     ("split_bf16",)),
    # (s4)'s mixtral-8x22b past its 4096-token window: the ring pool (paged
    # ring) and the fp32 gate's dense ring caches
    ("mixtral_ring", (2, 4096, 48, 8, 128), [4500, 5000], ("dense", "paged"), (2,),
     ("split_bf16", "fma_fp32")),
)
# each route: its q (S tokens, type), whether the cache holds int8 codes,
# the route its launches report
BLOCK_ROUTES = {
    "split_bf16": (1, "bf16", False, "tc_split"),
    "split_int8": (1, "bf16", True, "tc_split"),
    "tc_widened_S3_bf16": (3, "bf16", False, "tc"),
    "tc_widened_S3_int8": (3, "bf16", True, "tc"),
    "fma_fp32": (1, "fp32", False, "fma"),
}


def block_decode_cases(torch, gen):
    """K2's block mode (a rank's share of a sequence-split cache, returning
    o and lse for the ranks' merge) at every shape `BLOCK_SHAPES` lists: the
    main-path shape, B8 T4096 K4 G8 D128 with ragged index 199..4095, on
    each route (the split route over bf16 values and over int8 codes, the
    tensor-core route at widened S = 3, the FMA route in fp32), cut into
    n = 2 and n = 4 shares, dense (rank r: slots [r T/n, (r+1) T/n)) and
    paged (page 128, shuffled tables, dead pages poisoned; rank r: slots
    [r 128/n, (r+1) 128/n) of every page); and the shapes the serving runs
    under fsdp_sp launch besides, each cut in two: (s1)'s gemma-2b at D 256
    over its page pool on every route it takes (widened S = 3 over int8
    codes among them), (s2)'s whisper-small cross caches at index T - 1
    (750 of 1500 frames a rank), (s4)'s mixtral-8x22b ring past its window
    (the paged ring pool, and its dense ring caches in fp32).  Gates: each
    share's launch reports its route; its o at the kernel gate and its lse
    within `BLOCK_LSE_TOL` of the plain version (-inf exactly where the
    plain one is); the shares merged in rank order at the kernel gate
    against the whole-cache K2; every request a share holds nothing of
    (request 0, index 199, on the main shape's last dense share) o == 0
    and lse == -inf exactly; and the whole cache as one share, (T, T, 0)
    dense and (128, 128, 0) paged, rounded to q's type, bit for bit the
    call without the block mode.  The main case (the split route over bf16
    values, dense, rank 0 of 2 at the main shape: the main path's decode
    step on a rank of (s1)'s mesh) is timed beside its plain version and
    SDPA over the same share with a prebuilt mask (which returns no lse)."""
    cases = []
    for shape in BLOCK_SHAPES:
        cases += block_shape_cases(torch, gen, *shape)
    return cases


def block_shape_cases(torch, gen, shape_name, dims, last, layouts, shares, route_names):
    """`block_decode_cases` at one shape (see there)."""
    import torch.nn.functional as F

    from repro_torch.distributed.collectives import merge_attention
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd, share_count
    from repro_torch.kernels.flash_attention.ops import (
        flash_decode,
        kv_scale_from_absmax,
        quantize_kv_write,
    )
    from repro_torch.kernels.flash_attention.ref import decode_ref

    (B, T, H, K, D), ps = dims, 128
    G = H // K
    k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    paged_too = "paged" in layouts
    nb = T // ps if paged_too else 0
    P = B * nb + 16
    perm = torch.randperm(P, generator=gen, device="cuda")[:B * nb]
    tables = perm.reshape(B, nb).to(torch.int32)

    def codes(x):
        """(B, T, K, D) values -> int8 codes and their (B, NP, K) page scales."""
        pages = x.float().reshape(B, T // ps, ps, K, D)
        scale = kv_scale_from_absmax(pages.abs().amax(dim=(2, 4)), torch.int8)
        return (quantize_kv_write(pages, scale[:, :, None, :], torch.int8)
                .reshape(B, T, K, D), scale)

    def pool(x, fill):
        """The dense (B, T, K, D) `x` as the shuffled pool; unused pages `fill`."""
        out = torch.full((P, ps, *x.shape[2:]), fill, dtype=x.dtype, device="cuda")
        out[perm] = x.reshape(B * nb, ps, *x.shape[2:])
        return out

    def scales(sc):
        out = torch.full((P, K), float("nan"), device="cuda")
        out[perm] = sc.reshape(B * nb, K)
        return out

    def caches(route):
        """The route's dense (k, v, kwargs) and, where paged, its pool's."""
        _, qt, coded, _ = BLOCK_ROUTES[route]
        if coded:
            (kk, ks), (vv, vs) = codes(k), codes(v)
            dense = (kk, vv, dict(k_scale=ks, v_scale=vs, scale_page=ps))
            fill, pkw = 127, dict(k_scale=scales(ks), v_scale=scales(vs))
        else:
            kk, vv = (k.float(), v.float()) if qt == "fp32" else (k, v)
            dense, fill, pkw = (kk, vv, {}), float("nan"), {}
        paged = (pool(kk, fill), pool(vv, fill), pkw) if paged_too else None
        return {"dense": dense, "paged": paged}

    def share_of(kk, vv, kw, paged, n, r):
        """Rank r of n's share of a dense cache or a pool, its kwargs and block."""
        if paged:
            sub = ps // n
            blk = (sub, ps, r * sub)
            return (kk[:, r * sub:(r + 1) * sub].contiguous(),
                    vv[:, r * sub:(r + 1) * sub].contiguous(),
                    dict(kw, tables=tables, kv_len=T), blk)
        sub = T // n
        kw = dict(kw)
        if "k_scale" in kw:  # the share's own scale rows
            rows = slice(r * sub // ps, (r + 1) * sub // ps)
            kw.update(k_scale=kw["k_scale"][:, rows].contiguous(),
                      v_scale=kw["v_scale"][:, rows].contiguous())
        return (kk[:, r * sub:(r + 1) * sub].contiguous(),
                vv[:, r * sub:(r + 1) * sub].contiguous(), kw, (sub, T, r * sub))

    cases = []
    for name in route_names:
        S, qt, _, route = BLOCK_ROUTES[name]
        q = torch.randn((B, S, H, D), generator=gen, device="cuda")
        if qt == "bf16":
            q = q.to(torch.bfloat16)
        idx = [i - (S - 1) for i in last]
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        tol = BF16_TOL if qt == "bf16" else FP32_TOL
        built = caches(name)
        for layout in layouts:
            kk, vv, kw = built[layout]
            paged = layout == "paged"
            pkw = dict(kw, tables=tables, kv_len=T) if paged else kw
            whole = flash_decode(q, kk, vv, index, **pkw)
            one, _ = flash_decode(q, kk, vv, index, block=(ps, ps, 0) if paged else (T, T, 0),
                                  **pkw)
            torch.cuda.synchronize()
            if not torch.equal(one.to(q.dtype), whole):
                raise AssertionError(f"block {shape_name} {name} {layout}: the whole cache "
                                     "as one share differs from the call without the block "
                                     "mode")
            for n in shares:
                tag = f"block_{shape_name}_{name}_{layout}_n{n}"
                os_, ls_, err, lerr, rms, past = [], [], 0.0, 0.0, 0.0, 0
                for r in range(n):
                    ks_, vs_, skw, blk = share_of(kk, vv, kw, paged, n, r)
                    o, lse = flash_decode(q, ks_, vs_, index, block=blk, **skw)
                    torch.cuda.synchronize()
                    if flash_decode_fwd.last_route != route:
                        raise AssertionError(f"{tag}: launched the "
                                             f"{flash_decode_fwd.last_route} route")
                    o_ref, l_ref = decode_ref(q, ks_, vs_, index, block=blk, **skw)
                    e, rr = check_close(torch, f"{tag} rank {r}", o, o_ref, tol)
                    err, rms = max(err, e), max(rms, rr)
                    dead = l_ref == -float("inf")
                    if not torch.equal(dead, lse == -float("inf")):
                        raise AssertionError(f"{tag} rank {r}: lse is -inf elsewhere than "
                                             "the plain version's")
                    le = (lse[~dead] - l_ref[~dead]).abs().max().item() if (~dead).any() else 0.0
                    if not le <= BLOCK_LSE_TOL[qt]:
                        raise AssertionError(f"{tag} rank {r}: lse off by {le}")
                    lerr = max(lerr, le)
                    for b, i in enumerate(last):  # requests the share holds nothing of
                        if share_count(i, blk) == 0:
                            past += 1
                            if not (bool((o[b] == 0).all())
                                    and bool((lse[b] == -float("inf")).all())):
                                raise AssertionError(f"{tag} rank {r}: a share past request "
                                                     f"{b}'s index gave o != 0 or lse != -inf")
                    os_.append(o)
                    ls_.append(lse)
                merged = merge_attention(torch.stack(os_), torch.stack(ls_)).to(q.dtype)
                m_err, m_rms = check_close(torch, f"{tag} merged", merged, whole, tol)
                case = dict(case=tag, main=False, route=route, max_abs_err=err, ref_rms=rms,
                            lse_max_abs_err=lerr, merged_max_abs_err=m_err,
                            merged_ref_rms=m_rms, bitwise_whole_share=True,
                            past_index_rows=past, ms=None, plain_ms=None,
                            bound_ms=None, bound_by=None, library_ms=None)
                if (shape_name, name, layout, n) == ("yi6b", "split_bf16", "dense", 2):
                    ks_, vs_, skw, blk = share_of(kk, vv, kw, False, 2, 0)
                    copies = [(ks_, vs_)] + [(ks_.clone(), vs_.clone()) for _ in range(3)]
                    case["ms"] = time_ms(torch, [
                        (lambda a=a, b=b: flash_decode(q, a, b, index, block=blk, **skw))
                        for a, b in copies], 20, graph=True)
                    case["plain_ms"] = time_ms(
                        torch, [lambda: decode_ref(q, ks_, vs_, index, block=blk, **skw)], 2)
                    sub = blk[0]
                    mask = (torch.arange(sub, device="cuda")[None] <
                            torch.tensor([min(sub, share_count(i, blk)) for i in idx],
                                         device="cuda")[:, None])[:, None, None, :]
                    qt_ = q.transpose(1, 2)
                    libs = [(a.transpose(1, 2).repeat_interleave(G, dim=1),
                             b.transpose(1, 2).repeat_interleave(G, dim=1))
                            for a, b in copies[:2]]
                    case["library_ms"] = time_ms(torch, [
                        (lambda a=a, b=b: F.scaled_dot_product_attention(qt_, a, b,
                                                                         attn_mask=mask))
                        for a, b in libs], 10, graph=True)
                    case["library_ms_note"] = ("SDPA over the same share with a prebuilt "
                                               "mask; it returns no lse")
                    del libs
                    slots = sum(min(sub, share_count(i, blk)) for i in idx)
                    nbytes = (slots * K * D * 2 * 2 + q.numel() * 2 + q.numel() * 4
                              + B * H * 4)
                    case["bound_ms"], case["bound_by"] = bound(nbytes, 4.0 * D * slots * H,
                                                               "bf16")
                    case["gb_s"] = nbytes / case["ms"] / 1e6
                    case["main"] = True
                    del copies
                cases.append(case)
        del built
    return cases


def poisoned_pool(torch, gen, k, v, idx, ps, window, q_span):
    """The dense (B, T, K, D) cache `k`, `v` as a shuffled page pool of page
    `ps` with 16 spare pages; every page no request's decode schedule names
    (requests at first-token positions `idx`) holds NaN."""
    from repro_torch.kernels.flash_attention.decode import paged_decode_schedule

    B, T, K, D = k.shape
    nb = T // ps
    perm = torch.randperm(B * nb + 16, generator=gen, device="cuda")[:B * nb]
    tables = perm.reshape(B, nb).to(torch.int32)
    pk = torch.full((B * nb + 16, ps, K, D), float("nan"), device="cuda", dtype=k.dtype)
    pv = torch.full_like(pk, float("nan"))
    pk[perm] = k.reshape(B * nb, ps, K, D)
    pv[perm] = v.reshape(B * nb, ps, K, D)
    live = set()
    host_tables = tables.cpu().tolist()
    for b, i in enumerate(idx):
        live |= {p for p, _ in paged_decode_schedule(T, i, 64, ps, host_tables[b],
                                                     window=window, q_span=q_span)}
    dead = torch.tensor([p for p in range(pk.shape[0]) if p not in live], device="cuda")
    pk[dead] = float("nan")
    pv[dead] = float("nan")
    return pk, pv, tables


def frontend_kernel_cases(torch, gen) -> tuple[list, list]:
    """The frontends phase's new K1 / K2 modes and shapes, rows of the K1 and
    K2 entries.  K1 non-causal at whisper-small's encoder (B8 S1500 H12 D64:
    1500 = 23 x 64 + 28, so only the `hi(r) = T` bound masks the last
    tile's padded KV columns) and ragged at S1000, K1 causal at
    internvl2-1b's prefill (B4 S768, G = 7), each against float64
    (`check_exact`) and timed beside SDPA; K2 over whisper's cross cache
    (B8 T1500 K12 G1 D64 at index T - 1: the fixed full prefix, one live q
    row of the split route's 16), against its plain version, two calls the
    same bits and every request's rows alone those of the batch."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_decode
    from repro_torch.kernels.flash_attention.ref import attention_ref, decode_ref

    k1 = []
    for name, B, S, H, K, causal in [
        ("whisper_encoder_B8_S1500_H12_K12_D64_noncausal_bf16", 8, 1500, 12, 12, False),
        ("noncausal_ragged_B8_S1000_H12_K12_D64_bf16", 8, 1000, 12, 12, False),
        ("internvl_prefill_B4_S768_H14_K2_D64_bf16", 4, 768, 14, 2, True),
    ]:
        D, G = 64, H // K
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, S, K, D), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, S, K, D), generator=gen, device="cuda").to(torch.bfloat16)
        got = flash_attention(q, k, v, causal=causal)
        want = exact(attention_ref, (q, k, v), causal=causal)
        plain_out = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, rms = check_exact(torch, name, got, want, BF16_TOL)
        err_plain = (got.float() - plain_out.float()).abs().max().item()
        plain_err = exact_error(torch, plain_out, want)[0]
        del want, plain_out
        ms = time_ms(torch, [lambda: flash_attention(q, k, v, causal=causal)], 5)
        plain = time_ms(torch, [lambda: attention_ref(q, k, v, causal=causal)], 3)
        qt = q.transpose(1, 2)
        kt = k.transpose(1, 2).repeat_interleave(G, dim=1)
        vt = v.transpose(1, 2).repeat_interleave(G, dim=1)
        lib = time_ms(torch, [lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)], 5)
        del kt, vt
        flops = 4.0 * D * B * live_pairs(S, S, causal, None) * H
        nbytes = 2 * q.numel() * q.element_size() + (k.numel() + v.numel()) * k.element_size()
        b_ms, b_by = bound(nbytes, flops, "bf16")
        k1.append(dict(case=name, main=False, causal=causal, max_abs_err=err, ref_rms=rms,
                       max_abs_err_vs_fp32_plain=err_plain, fp32_plain_max_abs_err=plain_err,
                       ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                       ms_over_library_ms=ms / lib))

    name = "whisper_cross_B8_T1500_H12_K12_D64_index1499_bf16"
    B, T, H, K, D = 8, 1500, 12, 12, 64
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    index = torch.full((B,), T - 1, dtype=torch.int32, device="cuda")
    got = flash_decode(q, k, v, index)
    torch.cuda.synchronize()
    extra = split_gates(torch, name, got, lambda: flash_decode(q, k, v, index),
                        lambda b: flash_decode(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                               index[b:b + 1]), [T - 1] * B)
    for b in range(1, B):  # every index is the same: `split_gates` held request 0
        if not torch.equal(flash_decode(q[b:b + 1], k[b:b + 1], v[b:b + 1], index[b:b + 1]),
                           got[b:b + 1]):
            raise AssertionError(f"{name}: request {b}'s rows depend on its batch")
    err, rms = check_close(torch, name, got, decode_ref(q, k, v, index), BF16_TOL)
    # four copies of the 36.9 MB cache keep each launch's reads cold in the L2
    copies = [(k, v)] + [(k.clone(), v.clone()) for _ in range(3)]
    ms = time_ms(torch, [(lambda kk=kk, vv=vv: flash_decode(q, kk, vv, index))
                         for kk, vv in copies], 20, graph=True)
    plain = time_ms(torch, [lambda: decode_ref(q, k, v, index)], 2)
    qt = q.transpose(1, 2)
    libs = [(kk.transpose(1, 2), vv.transpose(1, 2)) for kk, vv in copies]
    lib = time_ms(torch, [(lambda kk=kk, vv=vv: F.scaled_dot_product_attention(qt, kk, vv))
                          for kk, vv in libs], 20, graph=True)
    nbytes = (B * T * K * D * 2 + 2 * q.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, 4.0 * D * B * T * H, "bf16")
    k2 = [dict(case=name, main=False, max_abs_err=err, ref_rms=rms, ms=ms, plain_ms=plain,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib, gb_s=nbytes / ms / 1e6,
               **extra)]
    return k1, k2


def widened_decode_cases(torch, gen):
    """K2's tensor-core mode: S > 1 bf16 tokens over bf16 values (K1's body).
    Main: the continuous path's suffix prefill, 512 yi-6b tokens over a
    1024-token prefix resident in a shuffled page pool (dead pages NaN);
    besides, four tokens per request over ragged dense caches, and over a
    windowed pool, which must equal the dense cache bit for bit.  Held, as
    K1, to the plain version evaluated in float64; timed with its plain
    version and SDPA over the gathered K / V with a prebuilt mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
    from repro_torch.kernels.flash_attention.ops import flash_decode, paged_gather_kv
    from repro_torch.kernels.flash_attention.ref import decode_ref

    H, K, D = 32, 4, 128
    cases = []
    ragged = [199, 511, 1023, 1500, 2047, 2999, 3500, 4095]
    for name, idx, S, T, window, paged, main in [
        ("yi6b_suffix512_over_prefix1024_paged_bf16", [1024], 512, 1536, None, True, True),
        ("q_span4_T4096_ragged_bf16", [i - 3 for i in ragged], 4, 4096, None, False, False),
        ("paged_window512_q_span4_bf16", [i - 3 for i in ragged], 4, 4096, 512, True, False),
    ]:
        B = len(idx)
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        kw = dict(window=window)
        if paged:
            pk, pv, tables = poisoned_pool(torch, gen, k, v, idx, 128, window, S)
            kw.update(tables=tables, kv_len=T)
        else:
            pk, pv = k, v
        got = flash_decode(q, pk, pv, index, **kw)
        torch.cuda.synchronize()
        if flash_decode_fwd.last_route != "tc":
            raise AssertionError(f"{name}: launched the {flash_decode_fwd.last_route} mode")
        extra = {}
        if not paged:
            # printed, not gated (speculative decoding's "verify == greedy"
            # compares these rows): token s as a single-token call at index
            # + s, on the split route, against its row of the widened call
            singles = torch.cat([flash_decode(q[:, s:s + 1], k, v, index + s, window=window)
                                 for s in range(S)], dim=1)
            torch.cuda.synchronize()
            if flash_decode_fwd.last_route != "tc_split":
                raise AssertionError(f"{name}: single tokens took the "
                                     f"{flash_decode_fwd.last_route} route")
            diff = (singles.float() - got.float()).abs()
            extra["single_token_vs_widened_row_max_abs_diff"] = diff.max().item()
            extra["single_token_vs_widened_rows_bitwise_equal_share"] = \
                (diff == 0).all(dim=-1).float().mean().item()
        if paged and not main:
            dense = flash_decode(q, k, v, index, window=window)
            torch.cuda.synchronize()
            if not torch.equal(dense, got):
                raise AssertionError(f"{name}: paged output differs from dense output")
            extra["bitwise_equal_to_dense"] = True
        want = exact(decode_ref, (q, pk, pv), index=index, **kw)
        err, rms = check_exact(torch, name, got, want, BF16_TOL)
        plain_out = decode_ref(q, pk, pv, index, **kw)
        extra["max_abs_err_vs_fp32_plain"] = (got.float() - plain_out.float()).abs().max().item()
        extra["fp32_plain_max_abs_err"] = exact_error(torch, plain_out, want)[0]
        del want, plain_out
        ms = time_ms(torch, [lambda: flash_decode(q, pk, pv, index, **kw)], 20)
        plain = time_ms(torch, [lambda: decode_ref(q, pk, pv, index, **kw)], 2)
        # the library: SDPA over the logical K / V (gathered from the pool
        # outside the timed region) with a per-request boolean mask
        kd, vd = (paged_gather_kv(pk, pv, tables, T) if paged else (k, v))
        G = H // K
        kt = kd.transpose(1, 2).repeat_interleave(G, dim=1)
        vt = vd.transpose(1, 2).repeat_interleave(G, dim=1)
        last = (index[:, None] + torch.arange(S, device="cuda"))[:, None, :, None]
        kp = torch.arange(T, device="cuda")
        mask = kp < (last + 1).clamp(1, T)
        if window is not None:
            mask = mask & (kp > last - window)
        qt = q.transpose(1, 2)
        lib = time_ms(torch, [lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                     attn_mask=mask)], 10)
        pairs = int(mask.sum().item())
        live = int(mask.any(dim=2).sum().item())  # K / V slots some row sees
        nbytes = (live * K * D * 2 + 2 * q.numel()) * q.element_size()
        b_ms, b_by = bound(nbytes, 4.0 * D * pairs * H, "bf16")
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                          ms_over_library_ms=ms / lib, **extra))
        del q, k, v, pk, pv, kd, vd, kt, vt, mask
    torch.cuda.empty_cache()
    return cases


def quantized_decode_cases(torch, gen):
    """K2d: flash decode over int8 / fp8 codes with fp32 per-page scales, at
    the K2 main case's shapes.  Each case is held against its plain version;
    besides, a paged pool and a dense cache of the same codes and scales must
    agree bit for bit (shuffled tables, dead pages poisoned), and the int8
    output must stay within 0.05 of K2 over the bf16 values it quantizes
    (the reference's bound, benchmarks/quantized_cache.py:53)."""
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd, paged_decode_schedule
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
        ("paged_float8_e5m2_T4096_page128", "float8_e5m2", 1, False),
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
        torch.cuda.synchronize()
        if S == 1:  # one bf16 token over codes: the split route
            extra = split_gates(
                torch, name, got, lambda: flash_decode(q, pk, pv, index, **kw),
                lambda b: flash_decode(q[b:b + 1], pk, pv, index[b:b + 1],
                                       **{**kw, "tables": tables[b:b + 1]}), idx)
        elif flash_decode_fwd.last_route != "tc":  # widened q over codes
            raise AssertionError(f"{name}: launched the {flash_decode_fwd.last_route} route")
        else:
            extra = {"route": "tc"}
        dense = flash_decode(q, kc, vc, index, k_scale=ks, v_scale=vs, scale_page=ps)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: a dead page reached the output")
        if not torch.equal(got, dense):
            raise AssertionError(f"{name}: paged output differs from dense output")
        if S == 1:
            want = decode_ref(q, pk, pv, index, **kw)
            err, rms = check_close(torch, name, got, want, BF16_TOL)
        else:  # the tensor-core mode, held as K2's widened q over values
            err, rms = check_exact(torch, name, got, exact_codes(decode_ref, q, pk, pv, index,
                                                                  kw), BF16_TOL)
        # against K2 over the bf16 values the codes quantize
        fp = flash_decode(q, k, v, index)
        vs_fp = (got.float() - fp.float()).abs().max().item()
        if dtype_name == "int8" and not vs_fp <= QUANT_VS_FP_TOL:
            raise AssertionError(f"{name}: {vs_fp} from the bf16 cache's output "
                                 f"(bound {QUANT_VS_FP_TOL})")
        # the main case's pool (2 x 34 MB) copied so that each launch finds
        # it cold in the 50 MB L2; launches replayed from a CUDA graph
        copies = [(pk, pv)] + [(pk.clone(), pv.clone()) for _ in range(3 if main else 0)]
        ms = time_ms(torch, [(lambda kk=kk, vv=vv: flash_decode(q, kk, vv, index, **kw))
                             for kk, vv in copies], 20, graph=True)
        del copies
        plain = time_ms(torch, [lambda: decode_ref(q, pk, pv, index, **kw)], 2)
        slots = sum(max(0, max(1, min(T, i + S))) for i in idx)
        pages = sum(-(-max(1, min(T, i + S)) // ps) for i in idx)
        nbytes = (slots * K * D * 2 * pk.element_size() + pages * K * 2 * 4
                  + 2 * q.numel() * q.element_size())
        b_ms, b_by = bound(nbytes, 4.0 * D * slots * S * H, "bf16")
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                          gb_s=nbytes / ms / 1e6, bitwise_equal_to_dense=True,
                          max_abs_err_vs_bf16_cache=vs_fp, **extra))
        del pk, pv, kc, vc

    # a dense int8 cache, one scale row per 128 slots
    dt = torch.int8
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    index = torch.tensor(ragged, dtype=torch.int32, device="cuda")
    kc, ks = quantize(k, dt)
    vc, vs = quantize(v, dt)
    kw = dict(k_scale=ks, v_scale=vs, scale_page=ps)
    got = flash_decode(q, kc, vc, index, **kw)
    torch.cuda.synchronize()
    extra = split_gates(
        torch, "dense_int8_scale_page128", got, lambda: flash_decode(q, kc, vc, index, **kw),
        lambda b: flash_decode(q[b:b + 1], kc[b:b + 1], vc[b:b + 1], index[b:b + 1],
                               k_scale=ks[b:b + 1], v_scale=vs[b:b + 1], scale_page=ps),
        ragged)
    want = decode_ref(q, kc, vc, index, **kw)
    torch.cuda.synchronize()
    err, rms = check_close(torch, "dense_int8_scale_page128", got, want, BF16_TOL)
    ms = time_ms(torch, [lambda: flash_decode(q, kc, vc, index, **kw)], 20, graph=True)
    cases.append(dict(case="dense_int8_scale_page128", main=False, max_abs_err=err,
                      ref_rms=rms, ms=ms, plain_ms=None, bound_ms=None, bound_by=None,
                      library_ms=None, **extra))

    return cases


def widened_codes_cases(torch, gen):
    """K2d's widened q over codes on the tensor cores (flash_decode.cu route
    1 over int8 / fp8 codes), at the continuous path's shapes: a 512-token
    yi-6b suffix over a 1024-token prefix in a shuffled page pool — what the
    quantized pool's suffix prefills launch — over int8, e4m3 and e5m2
    codes, the int8 codes also as a dense cache with a scale row every 128
    slots (bit for bit the pool's output), and a quantized pool's first
    prefill, 1024 tokens at index 0 (main: run (c)'s 32 first prefills; K1
    read the dequantized fp32 values for them before, the
    `fp32_kv_S1024_bf16` prefill case).  Each must report the tensor-core
    route and is held, as K2's widened q over values, to the plain version
    in float64 (`exact_error`); the error against the tc route over the
    bf16 values the codes quantize is printed, and so is that route's time
    (`values_tc_ms`).  One case at gemma-2b's head (8 q heads over 1 KV
    head of 256) times the D-256 instantiation, which spills, against the
    same shape over bf16 values."""
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
    from repro_torch.kernels.flash_attention.ops import (
        flash_decode,
        kv_scale_from_absmax,
        quantize_kv_write,
        resolve_cache_dtype,
    )
    from repro_torch.kernels.flash_attention.ref import decode_ref

    ps = 128
    inputs = {}

    def head(H, K, D):  # K / V of 1536 slots and q of 512 and 1024 tokens, once a head
        if (H, K, D) not in inputs:
            kv = [torch.randn((1, 1536, K, D), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2)]
            inputs[H, K, D] = kv, {
                S: torch.randn((1, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
                for S in (512, 1024)}
        return inputs[H, K, D]

    yi, gemma = (32, 4, 128), (8, 1, 256)
    cases, outputs = [], {}
    for name, dtype_name, S, Tw, layout, main, shape in [
        ("paged_int8_suffix512_over_prefix1024", "int8", 512, 1536, "paged", False, yi),
        ("paged_float8_e4m3fn_suffix512_over_prefix1024", "float8_e4m3fn", 512, 1536,
         "paged", False, yi),
        ("paged_float8_e5m2_suffix512_over_prefix1024", "float8_e5m2", 512, 1536, "paged",
         False, yi),
        ("dense_int8_scale_page128_suffix512_over_prefix1024", "int8", 512, 1536, "dense",
         False, yi),
        ("paged_int8_first_prefill_S1024", "int8", 1024, 1024, "paged", True, yi),
        ("paged_int8_D256_H8_K1_suffix512_over_prefix1024", "int8", 512, 1536, "paged",
         False, gemma),
    ]:
        H, K, D = shape
        (k, v), qs = head(H, K, D)
        dt = resolve_cache_dtype(dtype_name)
        nbw = Tw // ps
        q = qs[S]
        codes, scales = [], []
        for x in (k, v):
            pages = x[:, :Tw].float().reshape(nbw, ps, K, D)
            sc = kv_scale_from_absmax(pages.abs().amax(dim=(1, 3)), dt)
            codes.append(quantize_kv_write(pages, sc[:, None, :], dt))
            scales.append(sc)
        index = torch.tensor([Tw - S], dtype=torch.int32, device="cuda")
        if layout == "paged":
            perm = torch.randperm(nbw, generator=gen, device="cuda")
            pooled = [torch.empty_like(t_) for t_ in codes + scales]
            for dst, src_ in zip(pooled, codes + scales):
                dst[perm] = src_
            kc, vc = pooled[0], pooled[1]
            kw = dict(tables=perm[None].to(torch.int32), kv_len=Tw, k_scale=pooled[2],
                      v_scale=pooled[3])
        else:
            kc, vc = (c.reshape(1, Tw, K, D) for c in codes)
            kw = dict(k_scale=scales[0][None], v_scale=scales[1][None], scale_page=ps)
        got = flash_decode(q, kc, vc, index, **kw)
        torch.cuda.synchronize()
        if flash_decode_fwd.last_route != "tc":
            raise AssertionError(f"{name}: launched the {flash_decode_fwd.last_route} route")
        extra = {"route": "tc"}
        if layout == "dense":  # the int8 pool's codes and scales, laid out densely
            if not torch.equal(got, outputs[dtype_name, S, shape]):
                raise AssertionError(f"{name}: dense output differs from the paged output")
            extra["bitwise_equal_to_paged"] = True
        outputs[dtype_name, S, shape] = got
        err, rms = check_exact(torch, name, got, exact_codes(decode_ref, q, kc, vc, index, kw),
                               BF16_TOL)
        values = (k[:, :Tw], v[:, :Tw])
        fp = flash_decode(q, *values, index)
        extra["max_abs_err_vs_bf16_values"] = (got.float() - fp.float()).abs().max().item()
        ms = time_ms(torch, [lambda: flash_decode(q, kc, vc, index, **kw)], 20)
        plain = time_ms(torch, [lambda: decode_ref(q, kc, vc, index, **kw)], 2)
        extra["values_tc_ms"] = time_ms(torch, [lambda: flash_decode(q, *values, index)], 20)
        pairs = S * (Tw - S) + S * (S + 1) // 2
        nbytes = Tw * K * D * 2 + nbw * K * 2 * 4 + 2 * q.numel() * q.element_size()
        b_ms, b_by = bound(nbytes, 4.0 * D * pairs * H, "bf16")
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                          **extra))
        del codes, scales, kc, vc, kw, got, fp
    del k, v, qs, inputs, outputs
    torch.cuda.empty_cache()
    return cases


def verify_decode_cases(torch, gen):
    """K2's widened mode at the speculative verify step's shape
    (`speculative_phase`): yi-6b's eight requests, S = k+1 bf16 tokens (k =
    2, and 4 beside), each over ~1050-1100 resident slots of a shuffled
    128-slot page pool (dead pages NaN) 4096 slots wide.  Held, as K1, to
    the plain version in float64, and to the same bits on a second call;
    printed: how far a single-token row (the split route, as a plain decode
    step computes it) lies from the widened row of the same token.  Timed
    from a CUDA graph (one call is shorter than Python takes to issue it),
    with its plain version and SDPA over the gathered K / V with a prebuilt
    mask."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
    from repro_torch.kernels.flash_attention.ops import flash_decode, paged_gather_kv
    from repro_torch.kernels.flash_attention.ref import decode_ref

    B, H, K, D, T = 8, 32, 4, 128, 4096
    idx = [1050 + 7 * b for b in range(B)]
    cases = []
    for S, main in ((3, True), (5, False)):
        name = f"yi6b_verify_B8_S{S}_paged128_index1050_1099_bf16"
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        pk, pv, tables = poisoned_pool(torch, gen, k, v, idx, 128, None, S)
        kw = dict(tables=tables, kv_len=T)
        got = flash_decode(q, pk, pv, index, **kw)
        torch.cuda.synchronize()
        if flash_decode_fwd.last_route != "tc":
            raise AssertionError(f"{name}: launched the {flash_decode_fwd.last_route} mode")
        if not torch.equal(got, flash_decode(q, pk, pv, index, **kw)):
            raise AssertionError(f"{name}: a second call gave other bits")
        singles = torch.cat([flash_decode(q[:, s:s + 1], pk, pv, index + s, **kw)
                             for s in range(S)], dim=1)
        torch.cuda.synchronize()
        if flash_decode_fwd.last_route != "tc_split":
            raise AssertionError(f"{name}: single tokens took the "
                                 f"{flash_decode_fwd.last_route} route")
        diff = (singles.float() - got.float()).abs()
        extra = {"single_token_vs_verify_row_max_abs_diff": diff.max().item(),
                 "single_token_vs_verify_rows_bitwise_equal_share":
                     (diff == 0).all(dim=-1).float().mean().item()}
        want = exact(decode_ref, (q, pk, pv), index=index, **kw)
        err, rms = check_exact(torch, name, got, want, BF16_TOL)
        plain_out = decode_ref(q, pk, pv, index, **kw)
        extra["max_abs_err_vs_fp32_plain"] = (got.float() - plain_out.float()).abs().max().item()
        extra["fp32_plain_max_abs_err"] = exact_error(torch, plain_out, want)[0]
        del want, plain_out
        ms = time_ms(torch, [lambda: flash_decode(q, pk, pv, index, **kw)], 20, graph=True)
        plain = time_ms(torch, [lambda: decode_ref(q, pk, pv, index, **kw)], 2)
        kd, vd = paged_gather_kv(pk, pv, tables, T)
        G = H // K
        kt = kd.transpose(1, 2).repeat_interleave(G, dim=1)
        vt = vd.transpose(1, 2).repeat_interleave(G, dim=1)
        last = (index[:, None] + torch.arange(S, device="cuda"))[:, None, :, None]
        mask = torch.arange(T, device="cuda") < (last + 1).clamp(1, T)
        qt = q.transpose(1, 2)
        lib = time_ms(torch, [lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                     attn_mask=mask)],
                      10, graph=True)
        pairs = int(mask.sum().item())
        live = int(mask.any(dim=2).sum().item())  # K / V slots some row sees
        nbytes = (live * K * D * 2 + 2 * q.numel()) * q.element_size()
        b_ms, b_by = bound(nbytes, 4.0 * D * pairs * H, "bf16")
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                          ms_over_library_ms=ms / lib, card=nvidia_smi_line(), **extra))
        del q, k, v, pk, pv, kd, vd, kt, vt, mask
    torch.cuda.empty_cache()
    return cases


def shared_prefill_identity(torch, gen) -> dict:
    """The design property behind "a prefix-shared admission serves the same
    tokens as an unshared one": the whole prompt's first prefill and the
    widened-q decode kernel over its suffix, against the prefix resident in
    a shuffled page pool, walk the same 64-slot tiles with the same online
    softmax — so the suffix rows agree bit for bit.  Checked at yi-6b's
    shapes (prefix 1024, suffix 200), over a bf16 pool (the whole prompt
    through the prefill kernel; both on the tensor-core body, attend_tc.cuh)
    and an int8 pool (the whole prompt through the widened-q decode kernel
    at index 0 over the pool's codes, as a quantized pool's first prefill
    attends; both on the tensor-core body over codes, scales factored
    out)."""
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_decode
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
            full = flash_attention(q, k[None], v[None], causal=True)
            first = flash_attention_fwd.last_route
            ck, cv, kw = pk, pv, {}
        else:
            ck, cv, ksc, vsc = quantize_linear_pool(pk, pv, "int8")
            kw = dict(k_scale=ksc, v_scale=vsc)
            full = flash_decode(q, ck, cv, torch.zeros_like(index), tables=tables, kv_len=S,
                                **kw)
            first = flash_decode_fwd.last_route
        suffix = flash_decode(q[:, P:], ck, cv, index, tables=tables, kv_len=S, **kw)
        torch.cuda.synchronize()
        routes = (first, flash_decode_fwd.last_route)
        if routes != ("tc", "tc"):
            raise AssertionError(f"{pool} pool: routes (whole prompt, suffix) {routes}")
        if not torch.equal(full[:, P:], suffix):
            diff = (full[:, P:].float() - suffix.float()).abs().max().item()
            raise AssertionError(f"{pool} pool: suffix-over-prefix rows differ from the "
                                 f"whole-prompt prefill by up to {diff}")
        out[f"{pool}_pool_suffix_rows_bitwise_equal"] = True
        out[f"{pool}_pool_routes"] = routes
    return out


def rglru_inputs(torch, gen, B, S, D):
    """K5's inputs: decays in (0, 1), gated inputs and a nonzero initial state."""
    return (torch.rand((B, S, D), generator=gen, device="cuda"),
            torch.randn((B, S, D), generator=gen, device="cuda"),
            torch.randn((B, D), generator=gen, device="cuda"))


def rglru_bytes(B, S, D) -> int:
    """a and b read once, y written once, h0 read and h_last written."""
    return 4 * (3 * B * S * D + 2 * B * D)


def rglru_time(torch, a, b, h0) -> float:
    """K5's device time: CUDA events around the replay of a CUDA graph of at
    least 20 calls (issued one by one, the wrapper's Python sets the pace:
    ~0.03 ms a call on the H100 machine's host, longer than the kernel at most
    shapes here), one a copy of the inputs, with enough copies that one cycle
    moves three times the 50 MB L2 (three at the main shape): every call finds
    its inputs cold, as a prefill does."""
    from repro_torch.kernels.rglru.ops import rglru

    n = -(-3 * L2_BYTES // rglru_bytes(*a.shape))
    copies = [(a, b)] + [(a.clone(), b.clone()) for _ in range(n - 1)]
    return time_ms(torch, [(lambda aa=aa, bb=bb: rglru(aa, bb, h0)) for aa, bb in copies],
                   max(20, n), graph=True)


def rglru_cases(torch, gen):
    """K5: the RG-LRU scan against its plain version, fp32 with a nonzero
    initial state: the main case, the recurrent serve's solo prefill (B2
    S512) and longest prompt (B1 S3000), one step, ragged lengths, a D that
    is no multiple of the slab (B1 S257 D2568) and one that is no multiple
    of 4 (the kernel's 4-byte feed).  The kernel repeats the plain version's
    two roundings per step in the same order, so y and h_last are gated bit
    for bit on every case (and at the fp32 bound, whose error reads 0).  The
    main case's CUDA launches are counted from a profiler trace and gated
    at 1 (`cuda_launches_per_call`)."""
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rglru.ref import rglru_scan

    cases = []
    for name, B, S, D, main in [("rgemma_B1_S2048_D2560_fp32", 1, 2048, 2560, True),
                                ("B2_S512_D2560_fp32", 2, 512, 2560, False),
                                ("B1_S3000_D2560_fp32", 1, 3000, 2560, False),
                                ("B1_S1_D2560_fp32", 1, 1, 2560, False),
                                ("B1_S17_D2560_fp32", 1, 17, 2560, False),
                                ("B2_S1000_D2560_fp32", 2, 1000, 2560, False),
                                ("B1_S257_D2568_fp32", 1, 257, 2568, False),
                                ("B3_S33_D1001_fp32", 3, 33, 1001, False)]:
        a, b, h0 = rglru_inputs(torch, gen, B, S, D)
        y, h_last = rglru(a, b, h0)
        y_ref, h_ref = rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        err, rms = check_close(torch, name, y, y_ref, FP32_TOL)
        check_close(torch, name + "/h_last", h_last, h_ref, FP32_TOL)
        if not (torch.equal(y, y_ref) and torch.equal(h_last, h_ref)):
            raise AssertionError(f"{name}: y / h_last are not bit for bit the plain scan's")
        ms = rglru_time(torch, a, b, h0)
        plain = time_ms(torch, [lambda: rglru_scan(a, b, h0)], 1)
        nbytes = rglru_bytes(B, S, D)
        b_ms, b_by = bound(nbytes, 2.0 * B * S * D, "fp32")
        extra = {}
        if main:
            n = device_kernels(torch, lambda: rglru(a, b, h0), "rglru")
            if n != 1:
                raise AssertionError(f"{name}: {n} CUDA launches a call, not 1")
            extra["cuda_launches_per_call"] = n
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                          gb_s=nbytes / ms / 1e6, bitwise_equal=True, **extra))
    return cases


def rglru_serve_times(torch, gen) -> dict:
    """K5's time at each prefill shape of the recurrent serve
    (`serve_recurrent`): the solo `serve`, then each `serve_batch` prompt
    alone, at recurrentgemma-2b's width."""
    out = {}
    for B, S in [SERVE_SOLO] + [(1, n) for n in SERVE_BATCH_LENS]:
        out[f"B{B}_S{S}"] = rglru_time(torch, *rglru_inputs(torch, gen, B, S, 2560))
    return out


def wkv_cases(torch, gen):
    """K6: the WKV recurrence against its plain version, bf16 r / k / v, fp32
    decays and a nonzero fp32 initial state; a ragged length and strong decays
    (w = exp(-exp(3 N(0,1)))) besides the main case, and rwkv6-3b's prefill
    shape (B2 S512).  Gated at the reference test's own scale-aware
    tolerance (tests/test_kernels.py, TestWKV6): rtol 5e-3, atol 5e-3 (max
    |y| + 1) for y, 5e-3 for the last state.  An fp32 case is gated at
    FP32_TOL against the chunk-parallel twin (`wkv_chunk_parallel`, the
    kernel's own order of sums); its error against the sequential form is
    printed beside.  The CUDA launches of one main-case call are counted
    from a `torch.profiler` trace of it (`cuda_launches_per_call`).
    The kernel's products run on the tensor cores: `bound_ms` is the larger
    of the bytes bound and the operations at the bf16 tensor-core rate, the
    operations at fp32's rate printed beside (`bound_ms_fp32_ops`)."""
    from repro_torch.kernels.rwkv6.kernel import CHUNK
    from repro_torch.kernels.rwkv6.ops import wkv
    from repro_torch.kernels.rwkv6.ref import wkv_chunk_parallel, wkv_scan

    def check(name, y, s_last, y_ref, s_ref):
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
        return dy.max().item(), ds.max().item(), scale

    cases = []
    for name, B, S, H, decay, dtype, main in [
        ("rwkv6_B1_S2048_H40_C64_bf16", 1, 2048, 40, 0.5, torch.bfloat16, True),
        ("ragged_B2_S1000_H40_C64_bf16", 2, 1000, 40, 0.5, torch.bfloat16, False),
        ("strong_decay_B1_S512_H40_C64_bf16", 1, 512, 40, 3.0, torch.bfloat16, False),
        ("rwkv6_prefill_B2_S512_H40_C64_bf16", 2, 512, 40, 0.5, torch.bfloat16, False),
        ("ragged_B2_S1000_H40_C64_fp32", 2, 1000, 40, 3.0, torch.float32, False),
    ]:
        C = 64
        r, k, v = (torch.randn((B, S, H, C), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        w = torch.exp(-torch.exp(decay * torch.randn((B, S, H, C), generator=gen, device="cuda")))
        u = 0.5 * torch.randn((H, C), generator=gen, device="cuda")
        s0 = torch.randn((B, H, C, C), generator=gen, device="cuda")
        y, s_last = wkv(r, k, v, w, u, s0)
        y_ref, s_ref = wkv_scan(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        err, err_state, scale = check(name, y, s_last, y_ref, s_ref)
        extra = {"max_abs_err_state": err_state, "y_scale": scale, "chunk": CHUNK}
        if dtype == torch.float32:  # held to the twin in its order of sums
            y_tw, s_tw = wkv_chunk_parallel(r, k, v, w, u, s0, chunk=CHUNK)
            extra["max_abs_err_vs_wkv_scan"] = err
            err, _ = check_close(torch, name, y, y_tw, FP32_TOL)
            check_close(torch, name + "/s_last", s_last, s_tw, FP32_TOL)
        rms = y_ref.float().pow(2).mean().sqrt().item()
        ms = time_ms(torch, [lambda: wkv(r, k, v, w, u, s0)], 10)
        if main:
            extra["cuda_launches_per_call"] = device_kernels(
                torch, lambda: wkv(r, k, v, w, u, s0), "wkv6_")
        plain = time_ms(torch, [lambda: wkv_scan(r, k, v, w, u, s0)], 1)
        el = r.element_size()
        nbytes = B * S * H * C * (3 * el + 4 + el) + 4 * H * C + 2 * 4 * B * H * C * C
        flops = B * S * H * (5.0 * C * C + 4.0 * C)
        b_ms, b_by = bound(nbytes, flops, "bf16")
        extra["bound_ms_fp32_ops"] = bound(nbytes, flops, "fp32")[0]
        cases.append(dict(case=name, main=main, max_abs_err=err, ref_rms=rms, ms=ms,
                          plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                          **extra))
    return cases


def by_kv_head_grads(fn, axes):
    """`fn` (K1's plain forward with lse, or K3's plain backward) taken one
    KV head and its q group at a time, its outputs joined on `axes` (the
    head axis of each: 2 for (B, S, H, D) and (B, T, K, D), 1 for lse (B,
    H, S)): mixtral's 6144-token backward holds 7.2 GB of fp32 scores a
    tensor over all 48 heads, five such tensors at once."""
    import torch

    def run(q, k, v, *rest, **kw):
        K = k.shape[2]
        G = q.shape[2] // K
        parts = []
        for g in range(K):
            heads = slice(g * G, (g + 1) * G)
            cut = [t[:, heads] if t.dim() == 3 else t[:, :, heads] for t in rest]
            parts.append(fn(q[:, :, heads], k[:, :, g:g + 1], v[:, :, g:g + 1], *cut, **kw))
        return tuple(torch.cat(outs, dim=axis) for axis, outs in zip(axes, zip(*parts)))

    return run


def flash_bwd_cases(torch, gen):
    """K1's lse mode and the two passes of K3, at the training path's shapes
    (gemma-2b's microbatch is the main case) and at yi-6b's, a window, a
    softcap, a ragged length and fp32, and at the shapes the families train
    at (`train_families_phase`): whisper-small's encoder, non-causal over a
    ragged 1500 (G 1, D 64), and its causal decoder; recurrentgemma-2b's
    local attention (G 10, D 256, window 2048 at S 4096, which prunes);
    mixtral-8x22b's (G 6, window 4096 at S 6144, held by KV head in
    float64, `by_kv_head_grads`) and grok-1-314b's soft-cap 30.  Each case
    runs K1 with lse on
    random q / k / v, holds out and lse to the plain forward, then runs K3
    on those residuals and a random dO and holds dq, dk, dv to the plain
    backward on the same residuals — both plain versions evaluated exactly
    (`exact`), every output within the forward cases' gates — and runs K3
    once more on the same inputs, which must give the same bits.  Timed: K1
    with lse; each pass alone (pass 1 also writes delta; pass 2 reads it,
    and its reduce of the split partials is read apart under the profiler)
    and both together, as training launches them; the
    plain forward and backward; and the one-call library backward (SDPA's,
    through `torch.autograd.grad`): over the mask given by `is_causal`
    without a window, over a prebuilt boolean mask and K / V repeated to
    the q heads with one, none with a softcap (SDPA has none).  Bounds: K1 four flops per D per live pair and
    head; pass 1 three products of 2 D (QK^T, dO V^T, dS K), pass 2 four
    (QK^T, dO V^T, P^T dO, dS^T Q), the pair five, each against the bytes
    it must read and write."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

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
        # the families' training shapes (`train_families_phase`)
        ("whisper_enc_B8_S1500_H12_K12_D64_noncausal_bf16", 8, 1500, 12, 12, 64,
         torch.bfloat16, dict(causal=False), BF16_TOL, False),
        ("whisper_dec_B8_S448_H12_K12_D64_bf16", 8, 448, 12, 12, 64, torch.bfloat16, {},
         BF16_TOL, False),
        ("rgemma_B1_S4096_H10_K1_D256_w2048_bf16", 1, 4096, 10, 1, 256, torch.bfloat16,
         dict(window=2048), BF16_TOL, False),
        ("mixtral_B1_S6144_H48_K8_D128_w4096_bf16", 1, 6144, 48, 8, 128, torch.bfloat16,
         dict(window=4096), BF16_TOL, False),
        ("grok_B1_S2048_H48_K8_D128_softcap30_bf16", 1, 2048, 48, 8, 128, torch.bfloat16,
         dict(softcap=30.0), BF16_TOL, False),
    ]:
        kw = {"causal": True, **kw}
        causal = kw["causal"]
        large = B * S * S * H > 1e9  # float64 scores past ~8 GB a tensor: by KV head
        fwd_ref = by_kv_head_grads(attention_ref, (2, 1)) if large else attention_ref
        bwd_ref = (by_kv_head_grads(flash_attention_bwd_ref, (2, 2, 2)) if large
                   else flash_attention_bwd_ref)
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, K, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, K, D), generator=gen, device="cuda").to(dtype)
        do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        out, lse = fa_kernel.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        want_out, want_lse = exact(fwd_ref, (q, k, v), return_lse=True, **kw)
        plain = fwd_ref(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        err, rms = check_exact(torch, name + " out", out, want_out, tol)
        err_lse, rms_lse = check_exact(torch, name + " lse", lse, want_lse, tol)
        # printed beside: every output against the fp32 plain version, and
        # that version's own error against the exact result
        vs_fp32 = {g: (a.float() - b.float()).abs().max().item()
                   for g, a, b in zip(("out", "lse"), (out, lse), plain)}
        plain_err = {g: exact_error(torch, p, w)[0]
                     for g, p, w in zip(("out", "lse"), plain, (want_out, want_lse))}
        del want_out, want_lse, plain
        got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        want = exact(bwd_ref, (q, k, v, out, lse, do), **kw)
        plain = bwd_ref(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        errs = {g: check_exact(torch, f"{name} {g}", a, b, tol)
                for g, a, b in zip(("dq", "dk", "dv"), got, want)}
        for g, a, p, w in zip(("dq", "dk", "dv"), got, plain, want):
            vs_fp32[g] = (a.float() - p.float()).abs().max().item()
            plain_err[g] = exact_error(torch, p, w)[0]
        del want, plain
        # K3 is deterministic: a second call on the same inputs, bit for bit
        again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        if not bitwise:
            raise AssertionError(f"{name}: two K3 calls on the same inputs differ")
        del again

        peak = "bf16" if dtype == torch.bfloat16 else "fp32"
        pairs = live_pairs(S, S, causal, kw.get("window")) * B
        el = q.element_size()
        qbytes, kvbytes, stat = q.numel() * el, k.numel() * el, B * H * S * 4
        ms_fwd = time_ms(torch, [lambda: fa_kernel.flash_attention_fwd(
            q, k, v, return_lse=True, **kw)], 5)
        ms_no_lse = time_ms(torch, [lambda: fa_kernel.flash_attention_fwd(
            q, k, v, **kw)], 5)
        plain_fwd = time_ms(torch, [lambda: fwd_ref(q, k, v, return_lse=True, **kw)], 3)
        delta = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        run_pass = lambda p: fa_kernel.flash_attention_bwd(
            q, k, v, out, lse, do, passes=p, delta=delta, **kw)
        ms_dq = time_ms(torch, [lambda: run_pass(1)], 5)
        ms_dkv = time_ms(torch, [lambda: run_pass(2)], 5)  # delta from pass 1
        ms_pair = time_ms(torch, [lambda: run_pass(3)], 5)
        # pass 2's reduce of the split partials, read apart under the profiler
        n_split = (fa_kernel.dkv_n_split(B, K, S, H // K, torch.cuda.get_device_properties(
            0).multi_processor_count) if dtype == torch.bfloat16 else 1)
        ms_reduce = 0.0
        if n_split > 1:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    run_pass(2)
                torch.cuda.synchronize()
            ms_reduce = sum(_device_us(e) for e in prof.key_averages()
                            if "reduce" in e.key) / 5 / 1e3
        plain_bwd = time_ms(torch, [lambda: bwd_ref(q, k, v, out, lse, do, **kw)], 3)
        lib_fwd = lib_bwd = None
        if "softcap" not in kw:  # one library call: SDPA has no softcap
            qt = q.transpose(1, 2).detach().requires_grad_(True)
            if "window" in kw:  # a boolean mask built outside the timed region
                kt, vt = (x.transpose(1, 2).repeat_interleave(H // K, dim=1).detach()
                          .requires_grad_(True) for x in (k, v))
                pos = torch.arange(S, device="cuda")
                gap = pos[:, None] - pos[None]
                lib_kw = dict(attn_mask=(gap >= 0) & (gap < kw["window"]))
            else:
                kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (k, v))
                lib_kw = dict(is_causal=causal, enable_gqa=True)
            lib_fwd = time_ms(torch, [lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **lib_kw)], 5)
            ot = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
            dot = do.transpose(1, 2)
            lib_bwd = time_ms(torch, [lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dot, retain_graph=True)], 5)
            del qt, kt, vt, ot, lib_kw
        no_lib = ("SDPA takes no softcap" if "softcap" in kw else
                  "SDPA over a prebuilt mask, K / V repeated to the q heads" if "window" in kw
                  else None)
        b_ms, b_by = bound(2 * qbytes + 2 * kvbytes + stat, 4.0 * D * pairs * H, peak)
        lse_cases.append(dict(case=name, main=main, causal=causal, max_abs_err=max(err, err_lse),
                              ref_rms=rms, max_abs_err_lse=err_lse, ref_rms_lse=rms_lse,
                              max_abs_err_vs_fp32_plain=vs_fp32["out"],
                              max_abs_err_lse_vs_fp32_plain=vs_fp32["lse"],
                              fp32_plain_max_abs_err=plain_err["out"],
                              ms=ms_fwd, ms_without_lse=ms_no_lse, plain_ms=plain_fwd,
                              bound_ms=b_ms, bound_by=b_by, library_ms=lib_fwd,
                              ms_over_library_ms=ms_fwd / lib_fwd if lib_fwd else None,
                              library_ms_note=no_lib))
        pair_b, pair_by = bound(3 * qbytes + 2 * kvbytes + stat + qbytes + 2 * kvbytes,
                                10.0 * D * pairs * H, peak)
        both = dict(ms_both_passes=ms_pair, bound_ms_both_passes=pair_b,
                    bound_by_both_passes=pair_by,
                    both_passes_over_library_ms=ms_pair / lib_bwd if lib_bwd else None,
                    both_passes_over_plain_ms=ms_pair / plain_bwd,
                    bitwise_equal_second_call=bitwise, plain_ms_note=(
                        "the plain backward computes dq, dk and dv together"),
                    library_ms_note=no_lib or "the library backward gives dq, dk and dv together")
        # pass 1 reads q, k, v, o, dO, lse and writes dq and delta
        b1, by1 = bound(3 * qbytes + 2 * kvbytes + 2 * stat + qbytes, 6.0 * D * pairs * H, peak)
        dq_cases.append(dict(case=name, main=main, max_abs_err=errs["dq"][0],
                             ref_rms=errs["dq"][1], max_abs_err_vs_fp32_plain=vs_fp32["dq"],
                             fp32_plain_max_abs_err=plain_err["dq"],
                             ms=ms_dq, plain_ms=plain_bwd,
                             bound_ms=b1, bound_by=by1, library_ms=lib_bwd, **both))
        # pass 2 reads q, k, v, dO, lse, delta and writes dk and dv
        b2, by2 = bound(2 * qbytes + 2 * kvbytes + 2 * stat + 2 * kvbytes,
                        8.0 * D * pairs * H, peak)
        worse = max(errs["dk"], errs["dv"], key=lambda e: e[0] / e[1])
        dkv_cases.append(dict(case=name, main=main,
                              max_abs_err=worse[0], ref_rms=worse[1],
                              max_abs_err_dk=errs["dk"][0], ref_rms_dk=errs["dk"][1],
                              max_abs_err_dv=errs["dv"][0], ref_rms_dv=errs["dv"][1],
                              max_abs_err_dk_vs_fp32_plain=vs_fp32["dk"],
                              max_abs_err_dv_vs_fp32_plain=vs_fp32["dv"],
                              fp32_plain_max_abs_err_dk=plain_err["dk"],
                              fp32_plain_max_abs_err_dv=plain_err["dv"],
                              n_split=n_split, ms_reduce=ms_reduce,
                              ms=ms_dkv, plain_ms=plain_bwd, bound_ms=b2, bound_by=by2,
                              library_ms=lib_bwd, **both))
        del q, k, v, do, out, lse, got, delta
        torch.cuda.empty_cache()
    return lse_cases, dq_cases, dkv_cases


def rglru_serve_entry(cases, serve_ms: dict, launches: int) -> dict:
    """K5's main-case figures and its kernel time over the recurrent serve:
    each prefill shape's time x the RG-LRU layers (every prefill launches
    once a layer, so the serve's launches split evenly over its prefills)."""
    layers, rest = divmod(launches, len(serve_ms))
    if rest:
        raise AssertionError(f"rglru: {launches} launches do not split over "
                             f"{len(serve_ms)} prefills")
    main = next(c for c in cases if c["main"])
    total = layers * sum(serve_ms.values())
    log(f"rglru: kernel time over the recurrent serve {total:.4f} ms "
        f"({layers} launches at each of {serve_ms})")
    return {"cuda_launches_per_call": main["cuda_launches_per_call"], "gb_s": main["gb_s"],
            "serve_ms_by_shape": serve_ms, "serve_launches_by_shape": layers,
            "serve_kernel_ms": total}


def device_kernels(torch, fn, match: str) -> int | None:
    """The kernels whose name holds `match` that one call of `fn` runs on
    the card, from a `torch.profiler` trace of it; None when the profiler
    recorded no device activity at all."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        return None
    n = sum(e.count for e in rows if match in e.key)
    if not n:
        raise AssertionError(f"the profiler saw no {match}* kernel in the call")
    return n


def kernel_entry(name, source, replaces, cases, launches, launches_by_run, **extra):
    main = next(c for c in cases if c["main"])
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "launches_by_run": launches_by_run, **extra,
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
    """Where one decode step's time goes over a server's own prefill of
    `toks` (`profile_steps`)."""
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

    return profile_steps(torch, run, steps, f"decode_step_wall_ms_B{B}")


def profile_steps(torch, run, steps: int, wall_key: str) -> dict:
    """`run(n)` (n steps, then a synchronize) timed on the host's clock
    without the profiler, then the same steps under `torch.profiler` for
    the device's busy time and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    run(2)  # warm up
    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)

    # kernel rows only: an operator's row repeats the time of the kernels it launched
    rows = sorted(((_device_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    if busy_ms <= 0:  # the profiler saw no kernel: a reading, not a failed phase
        return {wall_key: wall_ms, "device_busy_ms_per_step": None,
                "device_idle_share": None, "note": "the profiler recorded no device time"}
    return {
        wall_key: wall_ms, "device_busy_ms_per_step": busy_ms,
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
    route_counts(reset=True)
    out = server.serve(np.random.default_rng(1).integers(0, mcfg.vocab, (2, 8), dtype=np.int32))
    got = (flash_attention.launches - before[0], flash_decode.launches - before[1])
    expected = (mcfg.num_layers, mcfg.num_layers * tokens)
    routes = route_counts()
    log(f"reduced: yi-6b reduced, head_dim {mcfg.head_dim}: attention launches {got}, "
        f"expected {expected}; routes {routes}")
    if routes["flash_attention_tc"] != got[0] or routes["flash_decode_split"] != got[1]:
        raise AssertionError(f"reduced configuration: bf16 K1 launches off the tensor-core "
                             f"route or single-token K2 launches off the split route: {routes}")
    if got != expected:
        raise AssertionError(f"reduced configuration: launches {got} != {expected}")
    if out.shape != (2, tokens) or out.min() < 0 or out.max() >= mcfg.vocab:
        raise AssertionError("reduced configuration: tokens of the wrong shape or range")


def profile_wave(torch, gen, batch: int, shares: tuple = ()) -> tuple[dict, dict]:
    """Where one continuous wave's time goes: `gen` (a `serve_stream`
    generator) has just yielded a wave's closing event, so the next `next()`
    runs the following wave whole and yields its first event only after the
    wave's tokens are on the host (the device is done).  That call runs under
    `torch.profiler`; returns the event and the reading.  `shares` names
    kernels (substrings of their symbols) whose device time and share of the
    busy time are reported too."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        first = next(gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((_device_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    reading = {
        "wave": first["wave"], "batch_before": batch, "wave_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms > 0 else None,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms > 0 else None,
        "device_launches_per_wave": sum(r[1] for r in rows),
        "top_kernels_ms": [{"kernel": key[:80], "ms": us / 1e3, "calls": count}
                           for us, count, key in rows[:8]],
    }
    for match in shares:
        ms = sum(us for us, _, key in rows if match in key) / 1e3
        reading[f"{match}_ms"] = ms
        reading[f"{match}_calls"] = sum(c for _, c, key in rows if match in key)
        reading[f"{match}_share_of_busy"] = ms / busy_ms if busy_ms > 0 else None
    return first, reading


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def continuous_traffic(mcfg):
    """The continuous traffic (`continuous_phase`): ten prompts, their
    arrival waves and the serving options."""
    import numpy as np

    rng = np.random.default_rng(1)
    system = rng.integers(0, mcfg.vocab, 1024)
    suffixes = [64, 200, 330, 460, 600, 730, 860, 1024]
    prompts = [np.concatenate([system, rng.integers(0, mcfg.vocab, s)]) for s in suffixes]
    twin = np.concatenate([system, rng.integers(0, mcfg.vocab, 100)])
    prompts += [twin, twin.copy()]
    arrivals = [0] * 6 + [2, 2, 4, 4]
    return prompts, dict(max_batch=8, page_size=128, arrival_waves=arrivals)


def counted_serve(torch, fn):
    """Run `fn` with the serving kernels' launch and route counters at 0 and
    no plain version allowed; returns fn's result, the wall time, the
    counts and the routes."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_decode
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    def forbidden(*a, **k):
        raise AssertionError("a plain version ran on the card's main path")

    saved = (attn_ops.attention_ref, attn_ops.decode_ref, norm_ops.rmsnorm_ref)
    attn_ops.attention_ref = attn_ops.decode_ref = norm_ops.rmsnorm_ref = forbidden
    flash_attention.launches = flash_decode.launches = rmsnorm.launches = 0
    flash_decode.quantized_launches = 0
    route_counts(reset=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        attn_ops.attention_ref, attn_ops.decode_ref, norm_ops.rmsnorm_ref = saved
    counts = {"flash_attention": flash_attention.launches,
              "flash_decode": flash_decode.launches,
              "flash_decode_quantized": flash_decode.quantized_launches,
              "rmsnorm": rmsnorm.launches}
    return out, wall, counts, route_counts()


def expected_launches(st: dict, layers: int, quantized: bool,
                      rmsnorm: bool = True) -> tuple[dict, dict]:
    """The launches and routes a paged serve's model calls (`st`,
    `Server.last_step_counts`) must give: K1 for the probes and, over a bf16
    pool, the first prefills; K2's widened mode for suffix prefills, verify
    steps and an int8 pool's first prefills (over its codes); K2's split
    route for decode, re-score and draft steps; RMSNorm twice a layer and
    once at the end of every call (none where the model's norm is a
    LayerNorm, `rmsnorm=False`); nothing on an FMA body."""
    calls = sum(st.values())
    first = layers * st["prefill"]
    k2 = layers * (st["decode"] + st["suffix_prefill"] + st["rescore"] + st["verify"]
                   + st["draft"])
    want = {"flash_attention": layers * st["probe"] + (0 if quantized else first),
            "flash_decode": k2 + (first if quantized else 0),
            "flash_decode_quantized": k2 + first if quantized else 0,
            "rmsnorm": (2 * layers + 1) * calls if rmsnorm else 0}
    routes = {"flash_attention_tc": want["flash_attention"], "flash_attention_fma": 0,
              "flash_decode_tc": layers * (st["suffix_prefill"] + st["verify"])
              + (first if quantized else 0),
              "flash_decode_split": layers * (st["decode"] + st["rescore"] + st["draft"]),
              "flash_decode_fma": 0}
    return want, routes


def check_paged_run(server, phase, tag, prompts, out, counts, routes, quantized) -> None:
    """Gates of a counted paged serve: every outcome ok, tokens of the right
    shape and range, and the launch counters and routes exactly what the
    server's own step counts say (`expected_launches`)."""
    mcfg, n = server.woven.program.cfg, server.cfg.decode_tokens
    bad = [o for o in server.last_outcomes if o["status"] != "ok"]
    if bad or len(out) != len(prompts):
        raise AssertionError(f"{phase} {tag}: outcomes {bad}")
    for o in out:
        if o.shape != (n,) or o.min() < 0 or o.max() >= mcfg.vocab:
            raise AssertionError(f"{phase} {tag}: tokens of the wrong shape or range")
    st = server.last_step_counts
    # a quantized pool's first prefills attend over its codes through K2
    want, want_routes = expected_launches(st, mcfg.num_layers, quantized,
                                          mcfg.norm_type != "layernorm")
    log(f"{phase} {tag}: launches {counts}, expected {want} from steps {st}")
    if counts != want:
        raise AssertionError(f"{phase} {tag}: launch counters {counts} != expected {want}")
    # routes, as the entry points reported them: every K1 launch on the
    # tensor cores; every widened K2 launch (suffix prefills, verify steps,
    # and a quantized pool's first prefills) on K2's tensor-core mode over
    # bf16 values or codes; every single-token step (decode, re-score,
    # draft) on the split route, over either pool; nothing on an FMA body
    log(f"{phase} {tag}: routes {routes}, expected {want_routes}")
    if any(routes[k] != v for k, v in want_routes.items()):
        raise AssertionError(f"{phase} {tag}: routes {routes} != expected {want_routes}")


def check_spec_stats(tag, st, sp, out, served: int, k: int) -> None:
    """Gates of a self-drafted serve at draft length k: `emitted_spec` plus
    one first token a request is every token served, and the server's step
    counts are its spec stats' (verify, draft and decode steps; no plain
    decode round, k + 1 draft steps a round)."""
    if sp["emitted_spec"] + len(out) != sum(len(o) for o in out) or \
            sum(len(o) for o in out) != served:
        raise AssertionError(f"{tag}: emitted {sp['emitted_spec']} + {len(out)} "
                             f"first tokens != {served} served")
    if (st["verify"], st["draft"], st["decode"]) != \
            (sp["verify_steps"], sp["draft_steps"], sp["decode_steps"]) \
            or sp["decode_steps"] or sp["draft_steps"] != (k + 1) * sp["rounds"]:
        raise AssertionError(f"{tag}: steps {st} against the spec stats {sp}")


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

    mcfg = server.woven.program.cfg
    layers, n = mcfg.num_layers, server.cfg.decode_tokens
    prompts, kw = continuous_traffic(mcfg)

    def check_run(tag, out, counts, routes, quantized):
        check_paged_run(server, "continuous", tag, prompts, out, counts, routes, quantized)

    runs, report = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for tag, share, dtype in (("a_bf16_shared", True, None), ("b_bf16_unshared", False, None),
                              ("c_int8_shared", True, "int8"), ("c_int8_shared_again", True, "int8")):
        server.cfg.cache_dtype = dtype
        try:
            out, wall, counts, routes = counted_serve(torch, lambda: server.serve_continuous(
                prompts, prefix_sharing=share, **kw))
        finally:
            server.cfg.cache_dtype = None
        check_run(tag, out, counts, routes, dtype is not None)
        runs[tag] = out
        report[tag] = {"wall_s": wall, "launches": counts, "routes": routes,
                       "steps": server.last_step_counts,
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

    out, wall, counts, routes = counted_serve(torch, stream)
    # the same wave's neighbours ran without the profiler (batch 8, no
    # admission): the wall time the idle share is read against
    near = [e["dt_s"] for e in events if e["event"] == "wave"
            and e["wave"] in (8, 9, 11, 12) and e["batch"] == 8]
    wave = profiled["wave"]
    if near and wave["device_busy_ms"]:
        wave["unprofiled_wave_wall_ms"] = 1e3 * sum(near) / len(near)
        wave["device_idle_share_unprofiled"] = \
            1.0 - wave["device_busy_ms"] / wave["unprofiled_wave_wall_ms"]
    check_run("d_stream_chunk512", out, counts, routes, False)
    runs["d_stream_chunk512"] = out
    report["d_stream_chunk512"] = {
        "wall_s": wall, "launches": counts, "routes": routes, "steps": server.last_step_counts,
        "prefill_chunk_events": sum(e["event"] == "prefill_chunk" for e in events)}
    if not report["d_stream_chunk512"]["prefill_chunk_events"]:
        raise AssertionError("the chunked stream ran no chunk")
    batch_out, wall, _, _ = counted_serve(torch, lambda: server.serve_batch(prompts))
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
    log("pool-prefill-logits " + json.dumps(pool_prefill_logit_gate(torch, server)))
    log("profile-wave " + json.dumps(profiled["wave"]))
    counts = {tag: {**report[tag]["launches"], **report[tag]["routes"]}
              for tag in ("a_bf16_shared", "c_int8_shared")}
    # run (c)'s tokens: the mesh's int8 serve (q1) prints its agreement
    counts["c_int8_tokens"] = [o.tolist() for o in runs["c_int8_shared"]]
    return counts


def speculative_phase(torch, server) -> dict:
    """Speculative decoding and the resilience layer on the main path, at
    full width and depth: `serve_continuous` over the continuous traffic
    (`continuous_traffic`) with a draft, on the server `serve_phase` built.

    Runs: the plain serves of the traffic over a bf16 and an int8 pool
    (baselines); (s1) bf16 pool, self-draft, k = 2; (s2) the same at k = 4;
    (s3) int8 pool, k = 2; one verify wave at batch 8 of (s1) profiled;
    (s4) yi-6b at full width and a depth of 4 layers in fp32, k = 2, against
    its own plain serve; (r1)-(r4) (s1) with `pool_audit` under an unarmed
    injector, a `raise` and a `nan_logits` at `verify_step` (visit 1) and a
    `raise` at `draft_step`; (x) the registry's pairing, full-width gemma-2b
    drafting for yi-6b (a vocabulary of 256000 to yi's 64000), four
    requests, k = 2, and (x_oov) the same with the draft's logits below
    64000 masked, so that every proposal lies outside yi's vocabulary (with
    random weights and a tied embedding, gemma-2b echoes its input token,
    which is always in range).

    Gated: (s1)-(s3) every outcome ok, `emitted_spec` + requests = the tokens
    served, the step counts equal `last_spec_stats`' (no plain decode round),
    exact launch counts and every bf16 launch on a tensor-core route
    (`check_paged_run`: verify steps on K2's widened mode, draft steps on its
    split route), and fewer target steps than the plain serve's decode
    steps; (s4) exact launch counts and the plain serve's bits (fp32 q rows
    take the FMA body, widened or not); (r1) no event and (s1)'s bits; (r2) one
    retry and (s1)'s bits; (r3) exactly one request quarantined; (r4)
    speculation degraded; (r1)-(r4) no exception, every audit passed, the
    pool empty at the end; (x) the serve returns and the CUDA context still
    computes, and after (x_oov) every request is quarantined for non-finite
    verify logits, as the reference's are, and a plain serve follows.  Printed, not gated: acceptance, mean tokens per verify, token
    agreement with the plain serve (a bf16 verify row and a single-token row
    sum in other orders, and cuBLAS rounds by row count), verify rounds per
    request against ceil((n-1)/(k+1)), the survivors' agreement in
    (r1)-(r4), (x)'s outcomes and how many of its draft's argmaxes lay
    outside yi's vocabulary."""
    import numpy as np

    from repro_torch.core.strategies.resilience import FaultInjector
    from repro_torch.launch.serve import build_server
    from repro_torch.models.registry import draft_for
    from repro_torch.runtime.server import ServerConfig

    mcfg = server.woven.program.cfg
    layers, n = mcfg.num_layers, server.cfg.decode_tokens
    prompts, kw = continuous_traffic(mcfg)
    served = n * len(prompts)

    def serve(srv, dtype=None, **extra):
        srv.cfg.cache_dtype = dtype
        try:
            return counted_serve(torch, lambda: srv.serve_continuous(prompts, **kw, **extra))
        finally:
            srv.cfg.cache_dtype = None

    def agree(x, y):
        return float(np.mean([(p == q).mean() for p, q in zip(x, y)]))

    def same(x, y):
        return all(np.array_equal(p, q) for p, q in zip(x, y))

    runs, report = {}, {}
    for tag, dtype in (("plain_bf16", None), ("plain_int8", "int8")):
        out, wall, counts, routes = serve(server, dtype)
        check_paged_run(server, "speculative", tag, prompts, out, counts, routes,
                        dtype is not None)
        runs[tag] = out
        report[tag] = {"wall_s": wall, "steps": dict(server.last_step_counts),
                       "launches": counts}

    spec_counts = {}
    for tag, k, dtype, base in (("s1_bf16_k2", 2, None, "plain_bf16"),
                                ("s2_bf16_k4", 4, None, "plain_bf16"),
                                ("s3_int8_k2", 2, "int8", "plain_int8")):
        out, wall, counts, routes = serve(server, dtype, draft_len=k)
        check_paged_run(server, "speculative", tag, prompts, out, counts, routes,
                        dtype is not None)
        st, sp = server.last_step_counts, server.last_spec_stats
        check_spec_stats(tag, st, sp, out, served, k)
        plain_steps = report[base]["steps"]["decode"]
        if not sp["target_steps"] < plain_steps:
            raise AssertionError(f"{tag}: {sp['target_steps']} target steps, the plain "
                                 f"serve {plain_steps}")
        runs[tag] = out
        spec_counts[tag] = {**counts, **routes, "verify_launches": layers * st["verify"]}
        report[tag] = {
            "wall_s": wall, "steps": dict(st), "launches": counts, "routes": routes,
            "acceptance": sp["acceptance"],
            "mean_tokens_per_verify": sp["mean_tokens_per_verify"],
            "verify_latency_s": sp["verify_latency_s"],
            "target_steps": sp["target_steps"], "plain_decode_steps": plain_steps,
            "verify_rounds_per_request": sp["request_rounds"] / len(prompts),
            "ideal_rounds_per_request": -(-(n - 1) // (k + 1)),
            "token_agreement_vs_plain": agree(out, runs[base]),
            "bit_identical_to_plain": same(out, runs[base]),
            "pool": server.last_pool_stats}

    # one verify wave at batch 8 (s1's shape) under the profiler
    events, profiled = [], {}

    def stream():
        gen = server.serve_stream(prompts, draft_len=2, **kw)
        while True:
            try:
                if not profiled and events and events[-1]["event"] == "wave" \
                        and events[-1]["wave"] >= 4 and events[-1]["batch"] == 8 \
                        and events[-1]["k"] == 2:
                    ev, profiled["wave"] = profile_wave(
                        torch, gen, 8, shares=("flash_decode_tc", "flash_decode_split"))
                else:
                    ev = next(gen)
            except StopIteration as stop:
                return stop.value
            events.append(ev)

    out, wall, counts, routes = counted_serve(torch, stream)
    check_paged_run(server, "speculative", "s1_stream_profiled", prompts, out, counts,
                    routes, False)
    wave = profiled["wave"]
    near = [e["dt_s"] for e in events if e["event"] == "wave" and e["batch"] == 8
            and e["k"] == 2 and abs(e["wave"] - wave["wave"]) in (1, 2)]
    if near and wave["device_busy_ms"]:
        wave["unprofiled_wave_wall_ms"] = 1e3 * sum(near) / len(near)
        wave["device_idle_share_unprofiled"] = \
            1.0 - wave["device_busy_ms"] / wave["unprofiled_wave_wall_ms"]
    report["s1_stream_profiled"] = {"wall_s": wall,
                                    "bit_identical_to_s1": same(out, runs["s1_bf16_k2"])}

    # (r1)-(r4): the resilience layer on (s1)'s serve
    for tag, inj in (("r1_unarmed", FaultInjector()),
                     ("r2_verify_raise", FaultInjector.single("verify_step", "raise", at=1)),
                     ("r3_verify_nan", FaultInjector.single("verify_step", "nan_logits",
                                                            at=1)),
                     ("r4_draft_raise", FaultInjector.single("draft_step", "raise", at=1))):
        out, wall, counts, routes = serve(server, draft_len=2, fault_injector=inj,
                                          pool_audit=True)
        fs = server.last_fault_stats
        statuses = [o["status"] for o in server.last_outcomes]
        ok = [r for r, s_ in enumerate(statuses) if s_ == "ok"]
        if fs["audits"] < 1 or server.last_pool_stats["live_pages"] != 0:
            raise AssertionError(f"{tag}: audits {fs['audits']}, live pages "
                                 f"{server.last_pool_stats['live_pages']} at the end")
        if tag == "r1_unarmed" and (fs["events"] or fs["actions"] or len(ok) != len(prompts)
                                    or not same(out, runs["s1_bf16_k2"])):
            raise AssertionError(f"{tag}: {fs['events']} events, statuses {statuses}, or "
                                 "other tokens than (s1)")
        if tag == "r2_verify_raise" and (fs["retries"] != 1 or len(ok) != len(prompts)
                                         or not same(out, runs["s1_bf16_k2"])):
            raise AssertionError(f"{tag}: {fs['retries']} retries, statuses {statuses}, or "
                                 "other tokens than (s1)")
        if tag == "r3_verify_nan" and (statuses.count("quarantined") != 1
                                       or len(ok) != len(prompts) - 1):
            raise AssertionError(f"{tag}: statuses {statuses}")
        if tag == "r4_draft_raise" and (not fs["degraded"] or len(ok) != len(prompts)):
            raise AssertionError(f"{tag}: degraded {fs['degraded']}, statuses {statuses}")
        report[tag] = {
            "wall_s": wall, "events": fs["events"], "retries": fs["retries"],
            "audits": fs["audits"], "quarantined": fs["quarantined"],
            "degraded": fs["degraded"], "statuses": statuses,
            "actions": [(a["point"], a["kind"]) for a in fs["actions"]],
            "survivors_token_agreement_vs_s1": agree([out[r] for r in ok],
                                                     [runs["s1_bf16_k2"][r] for r in ok]),
            "spec": {key: server.last_spec_stats[key] for key in
                     ("verify_steps", "draft_steps", "decode_steps")}}

    # (s4): fp32 at full width, a depth of 4, against its own plain serve
    fsrv = fp32_depth4_server(server)
    fp = {}
    for tag, k in (("s4_fp32_plain", 0), ("s4_fp32_k2", 2)):
        out, wall, counts, routes = serve(fsrv, draft_len=k)
        want, _ = expected_launches(fsrv.last_step_counts, 4, False)
        if counts != want or any(o["status"] != "ok" for o in fsrv.last_outcomes):
            raise AssertionError(f"{tag}: launches {counts} != {want}, or outcomes "
                                 f"{fsrv.last_outcomes}")
        fp[tag] = out
        report[tag] = {"wall_s": wall, "launches": counts, "routes": routes,
                       "steps": dict(fsrv.last_step_counts)}
    sp = fsrv.last_spec_stats
    if not same(fp["s4_fp32_k2"], fp["s4_fp32_plain"]):
        # fp32 q rows take the FMA body widened or not, and the identity
        # held in every card run so far (PERF.md): a difference is a fault
        raise AssertionError("(s4): the fp32 speculative serve parts from plain greedy")
    report["s4_fp32_k2"].update({
        "bit_identical_to_plain": same(fp["s4_fp32_k2"], fp["s4_fp32_plain"]),
        "token_agreement_vs_plain": agree(fp["s4_fp32_k2"], fp["s4_fp32_plain"]),
        "acceptance": sp["acceptance"], "target_steps": sp["target_steps"],
        "plain_decode_steps": report["s4_fp32_plain"]["steps"]["decode"]})
    del fsrv
    torch.cuda.empty_cache()

    # (x): the registry's pairing — gemma-2b drafting for yi-6b; (x_oov): the
    # same draft with its logits below yi's vocabulary masked, so that every
    # proposal is an id yi's embedding does not hold
    dname = draft_for("yi-6b")
    dsrv = build_server(dname, reduced=False, device="cuda",
                        cfg=ServerConfig(max_cache_len=server.cfg.max_cache_len,
                                         decode_tokens=n, seed=0))
    rng = np.random.default_rng(7)
    xprompts = [rng.integers(0, mcfg.vocab, 256) for _ in range(4)]
    draft_step = dsrv.decode_vc
    oov = {"argmaxes": 0, "outside_target_vocab": 0, "mask": False}

    def observed_draft_step(variant, params, inputs, cache):
        logits, new_cache = draft_step(variant, params, inputs, cache)
        if oov["mask"]:
            logits[..., :mcfg.vocab] = float("-inf")
        top = logits[:, -1].argmax(dim=-1)
        oov["argmaxes"] += top.numel()
        oov["outside_target_vocab"] += int((top >= mcfg.vocab).sum())
        return logits, new_cache

    dsrv.decode_vc = observed_draft_step
    for tag, mask in (("x_registry_draft", False), ("x_oov_draft", True)):
        oov.update(argmaxes=0, outside_target_vocab=0, mask=mask)
        out = server.serve_continuous(xprompts, page_size=128, draft_len=2, draft=dsrv)
        torch.cuda.synchronize()
        if torch.arange(8, device="cuda").sum().item() != 28:
            raise AssertionError(f"({tag}): the CUDA context no longer computes")
        outcomes = [(o["status"], o["reason"], o["tokens"]) for o in server.last_outcomes]
        if mask and any(o[:2] != ("quarantined", "non-finite verify logits")
                        for o in outcomes):
            raise AssertionError(f"({tag}): outcomes {outcomes}")
        report[tag] = {
            "draft": dname, "draft_vocab": dsrv.woven.program.cfg.vocab,
            "target_vocab": mcfg.vocab, "outcomes": outcomes,
            "draft_argmaxes": oov["argmaxes"],
            "draft_argmaxes_outside_target_vocab": oov["outside_target_vocab"],
            "spec": {key: server.last_spec_stats[key] for key in
                     ("acceptance", "verify_steps", "proposed", "accepted")},
            "tokens": [len(o) for o in out]}
    server.serve_continuous(xprompts, page_size=128)
    if any(o["status"] != "ok" for o in server.last_outcomes):
        raise AssertionError(f"(x): a plain serve after it: {server.last_outcomes}")
    del dsrv, draft_step
    torch.cuda.empty_cache()

    card = nvidia_smi_line()
    log("speculative " + json.dumps({"card": card, "model": "yi-6b", "layers": layers,
                                     "requests": len(prompts), "decode_tokens": n,
                                     "runs": report}))
    log("profile-verify-wave " + json.dumps({"card": card, **wave}))
    # (s3)'s tokens: the mesh's self-drafted int8 serve (q1) prints its agreement
    spec_counts["s3_int8_tokens"] = [o.tolist() for o in runs["s3_int8_k2"]]
    return spec_counts


def fp32_depth4_server(server):
    """yi-6b at full width and a depth of 4 layers in fp32 (policy `double`),
    random weights from seed 0, serving `server`'s cache length and decode
    budget: where the bit-for-bit gates of a change that moves scheduling
    only (speculation, the governor, the fleet) run, since a bf16 row
    depends on the row count cuBLAS sees."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.program import Program
    from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.nn.dtypes import PolicyResolver
    from repro_torch.runtime.server import Server, ServerConfig

    cfg4 = get_config("yi-6b").replace(num_layers=4)
    woven = default_weave(Program(model=build_model(cfg4), cfg=cfg4, kind="serve",
                                  device=server.device),
                          SHAPES["prefill_32k"], {}, extra_aspects=cuda_kernel_aspects())
    woven.state.policies = PolicyResolver.default("double")
    return Server(woven, ServerConfig(max_cache_len=server.cfg.max_cache_len,
                                      decode_tokens=server.cfg.decode_tokens, seed=0))


class DecodeShapes:
    """While active, counts every K2 launch by (route as the entry point
    reported it, q's type, batch, q tokens, over codes): the shapes a run
    gave the kernel, for `governed_shape_cases` to hold against the plain
    version.  Wraps the wrapper's launch only; the counts it keeps are its
    own (the launch counters are untouched)."""

    def __init__(self):
        self.shapes: dict[tuple, int] = {}

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops

        real = self.real = ops.flash_decode_fwd

        def recorded(q, *args, **kw):
            out = real(q, *args, **kw)
            recorded.last_route = real.last_route
            key = (real.last_route, str(q.dtype).replace("torch.", ""), int(q.shape[0]),
                   int(q.shape[1]), kw.get("k_scale") is not None)
            self.shapes[key] = self.shapes.get(key, 0) + 1
            return out

        recorded.last_route = getattr(real, "last_route", None)
        ops.flash_decode_fwd = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import ops

        ops.flash_decode_fwd = self.real


def governed_shape_cases(torch, gen, shapes: dict) -> list:
    """Every K2 shape the governed and the fleet runs launched (`DecodeShapes`),
    each held against its plain version with the gates its route holds
    elsewhere: a single bf16 token (the split route) the same bits twice, a
    request's rows alone as in its batch, within BF16_TOL of the plain
    version; S > 1 bf16 tokens (K1's tensor-core body: chunks, suffixes,
    verify steps) the same bits twice and within BF16_TOL of the plain
    version in float64 (`check_exact`); an fp32 q (the FMA body) within
    FP32_TOL.  yi-6b's heads over a shuffled 128-slot page pool with dead
    pages NaN: a verify or single-token batch at ~1050 resident slots, a
    chunk or suffix over a 1024-token prefix."""
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
    from repro_torch.kernels.flash_attention.ops import flash_decode
    from repro_torch.kernels.flash_attention.ref import decode_ref

    H, K, D, ps = 32, 4, 128, 128
    cases = []
    for (route, dt, B, S, codes), n in sorted(shapes.items()):
        name = f"{route}_B{B}_S{S}_{dt}"
        if codes:
            raise AssertionError(f"{name}: the governed runs serve bf16 pools, not codes")
        dtype = getattr(torch, dt)
        idx = [(1050 if S <= 8 else 1024) + 7 * b for b in range(B)]
        T = -(-(max(idx) + S) // ps) * ps
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, T, K, D), generator=gen, device="cuda").to(dtype)
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        pk, pv, tables = poisoned_pool(torch, gen, k, v, idx, ps, None, S)
        kw = dict(tables=tables, kv_len=T)

        def call():
            return flash_decode(q, pk, pv, index, **kw)

        got = call()
        torch.cuda.synchronize()
        if flash_decode_fwd.last_route != route:
            raise AssertionError(f"{name}: launched the {flash_decode_fwd.last_route} route")
        extra = {}
        if route == "tc_split":
            extra = split_gates(
                torch, name, got, call,
                lambda b: flash_decode(q[b:b + 1], pk, pv, index[b:b + 1],
                                       tables=tables[b:b + 1], kv_len=T), idx)
            err, rms = check_close(torch, name, got, decode_ref(q, pk, pv, index, **kw),
                                   BF16_TOL)
        elif route == "tc":
            if not torch.equal(got, call()):
                raise AssertionError(f"{name}: a second call gave other bits")
            err, rms = check_exact(torch, name, got,
                                   exact(decode_ref, (q, pk, pv), index=index, **kw), BF16_TOL)
        else:
            err, rms = check_close(torch, name, got, decode_ref(q, pk, pv, index, **kw),
                                   FP32_TOL)
        cases.append({"case": name, "route": route, "batch": B, "q_tokens": S,
                      "launches": n, "max_abs_err": err, "ref_rms": rms, **extra})
        del q, k, v, pk, pv
    torch.cuda.empty_cache()
    return cases


class PowerDraw:
    """Samples the card's `power.draw` from `nvidia-smi` every `PERIOD`
    seconds on a thread while active (an observation printed beside the
    governor's modeled power, not a gate); the thread is joined on exit.
    Every run of `qos_phase`, governed or not, is timed under it."""

    PERIOD = 0.25

    def __init__(self):
        import threading

        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=power.draw", "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=5).stdout
                self.samples.append(float(out.split()[0]))
            except (OSError, ValueError, IndexError, subprocess.SubprocessError):
                pass
            self._stop.wait(self.PERIOD)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def reading(self) -> dict:
        s = self.samples
        return {"samples": len(s), "mean_w": sum(s) / len(s) if s else None,
                "max_w": max(s) if s else None}


def governed(gov):
    """Instrument a QoSGovernor: the host time of each `decide` and
    `observe_wave`, and per wave the operating point in force with its
    observed and modeled (the analytic model at the planned load, before
    any reactive rescaling) latency — `wave_s` for a decode-only wave,
    `tok_s` for a wave that also admitted or prefilled."""
    log_ = {"decide_s": [], "observe_s": [], "waves": []}
    decide, observe = gov.decide, gov.observe_wave

    def timed_decide(**kw):
        t0 = time.perf_counter()
        out = decide(**kw)
        log_["decide_s"].append(time.perf_counter() - t0)
        return out

    def timed_observe(dt_s, **kw):
        cur = gov.margot.current
        metric = "tok_s" if kw.get("prefill_tokens") else "wave_s"
        log_["waves"].append((tuple(sorted(gov.current_knobs.items())), metric, dt_s,
                              cur.mean(metric) if cur is not None else None))
        t0 = time.perf_counter()
        observe(dt_s, **kw)
        log_["observe_s"].append(time.perf_counter() - t0)

    gov.decide, gov.observe_wave = timed_decide, timed_observe
    return log_


def governor_report(gov, log_, power) -> dict:
    """What one governed run chose and what it cost on the host."""
    import numpy as np

    by_op: dict[tuple, dict] = {}
    for knobs, metric, dt, modeled in log_["waves"]:
        row = by_op.setdefault((knobs, metric), {"obs": [], "model": []})
        row["obs"].append(dt)
        if modeled is not None:
            row["model"].append(modeled)
    fit = [{"op": dict(knobs), "metric": metric, "waves": len(r["obs"]),
            "observed_s": float(np.mean(r["obs"])),
            "modeled_s": float(np.mean(r["model"])) if r["model"] else None,
            "observed_over_modeled": (float(np.mean(r["obs"]) / np.mean(r["model"]))
                                      if r["model"] else None)}
           for (knobs, metric), r in by_op.items()]
    st = gov.stats()
    seconds = sum(dt for _, _, dt, _ in log_["waves"])
    return {
        "op_history": st["op_history"], "switches": st["switches"],
        "distinct_ops": st["distinct_ops"], "waves": st["waves"], "tokens": st["tokens"],
        "energy_j_modeled": st["energy_j"], "tokens_per_joule_modeled": st["tokens_per_joule"],
        "power_w_modeled_mean": st["energy_j"] / seconds if seconds else None,
        "power_draw_w_nvidia_smi": power.reading(), "capper": st["power"],
        "decide_us": {"calls": len(log_["decide_s"]),
                      "mean": 1e6 * float(np.mean(log_["decide_s"])),
                      "max": 1e6 * float(np.max(log_["decide_s"]))},
        "observe_wave_us": {"calls": len(log_["observe_s"]),
                            "mean": 1e6 * float(np.mean(log_["observe_s"])),
                            "max": 1e6 * float(np.max(log_["observe_s"]))},
        "wave_fit": fit,
    }


def latency_summary(server, wall) -> dict:
    import numpy as np

    ttft = [o["ttft_s"] for o in server.last_outcomes if o["ttft_s"] is not None]
    gaps = [o["tok_gap_max_s"] for o in server.last_outcomes if o["tok_gap_max_s"] is not None]
    return {"wall_s": wall, "ttft_s_median": float(np.median(ttft)),
            "ttft_s_max": float(max(ttft)), "tok_gap_max_s": float(max(gaps))}


# the governed runs' policy: every wave re-planned, the draft length governed
QOS_BASE = {"reselect_every": 1, "reactive": False, "draft_len": (0, 2, 4)}
# SLOs on the analytic wave model's own scale (milliseconds a wave): with
# `reactive` off the Goals meet the modeled metrics alone, and these bind
# there — the draft length falls to 0 as load rises and comes back after
QOS_MODEL_SLO = {"slo_ttft_s": 0.02, "slo_tok_s": 0.01}
# the modeled node power budget of (q3), half the 700 W the model peaks at,
# with the DVFS knob governed
QOS_POWER = {"power_cap_w": 350.0, "freq": (0.5, 0.75, 1.0)}


def qos_phase(torch, server, fsrv, shapes: DecodeShapes) -> dict:
    """The QoS governor on the main path, at full width and depth: the
    continuous traffic (`continuous_traffic`) through `serve_continuous`
    under a `QoSGovernor` (`runtime/qos.py`), self-drafting at the governed
    draft length.

    Runs (every one of (u)-(q3) under `PowerDraw`'s sampler): (u)
    ungoverned, its median TTFT and largest gap the SLO base;
    (q1) `QOS_BASE` (reactive off, draft_len in (0, 2, 4)) with slo_ttft_s
    and slo_tok_s at 1.5x (u)'s, twice; (q1m) `QOS_BASE` with
    `QOS_MODEL_SLO`, under `pool_audit` and an audit of both pools after
    every wave; (q2) (q1) with `reactive` on; (q3) `QOS_BASE` with
    `QOS_POWER`; (q4) the fp32 depth-4 server `fsrv`, (q1m)'s policy
    against its ungoverned serve.

    Gated: every outcome ok and exact launches by route from each run's
    own step counts (`check_paged_run`); distinct_ops >= 2 in (q1), (q1m)
    and (q3); (q1)'s op_history the same on both runs; in (q1m) the draft
    length at 0 and then above it, the draft replayed (`_draft_sync`), every
    per-wave audit passing; in (q3) freq < 1 in force at some wave; (q4)
    bit for bit its ungoverned serve.  Printed: each run's op_history,
    switches, modeled energy and tokens per joule, observed against
    modeled wave latency per operating point, the governor's host time per
    call, TTFT / gap / wall beside (u), bf16 token agreement with (u), and
    the card's power draw beside the modeled power."""
    import numpy as np

    from repro_torch.runtime import server as server_mod
    from repro_torch.runtime.pages import PoolAuditor
    from repro_torch.runtime.qos import QoSGovernor

    mcfg = server.woven.program.cfg
    layers = mcfg.num_layers
    prompts, kw = continuous_traffic(mcfg)

    def agree(x, y):
        return float(np.mean([(p == q).mean() for p, q in zip(x, y)]))

    report, runs, counted = {}, {}, {}
    # (u) runs under the same power sampler as the governed runs, so the
    # walls and latencies compare like with like
    with shapes, PowerDraw() as power:
        out, wall, counts, routes = counted_serve(
            torch, lambda: server.serve_continuous(prompts, **kw))
    check_paged_run(server, "qos", "u_ungoverned", prompts, out, counts, routes, False)
    runs["u"] = out
    report["u_ungoverned"] = {**latency_summary(server, wall), "launches": counts,
                              "steps": dict(server.last_step_counts),
                              "power_draw_w_nvidia_smi": power.reading()}
    card_slo = {"slo_ttft_s": 1.5 * report["u_ungoverned"]["ttft_s_median"],
                "slo_tok_s": 1.5 * report["u_ungoverned"]["tok_gap_max_s"]}

    managers = []
    plain_manager = server_mod.PagedCacheManager

    class Audited(plain_manager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            managers.append(self)

    def audit_wave(ev):
        if ev["event"] == "wave":
            for m in managers:
                PoolAuditor(m, check_device=m is managers[0]).audit()
            audits[0] += 1

    audits = [0]
    replays = [0]
    sync = server._draft_sync

    def counted_sync(draft_srv, dmanager, rids, active, outputs, lengths):
        before = draft_srv._steps["draft"]
        sync(draft_srv, dmanager, rids, active, outputs, lengths)
        replays[0] += draft_srv._steps["draft"] - before

    server._draft_sync = counted_sync
    try:
        for tag, policy, extra in (
                ("q1_card_slo", {**QOS_BASE, **card_slo}, {}),
                ("q1_card_slo_again", {**QOS_BASE, **card_slo}, {}),
                ("q1m_model_slo", {**QOS_BASE, **QOS_MODEL_SLO}, {"pool_audit": True}),
                ("q2_reactive", {**QOS_BASE, **card_slo, "reactive": True}, {}),
                ("q3_power_cap", {**QOS_BASE, **QOS_POWER}, {})):
            gov = QoSGovernor(policy, broker=server.broker)
            glog = governed(gov)
            events = []
            on_event = events.append
            replays[0] = audits[0] = 0
            managers.clear()
            if tag.startswith("q1m"):
                server_mod.PagedCacheManager = Audited

                def on_event(ev):
                    events.append(ev)
                    audit_wave(ev)
            try:
                with shapes, PowerDraw() as power:
                    out, wall, counts, routes = counted_serve(torch, lambda: (
                        server.serve_continuous(prompts, **kw, qos=gov, on_event=on_event,
                                                **extra)))
            finally:
                server_mod.PagedCacheManager = plain_manager
            check_paged_run(server, "qos", tag, prompts, out, counts, routes, False)
            if server.last_qos_stats is None:
                raise AssertionError(f"qos {tag}: the serve ran ungoverned")
            rep = governor_report(gov, glog, power)
            waves = [e for e in events if e["event"] == "wave"]
            rep.update(latency_summary(server, wall))
            rep.update({"launches": counts, "steps": dict(server.last_step_counts),
                        "spec": {k_: server.last_spec_stats[k_] for k_ in
                                 ("rounds", "verify_steps", "draft_steps", "decode_steps",
                                  "acceptance")},
                        "draft_replayed_steps": replays[0],
                        "k_by_wave": [e["op"]["k"] for e in waves],
                        "freq_min_in_force": min(e["op"]["freq"] for e in waves),
                        "token_agreement_vs_ungoverned": agree(out, runs["u"])})
            if tag.startswith("q1m"):
                rep["per_wave_audits"] = audits[0]
                if audits[0] != len(waves):
                    raise AssertionError(f"qos {tag}: {audits[0]} audits for {len(waves)} waves")
            report[tag], runs[tag] = rep, out
            counted[tag] = {**counts, **routes,
                            "verify_launches": layers * server.last_step_counts["verify"]}
            if tag != "q2_reactive" and rep["distinct_ops"] < 2:
                raise AssertionError(f"qos {tag}: {rep['distinct_ops']} distinct operating points")
    finally:
        del server._draft_sync  # the class's own again
    if report["q1_card_slo"]["op_history"] != report["q1_card_slo_again"]["op_history"]:
        raise AssertionError("qos (q1): two runs chose other operating points")
    ks = [h["knobs"]["draft_len"] for h in report["q1m_model_slo"]["op_history"]]
    if 0 not in ks or ks[-1] == 0 or not report["q1m_model_slo"]["draft_replayed_steps"]:
        raise AssertionError(f"qos (q1m): draft lengths {ks}, "
                             f"{report['q1m_model_slo']['draft_replayed_steps']} replayed steps")
    if not report["q3_power_cap"]["freq_min_in_force"] < 1.0:
        raise AssertionError("qos (q3): freq never fell below 1 under the power budget")

    # (q4): fp32 at a depth of 4, governed against ungoverned, bit for bit
    fp = {}
    for tag, qos in (("q4_fp32_ungoverned", None),
                     ("q4_fp32_governed", {**QOS_BASE, **QOS_MODEL_SLO})):
        with shapes:
            out, wall, counts, routes = counted_serve(
                torch, lambda: fsrv.serve_continuous(prompts, **kw, qos=qos))
        want, _ = expected_launches(fsrv.last_step_counts, 4, False)
        if counts != want or any(o["status"] != "ok" for o in fsrv.last_outcomes):
            raise AssertionError(f"qos {tag}: launches {counts} != {want}, or outcomes "
                                 f"{fsrv.last_outcomes}")
        fp[tag] = out
        report[tag] = {"wall_s": wall, "launches": counts, "routes": routes,
                       "steps": dict(fsrv.last_step_counts),
                       "op_history": (fsrv.last_qos_stats or {}).get("op_history")}
    same = all(np.array_equal(a, b) for a, b in zip(fp["q4_fp32_governed"],
                                                    fp["q4_fp32_ungoverned"]))
    report["q4_fp32_governed"]["bit_identical_to_ungoverned"] = same
    if not same:
        raise AssertionError("qos (q4): the governed fp32 serve parts from the ungoverned one")

    log("qos " + json.dumps({"card": nvidia_smi_line(), "model": "yi-6b", "layers": layers,
                             "requests": len(prompts), "slo_from_u": card_slo,
                             "runs": report}))
    return counted


# the fleet: two replicas of four decode slots and one hot spare; a round
# routes up to six requests to a replica, so a replica's wave queues two
FLEET = {"replicas": 2, "spares": 1, "wave_size": 6}
FLEET_MAX_BATCH = 4


def counted_replicas(base, steps: dict, page_size: int, mesh=None):
    """A `replica_factory` over `base`'s woven program and param tree (on
    `mesh`), `FLEET_MAX_BATCH` decode slots a replica, whose replicas add
    the step counts of every serve into `steps`."""
    from repro_torch.runtime.fleet import replica_factory
    from repro_torch.runtime.server import ServerConfig

    make = replica_factory(base.woven, ServerConfig(
        max_cache_len=base.cfg.max_cache_len, decode_tokens=base.cfg.decode_tokens,
        page_size=page_size, max_batch=FLEET_MAX_BATCH, seed=0), params=base.params,
        mesh=mesh)

    def replica():
        srv = make()
        serve = srv.serve_continuous

        def counted(*a, **k):
            out = serve(*a, **k)
            for key, v in (srv.last_step_counts or {}).items():
                steps[key] += v
            return out

        srv.serve_continuous = counted
        return srv

    return replica


def fleet_phase(torch, server, fsrv, shapes: DecodeShapes) -> dict:
    """The serving fleet at full width and depth: `FLEET`'s replicas and
    spare of `server`'s woven program (`runtime/fleet.ServingFleet` over
    `replica_factory` with `server`'s param tree: one copy of the weights,
    one page pool per replica serve), the continuous traffic's prompts.

    Runs: (f1) clean; (f2) a replica lost at its second dispatch
    (`FaultInjector.single("replica_loss", "raise", at=1)`), half-way
    through its decode; (f3) replica 0
    drained (`request_drain(0)`); (f4) the fp32 depth-4 server's fleet
    against one `Server` of it.  Gated: every outcome ok; every replica
    holds `server`'s param tree and the peak memory stays under twice the
    weights; exact launches by route from the replicas' own step counts
    (in (f4), for both serves, by count alone); affinity_hits > 0 in (f1); `replica_loss`, `declared_dead` and
    `spare_in` and at least one re-dispatch in (f2); (f3) hands its queue
    to a peer; (f4) bit for bit.  Printed: `last_fleet_stats`, peak memory,
    wall, and bf16 token agreement with the single server's ungoverned
    serve of the same prompts.  Returns the counted runs and (f4)'s
    tokens, which the mesh's (d3) is read against."""
    import numpy as np

    from repro_torch.core.strategies.resilience import FaultInjector
    from repro_torch.runtime.fleet import ServingFleet
    from repro_torch.runtime.server import _step_counts

    mcfg = server.woven.program.cfg
    layers, n = mcfg.num_layers, server.cfg.decode_tokens
    prompts, kw = continuous_traffic(mcfg)

    weight_bytes = sum(t.numel() * t.element_size()
                       for t in server.woven.program.model.parameters())
    report, counted, outs = {}, {}, {}
    for tag, fkw, inj, drain in (
            ("f1_clean", {}, None, None),
            # the loss lands mid-decode (every request of a replica's wave
            # decodes at once, so the default kill_step, n - 1, would find
            # them all done)
            ("f2_replica_loss", {"kill_step": n // 2},
             FaultInjector.single("replica_loss", "raise", at=1), None),
            ("f3_drain", {}, None, 0)):
        steps = _step_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        fleet = ServingFleet(counted_replicas(server, steps, kw["page_size"]), injector=inj,
                             **FLEET, **fkw)
        if drain is not None:
            fleet.request_drain(drain)
        with shapes:
            out, wall, counts, routes = counted_serve(
                torch, lambda: fleet.serve(prompts, decode_tokens=n))
        peak = torch.cuda.max_memory_allocated()
        st = fleet.last_fleet_stats
        want, want_routes = expected_launches(steps, layers, False)
        log(f"fleet {tag}: launches {counts}, expected {want} from steps {steps}")
        if counts != want or any(routes[k] != v for k, v in want_routes.items()):
            raise AssertionError(f"fleet {tag}: launches {counts} / routes {routes} != "
                                 f"{want} / {want_routes}")
        if st["outcomes"] != {"ok": len(prompts)}:
            raise AssertionError(f"fleet {tag}: outcomes {st['outcomes']}")
        servers = [r.server for r in fleet.replicas] + [r.server for r in fleet.spares]
        # the fleet's own memory (pools, activations) on top of what was
        # resident: less than one more copy of the weights
        if any(s.params is not server.params for s in servers) \
                or not peak - resident < weight_bytes:
            raise AssertionError(f"fleet {tag}: a replica holds its own weights (peak "
                                 f"{peak} bytes over {resident} resident, weights "
                                 f"{weight_bytes})")
        kinds = [e["kind"] for e in st["events"]]
        report[tag] = {
            "wall_s": wall, "peak_memory_gb": peak / 1e9,
            "peak_over_resident_gb": (peak - resident) / 1e9,
            "weights_gb": weight_bytes / 1e9,
            "rounds": st["rounds"], "outcomes": st["outcomes"],
            "redispatched": st["redispatched"], "affinity_hits": st["affinity_hits"],
            "replicas_with_prefix_hits": st["replicas_with_prefix_hits"],
            "event_kinds": kinds, "events": st["events"], "replicas": st["replicas"],
            "launches": counts, "steps": dict(steps),
            "replica_of_request": [o["replica"] for o in fleet.last_outcomes]}
        outs[tag], counted[tag] = out, {**counts, **routes, "verify_launches": 0}
    if not report["f1_clean"]["affinity_hits"] > 0:
        raise AssertionError("fleet (f1): no request routed by prefix affinity")
    f2 = report["f2_replica_loss"]
    if not {"replica_loss", "declared_dead", "spare_in"} <= set(f2["event_kinds"]) \
            or f2["redispatched"] < 1:
        raise AssertionError(f"fleet (f2): events {f2['event_kinds']}, "
                             f"{f2['redispatched']} re-dispatched")
    drains = [e for e in report["f3_drain"]["events"] if e["kind"] == "drain"]
    if not drains or drains[0]["host"] != 0 or drains[0]["handoff"] < 1:
        raise AssertionError(f"fleet (f3): drain events {drains}")

    # (f4): fp32 at a depth of 4, the fleet against one server, bit for bit;
    # both serves under exact launch counts (routes unchecked in fp32, as in
    # (q4))
    with shapes:
        single, _, counts, _ = counted_serve(torch, lambda: fsrv.serve_continuous(
            prompts, max_batch=kw["max_batch"], page_size=kw["page_size"]))
    want, _ = expected_launches(fsrv.last_step_counts, 4, False)
    if counts != want:
        raise AssertionError(f"fleet (f4) single server: launches {counts} != {want}")
    steps = _step_counts()
    fleet = ServingFleet(counted_replicas(fsrv, steps, kw["page_size"]), **FLEET)
    with shapes:
        fout, _, counts, _ = counted_serve(torch, lambda: fleet.serve(prompts, decode_tokens=n))
    want, _ = expected_launches(steps, 4, False)
    if counts != want:
        raise AssertionError(f"fleet (f4): launches {counts} != {want} from steps {steps}")
    same = all(np.array_equal(a, b) for a, b in zip(fout, single))
    report["f4_fp32"] = {"outcomes": fleet.last_fleet_stats["outcomes"], "launches": counts,
                         "bit_identical_to_single_server": same}
    if not same or fleet.last_fleet_stats["outcomes"] != {"ok": len(prompts)}:
        raise AssertionError(f"fleet (f4): {report['f4_fp32']}")
    base = server.serve_continuous(prompts, max_batch=kw["max_batch"], page_size=kw["page_size"])
    for tag in ("f1_clean", "f2_replica_loss", "f3_drain"):
        report[tag]["token_agreement_vs_single_server"] = float(np.mean(
            [(p == q).mean() for p, q in zip(outs[tag], base)]))
    log("fleet " + json.dumps({"card": nvidia_smi_line(), "model": "yi-6b", "layers": layers,
                               "requests": len(prompts), "runs": report}, default=str))
    return counted, [o.tolist() for o in fout]


# ---------------------------------------------------------------------------
# the kernel tuner on the card: tune, persist, weave, serve, feed back
# ---------------------------------------------------------------------------


def tuner_rows(entry: dict) -> list[dict]:
    """A tuned entry's operating points as printed: knobs, latency in ms,
    shared memory, and the pool's HBM or error column where the space has
    one."""
    rows = []
    for r in entry["ops"]:
        m = r["metrics"]
        row = {"knobs": r["knobs"], "ms": m["latency_s"][0] * 1e3,
               "smem_bytes": int(m["smem_bytes"][0])}
        for col in ("pool_hbm_bytes", "max_logit_err", "tokens_per_hbm_byte",
                    "tokens_per_step"):
            if col in m:
                row[col] = m[col][0]
        rows.append(row)
    return rows


def paged_from_dense(torch, gen, k, v, ps):
    """The dense (B, T, K, D) cache as a page pool of page `ps` under
    shuffled block tables: (k pool, v pool, tables)."""
    B, T, K, D = k.shape
    nb = T // ps
    perm = torch.randperm(B * nb, generator=gen, device="cuda")
    pk = torch.empty((B * nb, ps, K, D), dtype=k.dtype, device="cuda")
    pv = torch.empty_like(pk)
    pk[perm] = k.reshape(B * nb, ps, K, D)
    pv[perm] = v.reshape(B * nb, ps, K, D)
    return pk, pv, perm.to(torch.int32).reshape(B, nb).contiguous()


def tuned_value_cases(torch, gen, sigs: dict) -> dict:
    """Every value a tuned space holds, held against the plain version on
    the card at the tuned signature's shape.

    `page_size`: one bf16 token a request (ragged positions, as the DSE
    measures) over one dense cache repacked as a shuffled pool at each page
    size: the split route, every page size's rows equal the dense layout's
    bit for bit, and within BF16_TOL of the plain version.  `cache_dtype`:
    the same values quantized per page at each page size — the codes' rows
    within BF16_TOL of the plain version over the same codes, the paged
    pool equal to the dense layout of the same codes and scales bit for
    bit, within QUANT_VS_FP_TOL of the bf16 pool's rows for int8 (e4m3's
    gap printed, a tuning column).  `draft_len`: the verify step, S =
    draft_len + 1 tokens at T - S (the DSE's shape), on K2's tensor-core
    mode, the same bits twice, against the plain version in float64.
    `dkv_n_split`: K3 at gemma-2b's training microbatch with each split,
    the same bits twice, every gradient against the plain backward in
    float64."""
    from repro_torch.autotune.kernel_tuner import design_space, ragged_index
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
    from repro_torch.kernels.flash_attention.ops import flash_decode
    from repro_torch.kernels.flash_attention.ref import attention_ref, decode_ref, \
        flash_attention_bwd_ref
    from repro_torch.runtime.pages import quantize_linear_pool

    out = {"page_size": [], "cache_dtype": [], "draft_len": [], "dkv_n_split": []}
    sig = sigs["paged_decode"]
    B, T, H, K, D = sig.shape
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    index = torch.tensor(ragged_index(B, T), dtype=torch.int32, device="cuda")
    dense = flash_decode(q, k, v, index)
    torch.cuda.synchronize()
    if flash_decode_fwd.last_route != "tc_split":
        raise AssertionError(f"tuner: the dense decode took {flash_decode_fwd.last_route}")
    pools = {}
    for ps in design_space(sig)["page_size"]:
        pk, pv, tables = pools[ps] = paged_from_dense(torch, gen, k, v, ps)
        kw = dict(tables=tables, kv_len=T)
        got = flash_decode(q, pk, pv, index, **kw)
        torch.cuda.synchronize()
        if flash_decode_fwd.last_route != "tc_split" or not torch.equal(got, dense):
            raise AssertionError(f"tuner page_size {ps}: route {flash_decode_fwd.last_route}, "
                                 f"bitwise equal to the dense layout "
                                 f"{torch.equal(got, dense)}")
        err, rms = check_close(torch, f"tuner page_size {ps}", got,
                               decode_ref(q, pk, pv, index, **kw), BF16_TOL)
        out["page_size"].append({"page_size": ps, "route": "tc_split",
                                 "bitwise_equal_dense": True, "max_abs_err": err,
                                 "ref_rms": rms})

    qsig = sigs["quantized_cache"]
    space = design_space(qsig)
    for name in space["cache_dtype"]:
        for ps in space["page_size"]:
            if name == "float16":  # the fp arm: the bf16 pool, held above
                continue
            pk, pv, tables = pools[ps]
            qk, qv, ksc, vsc = quantize_linear_pool(pk, pv, name)
            kw = dict(tables=tables, kv_len=T, k_scale=ksc, v_scale=vsc)
            got = flash_decode(q, qk, qv, index, **kw)
            torch.cuda.synchronize()
            if flash_decode_fwd.last_route != "tc_split":
                raise AssertionError(f"tuner {name} page {ps}: route "
                                     f"{flash_decode_fwd.last_route}")
            rows = tables.long()
            kd = qk[rows].reshape(B, T, K, D)
            vd = qv[rows].reshape(B, T, K, D)
            as_dense = flash_decode(q, kd, vd, index, k_scale=ksc[rows].contiguous(),
                                    v_scale=vsc[rows].contiguous(), scale_page=ps)
            torch.cuda.synchronize()
            if not torch.equal(got, as_dense):
                raise AssertionError(f"tuner {name} page {ps}: the paged pool's rows "
                                     f"differ from the dense layout of the same codes")
            err, rms = check_close(torch, f"tuner {name} page {ps}", got,
                                   decode_ref(q, qk, qv, index, **kw), BF16_TOL)
            vs_fp = (got.float() - dense.float()).abs().max().item()
            if name == "int8" and not vs_fp <= QUANT_VS_FP_TOL:
                raise AssertionError(f"tuner int8 page {ps}: {vs_fp} from the bf16 pool's "
                                     f"rows (bound {QUANT_VS_FP_TOL})")
            out["cache_dtype"].append({"cache_dtype": name, "page_size": ps,
                                       "bitwise_equal_dense_codes": True,
                                       "max_abs_err": err, "ref_rms": rms,
                                       "max_abs_diff_vs_bf16_pool": vs_fp})
            del qk, qv, kd, vd
    del pools, k, v
    torch.cuda.empty_cache()

    ssig = sigs["speculative"]
    B, T, H, K, D = ssig.shape
    k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    for d in design_space(ssig)["draft_len"]:
        S = d + 1
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        index = torch.full((B,), T - S, dtype=torch.int32, device="cuda")
        got = flash_decode(q, k, v, index)
        torch.cuda.synchronize()
        if flash_decode_fwd.last_route != "tc" or not torch.equal(got, flash_decode(
                q, k, v, index)):
            raise AssertionError(f"tuner draft_len {d}: route {flash_decode_fwd.last_route} "
                                 f"or other bits on a second call")
        err, rms = check_exact(torch, f"tuner draft_len {d}", got,
                               exact(decode_ref, (q, k, v), index=index), BF16_TOL)
        out["draft_len"].append({"draft_len": d, "route": "tc", "bitwise_two_calls": True,
                                 "max_abs_err": err, "ref_rms": rms})
    del k, v
    torch.cuda.empty_cache()

    fsig = sigs["flash_attention"]
    B, S, H, K, D = fsig.shape
    q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    o, lse = ops._forward(q, k, v, causal=True, window=None, softcap=None, block_q=64,
                          block_kv=64, pruned=True, return_lse=True)
    want = exact(flash_attention_bwd_ref, (q, k, v, o, lse, do), causal=True)
    for n in design_space(fsig)["dkv_n_split"]:
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True, n_split=n)
        again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True, n_split=n)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"tuner dkv_n_split {n}: two K3 calls differ")
        errs = {g: check_exact(torch, f"tuner dkv_n_split {n} {g}", a, w, BF16_TOL)
                for g, a, w in zip(("dq", "dk", "dv"), got, want)}
        out["dkv_n_split"].append({"dkv_n_split": n, "bitwise_two_calls": True,
                                   **{f"max_abs_err_{g}": e[0] for g, e in errs.items()},
                                   **{f"ref_rms_{g}": e[1] for g, e in errs.items()}})
    del q, k, v, do, o, lse, want
    torch.cuda.empty_cache()
    return out


def tuned_server(server, tuner, batch: int):
    """A second woven server over `server`'s weights whose tuned knobs come
    from `tuner`'s rows: `TunedKernelAspect(batch, max_cache_len,
    cache_len=max_cache_len)` explicitly, so that its serving signatures
    are the ones tuned (the default weave's aspect, keyed to the prefill
    shape, is left out)."""
    import dataclasses

    from repro_torch.configs.base import SHAPES
    from repro_torch.core.strategies.kernels import TunedKernelAspect
    from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
    from repro_torch.runtime.server import Server

    T = server.cfg.max_cache_len
    woven = default_weave(server.woven.program, SHAPES["prefill_32k"], {},
                          overrides={"tuned_kernels": False},
                          extra_aspects=cuda_kernel_aspects()
                          + [TunedKernelAspect(batch, T, cache_len=T, tuner=tuner)])
    return Server(woven, dataclasses.replace(server.cfg), params=server.params)


def tuner_phase(torch, server) -> dict:
    """The kernel tuner's loop on the card, on full-width, full-depth yi-6b.

    1. Tune into this phase's own cache file (`KernelTuner`, rows keyed
       `@cuda`): `paged_decode` and `quantized_cache` at the signature
       `Server._paged_signature` gives the continuous run (B8, the 4096-slot
       cache, H32 K4 D128, bf16), `speculative` at B8 (and at B1..B7: the
       feedback keys on the verify rounds' mean live batch),
       `flash_attention` at gemma-2b's training microbatch (B2 S1024 H8 K1
       D256 bf16: `dkv_n_split` in {1, 2, 4, 8}).  Printed: every row
       (knobs, ms, shared memory, the pool's HBM or the error column), the
       chosen knobs beside today's defaults (page 128, the heuristic's
       split) and the tuning wall time.
    2. Every value the spaces hold is held against its plain version
       (`tuned_value_cases`).
    3. Serve the continuous traffic's eight prefix sharers, all at wave 0
       (a live batch of 8 throughout, the tuned signatures' batch), 32
       tokens each: (k0) `server` at the default page size; (k1) a second
       woven server over the same weights (`tuned_server`) whose cache
       holds only the `paged_decode` row; then `refine_kernel_tuner`, and
       (k1r) a third server weaving the refined row; (k2) one over the
       full tuned cache (the quantized pool's dtype and page size, the
       draft length), then `refine_speculative`.  Each refine's latency
       budget is twice the step it observes, so the re-selection
       maximizes its knob.  The hot path reads the same file meanwhile.  Gated: every outcome ok and exact launches by
       route (`check_paged_run`); each tuned space's lookup hit (its
       extras woven and equal to the row; a miss fails the phase); the
       pool's page size and dtype the woven ones; (k1)'s and (k1r)'s
       tokens equal (k0)'s bit for bit, one of them at a page size other
       than the default — neither the split route nor K1's 64-slot tiles
       depend on the paging; (k2) speculative at the tuned draft length;
       both refine calls return knobs.  Printed: the stored
       `error_coef` — the DSE stores one kernel launch and the server
       observes a whole 32-layer step, so the paged coefficient lies far
       above 1.
    """
    import numpy as np

    from repro_torch.autotune import kernel_tuner as kt

    mcfg = server.woven.program.cfg
    B, T = 8, server.cfg.max_cache_len
    H, K, D = mcfg.n_heads, mcfg.kv_heads, mcfg.resolved_head_dim
    home = os.path.dirname(os.environ["REPRO_TORCH_TUNER_CACHE"])
    full_path, paged_path = os.path.join(home, "tuned.json"), os.path.join(home, "paged.json")
    sigs = {"paged_decode": server._paged_signature(batch=B, dtype=torch.bfloat16),
            "quantized_cache": kt.quantized_cache_signature(B, T, H, K, D, torch.bfloat16),
            "speculative": kt.speculative_signature(B, T, H, K, D, torch.bfloat16),
            "flash_attention": kt.flash_signature((2, 1024, 8, 256), 1, torch.bfloat16,
                                                  causal=True)}
    t_phase = time.perf_counter()
    tuner = kt.KernelTuner(full_path)
    report = {"card": nvidia_smi_line(), "signatures": {n: s.key() for n, s in sigs.items()},
              "spaces": {n: kt.design_space(s) for n, s in sigs.items()}}
    t0 = time.perf_counter()
    chosen = {}
    for name, sig in sigs.items():
        t1 = time.perf_counter()
        chosen[name] = (kt.tune_quantized_cache(sig, tuner=tuner)
                        if name == "quantized_cache" else tuner.tune(sig, num_tests=3))
        entry = tuner.cache.get(tuner._key(sig))
        report[name] = {"rows": tuner_rows(entry), "chosen": chosen[name],
                        "tune_s": time.perf_counter() - t1}
    # refine_speculative keys on the mean live batch of the verify rounds,
    # which the draft's rejections lower: the verify step is tuned at every
    # live batch the continuous batcher forms (the aspect weaves B8's row)
    report["speculative"]["chosen_by_batch"] = {
        b: tuner.tune(kt.speculative_signature(b, T, H, K, D, torch.bfloat16), num_tests=3)
        for b in range(1, B)}
    report["tune_wall_s"] = time.perf_counter() - t0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    from repro_torch.kernels.flash_attention.kernel import dkv_n_split

    report["defaults"] = {"page_size": 128, "cache_dtype": None, "draft_len": 0,
                          "dkv_n_split_heuristic": dkv_n_split(2, 1, 1024, 8, sms)}
    if not all(tuner.lookup(s) == chosen[n] for n, s in sigs.items()):
        raise AssertionError("tuner: a tuned row does not read back")
    paged_tuner = kt.KernelTuner(paged_path)
    paged_tuner.cache.put(paged_tuner._key(sigs["paged_decode"]),
                          tuner.cache.get(tuner._key(sigs["paged_decode"])))
    log("tuner " + json.dumps(report))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    t1 = time.perf_counter()
    cases = tuned_value_cases(torch, gen, sigs)
    log("tuner-cases " + json.dumps({"wall_s": time.perf_counter() - t1, **cases}))

    prompts, _ = continuous_traffic(mcfg)
    prompts = prompts[:B]
    empty = os.environ["REPRO_TORCH_TUNER_CACHE"]

    def serve(srv, tag, path):
        os.environ["REPRO_TORCH_TUNER_CACHE"] = path
        try:
            out, wall, counts, routes = counted_serve(
                torch, lambda: srv.serve_continuous(prompts, max_batch=B))
        finally:
            os.environ["REPRO_TORCH_TUNER_CACHE"] = empty
        pool = srv.last_pool_stats
        check_paged_run(srv, "tuner", tag, prompts, out, counts, routes,
                        pool["cache_dtype"] is not None)
        rep = {"wall_s": wall, "launches": counts, "routes": routes,
               "steps": dict(srv.last_step_counts), "page_size": pool["page_size"],
               "cache_dtype": pool["cache_dtype"], "prefix_hits": pool["prefix_hits"],
               "decode_step_s_mean": (float(np.mean(srv.decode_step_latencies))
                                      if srv.decode_step_latencies else None),
               "ttft_s": [o["ttft_s"] for o in srv.last_outcomes]}
        log(f"tuner {tag} " + json.dumps({k: v for k, v in rep.items()
                                          if k not in ("launches", "routes")}))
        return out, rep

    runs, counted = {}, {}
    base, runs["k0_default_page"] = serve(server, "k0_default_page", empty)

    def woven_knobs(srv, want: dict):
        got = {extra: srv.woven.state.extra.get(extra) for extra in want}
        if got != want:
            raise AssertionError(f"tuner: woven {got}, the rows hold {want} (a lookup missed)")

    srv1 = tuned_server(server, paged_tuner, B)
    ps = chosen["paged_decode"]["page_size"]
    woven_knobs(srv1, {"flash_page_size": ps, "flash_cache_dtype": None,
                       "speculative_draft_len": None})
    out1, runs["k1_tuned_page"] = serve(srv1, "k1_tuned_page", paged_path)
    if runs["k1_tuned_page"]["page_size"] != ps:
        raise AssertionError(f"tuner (k1): the pool's page size "
                             f"{runs['k1_tuned_page']['page_size']}, the row's {ps}")
    same = all(np.array_equal(a, b) for a, b in zip(out1, base))
    runs["k1_tuned_page"]["bitwise_equal_k0"] = same
    if not same:
        raise AssertionError(f"tuner (k1): page size {ps} gave other bf16 tokens than 128")
    # an SLO at twice the step (k1) observed: every refined row meets it, so
    # the re-selection maximizes the page size
    budget = 2 * runs["k1_tuned_page"]["decode_step_s_mean"]
    refined = srv1.refine_kernel_tuner(latency_budget=budget, tuner=paged_tuner)
    if refined is None:
        raise AssertionError("tuner (k1): refine_kernel_tuner found no row to refine")
    entry = paged_tuner.cache.get(paged_tuner._key(srv1._paged_sig))
    runs["k1_tuned_page"]["refine"] = {"knobs": refined, **entry["runtime"]}
    log("tuner k1 refine " + json.dumps(runs["k1_tuned_page"]["refine"]))
    # the loop closed: a next server weaves the refined row
    srv1r = tuned_server(server, paged_tuner, B)
    woven_knobs(srv1r, {"flash_page_size": refined["page_size"], "flash_cache_dtype": None,
                        "speculative_draft_len": None})
    out1r, runs["k1r_refined_page"] = serve(srv1r, "k1r_refined_page", paged_path)
    same = all(np.array_equal(a, b) for a, b in zip(out1r, base))
    runs["k1r_refined_page"]["bitwise_equal_k0"] = same
    if runs["k1r_refined_page"]["page_size"] != refined["page_size"] or not same:
        raise AssertionError(f"tuner (k1r): page {runs['k1r_refined_page']['page_size']} "
                             f"(refined {refined['page_size']}), bitwise equal to (k0) {same}")
    if {ps, refined["page_size"]} == {128}:
        raise AssertionError("tuner (k1r): no page size but the default was served, so the "
                             "paging identity went untested")
    del srv1r

    q = chosen["quantized_cache"]
    srv2 = tuned_server(server, tuner, B)
    woven_knobs(srv2, {"flash_page_size": q["page_size"], "flash_cache_dtype": q["cache_dtype"],
                       "speculative_draft_len": chosen["speculative"]["draft_len"]})
    out2, runs["k2_tuned_all"] = serve(srv2, "k2_tuned_all", full_path)
    spec = srv2.last_spec_stats
    want_dtype = q["cache_dtype"] if q["cache_dtype"] in ("int8", "float8_e4m3fn") else None
    if (runs["k2_tuned_all"]["page_size"], runs["k2_tuned_all"]["cache_dtype"]) != \
            (q["page_size"], want_dtype) or spec is None \
            or spec["draft_len"] != chosen["speculative"]["draft_len"]:
        raise AssertionError(f"tuner (k2): pool {runs['k2_tuned_all']}, spec {spec}, rows {q} "
                             f"{chosen['speculative']}")
    runs["k2_tuned_all"].update(
        acceptance=spec["acceptance"], mean_tokens_per_verify=spec["mean_tokens_per_verify"],
        token_agreement_vs_k0=float(np.mean([(a == b).mean() for a, b in zip(out2, base)])))
    refined = srv2.refine_speculative(latency_budget=2 * spec["verify_latency_s"],
                                      tuner=tuner)
    batch = max(1, round(spec["request_rounds"] / max(spec["rounds"], 1)))
    runs["k2_tuned_all"]["refined_batch"] = batch
    if refined is None:
        raise AssertionError(f"tuner (k2): refine_speculative found no row at B{batch}")
    entry = tuner.cache.get(tuner._key(kt.speculative_signature(batch, T, H, K, D,
                                                                torch.bfloat16)))
    runs["k2_tuned_all"]["refine"] = {"knobs": refined, **entry["runtime"]}
    log("tuner k2 refine " + json.dumps(runs["k2_tuned_all"]["refine"]))
    for tag, rep in runs.items():
        counted[tag] = {**rep["launches"], **rep["routes"],
                        "verify_launches": mcfg.num_layers * rep["steps"]["verify"]}
    log("tuner-serve " + json.dumps({"card": nvidia_smi_line(), "model": "yi-6b",
                                     "layers": mcfg.num_layers, "requests": len(prompts),
                                     "phase_wall_s": time.perf_counter() - t_phase,
                                     "runs": runs}, default=str))
    del srv1, srv2
    return {"counts": counted, "cases": cases}


def sharing_diagnostic(torch, server, prompts) -> dict:
    """Where the shared and the unshared runs part (printed, not gated): the
    first-token logits of each prefix sharer, admitted over its donor's pages
    and admitted alone, and whether a GEMM row depends on the row count —
    the prefill projections of a suffix-only and a whole-prompt admission
    run at different M, as the decode GEMMs of batches of 8 and 10 do."""
    from repro_torch.runtime.pages import PagedCacheManager

    captured = {}
    first_token = server._first_token

    def capture(manager, rid, logits, fault=None):
        captured[rid] = logits[0, -1].float().clone()
        return first_token(manager, rid, logits, fault)

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


def pool_prefill_logit_gate(torch, server) -> dict:
    """A first prefill into a paged pool, under the `cuda` impl against the
    plain (`eager`) impl of the same server and weights: the bf16 pool
    (K1), and the int8 pool, whose first prefill attends over its codes
    through K2's widened mode at index 0 under `cuda` and over the
    dequantized codes through the plain attention under `eager`; and, over
    the int8 pool, the route its first prefill took before K2's widened
    mode ran over codes (`k1_fp32`: K1 over the pool's dequantized fp32
    values).  Four prompts of run (c)'s first-prefill length, 1088 tokens;
    the logits an admission returns (the last prompt token's) read against
    LOGIT_MAX_TOL / LOGIT_RMS_TOL of the logit scale, the dense prefill's
    gate in `serve_phase` (`within_gate`).  Gated: the RMS half, `cuda`
    against `eager`, for both pools.  The worst logit is read, not gated:
    over the int8 pool it moves by about 2 % of the scale between any two
    of the three routes, `k1_fp32` against `eager` included (PERF.md §6).
    Also read: each int8 route against the bf16 pool's `cuda`
    logits (what quantizing the pool costs), whether the argmax agrees,
    and the top-2 margin."""
    import numpy as np

    from repro_torch.kernels.flash_attention.ops import flash_attention, paged_gather_kv
    from repro_torch.nn import attention as attn_mod
    from repro_torch.runtime.pages import PagedCacheManager

    mcfg = server.woven.program.cfg
    impls = server.woven.state.impls
    cuda_impls = list(impls)
    captured = {}
    first_token = server._first_token
    flash_decode = attn_mod.flash_decode

    def capture(manager, rid, logits, fault=None):
        captured["logits"] = logits[0].float().clone()
        return first_token(manager, rid, logits, fault)

    def k1_over_dequantized(q, pk, pv, index, *, window, tables, kv_len, k_scale, v_scale,
                            softcap, pruned, **_):
        if k_scale is None or int(index.max()) != 0:
            raise AssertionError("only a quantized pool's first prefill takes K1 here")
        k, v = paged_gather_kv(pk, pv, tables, kv_len, k_scale=k_scale, v_scale=v_scale)
        return flash_attention(q, k, v, causal=True, window=window, softcap=softcap,
                               pruned=pruned)

    def admit(prompt, dtype, route):
        impls[:] = [] if route == "eager" else cuda_impls
        attn_mod.flash_decode = k1_over_dequantized if route == "k1_fp32" else flash_decode
        manager = PagedCacheManager(16, 128, max_len=server.cfg.max_cache_len,
                                    prefix_sharing=False, cache_dtype=dtype)
        server._paged_admit(manager, 0, prompt, len(prompt) + 1, None)
        del manager
        x = captured.pop("logits")
        if not torch.isfinite(x).all() or x.shape[-1] != mcfg.vocab:
            raise AssertionError(f"{dtype} pool, {route}: logits {x.shape}, not all finite")
        return x

    def gap(x, y):
        g = {"max_abs_err": (x - y).abs().max().item(),
             "rms_err": (x - y).pow(2).mean().sqrt().item(),
             "logit_scale": y.abs().max().item(),
             "argmax_equal": bool((x.argmax(-1) == y.argmax(-1)).all()),
             "top2_margin": (lambda t: (t[..., 0] - t[..., 1]).min().item())(
                 y.topk(2, dim=-1).values)}
        g["within_gate"] = (g["max_abs_err"] <= LOGIT_MAX_TOL * g["logit_scale"]
                            and g["rms_err"] <= LOGIT_RMS_TOL * g["logit_scale"])
        return g

    server._first_token = capture
    report = []
    try:
        for seed in (2, 3, 4, 5):
            prompt = np.random.default_rng(seed).integers(0, mcfg.vocab, 1088)
            got = {(None, r): admit(prompt, None, r) for r in ("cuda", "eager")}
            got.update({("int8", r): admit(prompt, "int8", r)
                        for r in ("cuda", "eager", "k1_fp32")})
            for dtype in (None, "int8"):
                x, y = got[dtype, "cuda"], got[dtype, "eager"]
                rms, scale = (x - y).pow(2).mean().sqrt().item(), y.abs().max().item()
                if not rms <= LOGIT_RMS_TOL * scale:
                    raise AssertionError(f"{dtype or 'bf16'} pool's first prefill, cuda vs "
                                         f"eager: rms {rms} at scale {scale}")
            report.append({
                "seed": seed, "tokens": len(prompt),
                "bf16_cuda_vs_eager": gap(got[None, "cuda"], got[None, "eager"]),
                "int8_cuda_vs_eager": gap(got["int8", "cuda"], got["int8", "eager"]),
                "int8_k1_fp32_vs_eager": gap(got["int8", "k1_fp32"], got["int8", "eager"]),
                "int8_cuda_vs_k1_fp32": gap(got["int8", "cuda"], got["int8", "k1_fp32"]),
                **{f"int8_{r}_vs_bf16_cuda": gap(got["int8", r], got[None, "cuda"])
                   for r in ("cuda", "eager", "k1_fp32")}})
            del got
    finally:
        impls[:] = cuda_impls
        attn_mod.flash_decode = flash_decode
        server._first_token = first_token
    return {"readings": report}


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
        route_counts(reset=True)
        solo_out = [server.serve(p) for p in solo]
        solo_s = list(server.latencies)[-2:]
        batch_out = server.serve_batch(batch)
        batch_s = server.latencies[-1]
        counts = {"flash_attention": flash_attention.launches,
                  "flash_decode": flash_decode.launches, "rmsnorm": rmsnorm.launches}
        routes = route_counts()
    finally:
        attn_ops.attention_ref, attn_ops.decode_ref, norm_ops.rmsnorm_ref = saved
    log(f"serve: routes {routes}")
    if routes["flash_attention_tc"] != counts["flash_attention"]:
        raise AssertionError(f"serve: bf16 K1 launches off the tensor-core route: {routes}")
    if routes["flash_decode_split"] != counts["flash_decode"]:
        raise AssertionError(f"serve: single-token K2 launches off the split route: {routes}")

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
    requests = {"solo": solo, "batch": batch, "solo_out": solo_out, "batch_out": batch_out}
    return {**counts, **routes}, server, requests


# ---------------------------------------------------------------------------
# phase 6b: the remaining decoder-only families at full width
# ---------------------------------------------------------------------------

# the depth each family runs at on one 80 GB card, and why it is cut (the
# width is the published one; bf16 weights from seed 0)
FAMILY_DEPTHS = {
    "mixtral-8x22b": (4, "56 layers of 2.50 B parameters (experts 2.42 B) need 281 GB"),
    "grok-1-314b": (2, "64 layers of 4.92 B parameters need 630 GB"),
    "qwen2-72b": (4, "80 layers of 0.88 B parameters need 141 GB"),
    "nemotron-4-340b": (2, "96 layers of 3.45 B parameters need 663 GB, beside 18.9 GB "
                           "of untied embeddings"),
}
FAMILY_PAGE = 128


def woven_program(torch, cfg, kernels: bool, policy: str | None = None,
                  extra: dict | None = None):
    """The model of `cfg` on the card, woven as the launchers weave it
    (`default_weave`, + `cuda_kernel_aspects` with `kernels`, else the plain
    implementations), at the `half` policy or `policy`, with `extra` on the
    weave state."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.program import Program
    from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
    from repro_torch.models.registry import build_model
    from repro_torch.nn.dtypes import PolicyResolver

    program = Program(model=build_model(cfg), cfg=cfg, kind="serve",
                      device=torch.device("cuda"))
    woven = default_weave(program, SHAPES["prefill_32k"], {},
                          extra_aspects=cuda_kernel_aspects() if kernels else None)
    if not kernels and any(impl == "cuda" for _, _, impl in woven.state.impls):
        raise AssertionError("the comparison path must run the plain implementations")
    if policy is not None:
        woven.state.policies = PolicyResolver.default(policy)
    woven.state.extra.update(extra or {})
    return woven


def family_servers(torch, arch, max_cache_len):
    """`arch` at its published width and `FAMILY_DEPTHS`' depth (one layer
    stack), woven to the CUDA kernels, and the same program woven to the
    plain implementations over the same param tree."""
    from repro_torch.models.registry import get_config
    from repro_torch.runtime.server import Server, ServerConfig

    depth, why = FAMILY_DEPTHS[arch]
    published = get_config(arch)
    cfg = published.replace(num_layers=depth, layer_groups=())
    scfg = ServerConfig(max_cache_len=max_cache_len, decode_tokens=32, seed=0)
    t0 = time.perf_counter()
    server = Server(woven_program(torch, cfg, True), scfg)
    eager = Server(woven_program(torch, cfg, False), scfg, params=server.params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in server.woven.program.model.parameters())
    log(f"families: {arch} at full width (d_model {cfg.d_model}, {cfg.n_heads} q / "
        f"{cfg.kv_heads} KV heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}), depth cut {published.num_layers} -> {depth} (layer groups "
        f"{published.layer_groups or '()'} -> one stack): {why}; {n_params / 1e9:.2f} B "
        f"parameters on the card in {time.perf_counter() - t0:.1f} s")
    return server, eager


class RouteRecorder:
    """While active, keeps every MoE routing's top-k experts in call order
    (`MoEMLP.route`), for the two paths of a logit gate to be compared, and
    its keep mask (each (token, k)'s capacity rank below the group's
    capacity at the layer's capacity factor)."""

    def __enter__(self):
        from repro_torch.nn.moe import MoEMLP, capacity

        self.calls, self.keeps, self.real = [], [], MoEMLP.route

        def recorded(module, params, xc, *a, **k):
            out = self.real(module, params, xc, *a, **k)
            self.calls.append(out[1].cpu())
            cap = capacity(xc.shape[1], module.top_k, module.capacity_factor,
                           module.num_experts)
            self.keeps.append((out[3] < cap).cpu())
            return out

        MoEMLP.route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.nn.moe import MoEMLP

        MoEMLP.route = self.real


def family_logit_gate(torch, server, eager, toks, pair) -> dict:
    """`logit_gap` of the kernel path against the plain path, gated at the
    full-depth logit gate (2e-2 worst, 1e-2 RMS of the logit scale); for a
    MoE model, how many tokens the two paths routed to other experts."""
    with RouteRecorder() as rec:
        gap = logit_gap(torch, server, eager, toks, pair)
    if rec.calls:  # the kernel path's routings, then the plain path's, in order
        half = len(rec.calls) // 2
        pairs = list(zip(rec.calls[:half], rec.calls[half:]))
        gap["tokens_routed_differently"] = sum(
            int((a.sort(-1).values != b.sort(-1).values).any(-1).sum()) for a, b in pairs)
        gap["routings_compared"] = sum(int(a[..., 0].numel()) for a, _ in pairs)
    gate_logits(f"families {pair} (routing {gap.get('tokens_routed_differently')})", gap)
    return gap


def family_run(torch, server, tag, prompts, *, gated_spec: bool, ring_pages: int | None):
    """One counted `serve_continuous` (max_batch 4, page 128) with the
    launch gates of `check_paged_run`; under MoE also asked for a draft
    length of 2 and a prefill chunk of 128, which the server must refuse
    (no speculation, no chunk, no shared page), with the tokens of a plain
    run of the same prompts.  `ring_pages`: the pool must be a ring pool of
    at most that many pages a request.  Returns the counts and the report."""
    import numpy as np

    kw = dict(max_batch=4, page_size=FAMILY_PAGE)
    asked = dict(draft_len=2, prefill_chunk=128) if gated_spec else {}
    torch.cuda.reset_peak_memory_stats()
    out, wall, counts, routes = counted_serve(
        torch, lambda: server.serve_continuous(prompts, **kw, **asked))
    check_paged_run(server, "families", tag, prompts, out, counts, routes, False)
    st, pool = dict(server.last_step_counts), dict(server.last_pool_stats)
    report = {"card": nvidia_smi_line(), "wall_s": wall, "launches": counts, "routes": routes,
              "steps": st, "pool": pool,
              "ttft_s": [o["ttft_s"] for o in server.last_outcomes],
              "tok_gap_max_s": [o["tok_gap_max_s"] for o in server.last_outcomes],
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if routes["flash_decode_tc"] or st["suffix_prefill"] or st["verify"] or st["draft"]:
        raise AssertionError(f"families {tag}: a widened K2 launch, a chunk or a "
                             f"speculative step ran: {routes}, steps {st}")
    if pool["prefix_hits"] or pool["cow_splits"]:
        raise AssertionError(f"families {tag}: pages were shared: {pool}")
    if gated_spec:
        if server.last_spec_stats is not None:
            raise AssertionError(f"families {tag}: speculation ran under MoE: "
                                 f"{server.last_spec_stats}")
        plain, _, pcounts, proutes = counted_serve(
            torch, lambda: server.serve_continuous(prompts, **kw))
        check_paged_run(server, "families", tag + "_plain", prompts, plain, pcounts, proutes,
                        False)
        same = all(np.array_equal(a, b) for a, b in zip(out, plain))
        report["tokens_equal_plain_run"] = same
        if not same:
            raise AssertionError(f"families {tag}: the gated serve's tokens differ from a "
                                 "plain run's")
    if ring_pages is not None:
        linear = sum(-(-(len(p) + server.cfg.decode_tokens) // FAMILY_PAGE) for p in prompts)
        bound_pages = len(prompts) * ring_pages
        report["ring_pages_bound"], report["linear_pages_needed"] = bound_pages, linear
        if not pool["peak_live_pages"] <= bound_pages < linear:
            raise AssertionError(f"families {tag}: {pool['peak_live_pages']} live pages: not "
                                 f"a ring pool of {ring_pages} pages a request")
    return {**counts, **routes, "verify_launches": server.woven.program.cfg.num_layers
            * st["verify"]}, report


def moe_drop_tap(torch, server, prompt) -> dict:
    """The `moe_drop_frac` tap of the first layer's MoE feed-forward over a
    prompt's normalised embeddings, at the capacity the prefill used (taps
    are off inside a layer stack, so the layer runs alone)."""
    from repro_torch.nn.module import Ctx

    model, params = server.woven.program.model, server.params
    ctx = Ctx(policies=server.woven.state.policies, extra=server.woven.state.extra,
              taps_enabled=["*"])
    block = model.trunk[0].template
    layer0 = {k: v[0] for k, v in params["blocks0"]["block"]["ffn"].items()}
    norm2 = {k: v[0] for k, v in params["blocks0"]["block"]["norm2"].items()}
    toks = torch.as_tensor(prompt[None], device=server.device).to(torch.int32)
    with torch.no_grad():
        x = model.embed(params["embed"], toks, ctx=ctx)
        block.ffn(layer0, block.norm2(norm2, x, ctx=ctx), ctx=ctx)
    return {"tokens": int(toks.shape[1]),
            "moe_drop_frac": float(ctx.taps["ffn/moe_drop_frac"])}


def families_phase(torch) -> dict:
    """The decoder-only families the port serves beside yi-6b, each at its
    published width and a depth one card holds (`FAMILY_DEPTHS`), random
    bf16 weights from seed 0, through `serve_continuous` over a paged pool
    (max_batch 4, page 128, 32 greedy tokens).

    Runs: (m1) mixtral-8x22b, six prompts of 1000..3000 tokens — a linear
    pool under its 4096-token window — asked for a draft length of 2 and a
    prefill chunk of 128, which capacity-routed MoE refuses; (m2) the same
    model, four prompts of 4500..6000 tokens past the window: a ring pool
    (K2's paged ring mode), asked the same; (g) grok-1-314b (MoE, soft-cap
    30) and (d) qwen2-72b and nemotron-4-340b (head_dim 192, G = 12,
    LayerNorm), four prompts of 512..2000 tokens each.  Gates: every
    outcome ok; exact launches by route (`check_paged_run`): K1 once a
    layer an admission and probe, K2 once a layer a decode step, all on the
    split route, K4 as `expected_launches` reckons (none under nemotron's
    LayerNorm), no plain version; under MoE no speculative step, no chunk,
    no shared page, `last_spec_stats` None and the tokens of a plain run;
    (m2)'s pool at most ceil(4096 / 128) pages a request; the first
    prefill's and decode's logits against the plain path at the full-depth
    logit gate (`family_logit_gate`).  Printed: TTFT, largest gap, wall, a
    decode step's busy time, peak memory, the MoE drop fraction of (m2)'s
    longest prompt, and how many tokens the two paths of the logit gate
    routed to other experts."""
    import gc

    import numpy as np

    out, report = {}, {}
    rng = np.random.default_rng(21)
    runs = [("mixtral-8x22b", 6144, [
        ("mixtral_linear", [1000, 1400, 1800, 2200, 2600, 3000], None),
        ("mixtral_ring", [4500, 5000, 5500, 6000], -(-4096 // FAMILY_PAGE))]),
        ("grok-1-314b", 2048, [("grok", [512, 1000, 1500, 2000], None)]),
        ("qwen2-72b", 2048, [("qwen2", [512, 1000, 1500, 2000], None)]),
        ("nemotron-4-340b", 2048, [("nemotron", [512, 1000, 1500, 2000], None)])]
    for arch, max_len, arch_runs in runs:
        torch.cuda.empty_cache()
        server, eager = family_servers(torch, arch, max_len)
        mcfg = server.woven.program.cfg
        moe = mcfg.family == "moe"
        # a warm-up outside the counted runs (cuBLAS handles, the build)
        server.serve(rng.integers(0, mcfg.vocab, (1, 16), dtype=np.int32), decode_tokens=2)
        for tag, lens, ring_pages in arch_runs:
            prompts = [rng.integers(0, mcfg.vocab, n).astype(np.int64) for n in lens]
            counts, rep = family_run(torch, server, tag, prompts, gated_spec=moe,
                                     ring_pages=ring_pages)
            toks = torch.as_tensor(prompts[0][None].astype(np.int32), device=server.device)
            rep["logits_vs_eager"] = family_logit_gate(torch, server, eager, toks,
                                                       f"{tag}: cuda vs eager, "
                                                       f"{toks.shape[1]} tokens")
            if ring_pages is not None:
                rep["moe_drop_tap"] = moe_drop_tap(torch, server, prompts[-1])
            rep["profile"] = profile_decode(torch, server, toks[:, :512].repeat(2, 1))
            rep.update(model=arch, layers=mcfg.num_layers, prompt_tokens=lens)
            log(f"families {tag} " + json.dumps(rep, default=str))
            out[tag], report[tag] = counts, rep
        del server, eager
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6c: the encoder-decoder and the image prefix at full width and depth
# ---------------------------------------------------------------------------

# whisper-small: 8 clips of 1500 stub frames (a 30-second window: 3000 mel
# frames, 1500 after the stride-2 convolution `frames` stands in for), a
# 4-token start-of-transcript prompt, 64 greedy tokens in its 448-token text
# context.  internvl2-1b: 4 requests of 256 image embeddings (one 448 x 448
# tile after pixel shuffle) and 512 text tokens, 64 greedy tokens.  `gate`:
# the policy the logit gate holds the kernel path to the eager twin in.
# internvl2-1b's is fp32, as rwkv6's is (`serve_recurrent`): at 24 layers
# over 768 positions its bf16 logits part by 2.67 % of the logit scale
# (worst) between two plain forms of the attention alone (the eager one and
# its blocked online softmax), beyond the 2e-2 gate, while the kernel path
# lies 2.39 % from the one and 2.01 % from the other, and 4.6e-6 from the
# eager path in fp32 (an H100 80GB HBM3 at 700 W); the bf16 readings and
# that floor are printed beside.
FRONTEND_RUNS = {
    "whisper-small": dict(batch=8, stub=1500, prompt=4, tokens=64, cache_max_len=448,
                          gate="bf16"),
    "internvl2-1b": dict(batch=4, stub=256, prompt=512, tokens=64, cache_max_len=1024,
                         gate="fp32"),
}
# internvl2-1b's text-only traffic through `serve_continuous` (`family_run`)
FRONTEND_TEXT_LENS = [256, 600, 1000, 1400, 1800, 2048]


def frontend_programs(torch, arch, policy: str | None = None):
    """The kernel path, its eager twin, and one param tree for both: random
    weights from seed 0 (bf16 at the `half` policy)."""
    from repro_torch.models.registry import get_config
    from repro_torch.nn.module import init_params

    t0 = time.perf_counter()
    kern = woven_program(torch, get_config(arch), True, policy)
    eager = woven_program(torch, get_config(arch), False, policy)
    params = init_params(kern.program.model, 0, kern.state.policies, "cuda")
    torch.cuda.synchronize()
    cfg = kern.program.cfg
    n_params = sum(p.numel() for p in kern.program.model.parameters())
    log(f"frontends: {arch} at full width and depth ({cfg.num_layers} layers"
        f"{f' + {cfg.enc_layers} encoder layers' if cfg.enc_layers else ''}, d_model "
        f"{cfg.d_model}, {cfg.n_heads} q / {cfg.kv_heads} KV heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), policy "
        f"{policy or 'half'}: {n_params} parameters ({n_params / 1e9:.3f} B; "
        f"cfg.param_count() {cfg.param_count()}) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return kern, eager, params


def first_logits(torch, woven, params, inputs, cache_max_len, pos0, tok=None):
    """A prefill's logits and the first decode step's (fed `tok`, else the
    prefill's argmax) on one woven program."""
    from repro_torch.runtime.steps import build_decode_step, build_prefill_step

    logits, cache = build_prefill_step(woven, cache_max_len=cache_max_len)(params, inputs)
    if tok is None:
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    pos = torch.full((tok.shape[0], 1), pos0, dtype=torch.int32, device="cuda")
    first, _ = build_decode_step(woven)(params, {"tokens": tok, "positions": pos}, cache)
    return logits, first, tok


def frontend_run(torch, arch) -> tuple[dict, dict, tuple]:
    """One model of `frontends_phase`: a counted prefill and a counted greedy
    loop on the kernel path, the logit gate and the token agreement against
    the eager twin, a decode-step profile.  Returns the counts (prefill and
    loop together, with routes), the report and `frontend_programs`'
    programs and params."""
    import numpy as np

    from repro_torch.runtime.steps import build_decode_step, build_prefill_step

    run = FRONTEND_RUNS[arch]
    torch.cuda.reset_peak_memory_stats()
    kern, eager, params = frontend_programs(torch, arch)
    cfg, model = kern.program.cfg, kern.program.model
    B, n, P = run["batch"], run["tokens"], run["stub"]
    encdec = cfg.family == "encdec"
    rng = np.random.default_rng(22)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, run["prompt"]), dtype=np.int32),
                             device="cuda")
    stub32 = torch.as_tensor(rng.standard_normal((B, P, cfg.d_model), dtype=np.float32),
                             device="cuda")
    stub = stub32.to(torch.bfloat16)
    inputs = {"tokens": tokens, ("frames" if encdec else "embeds"): stub}
    pos0 = run["prompt"] + (0 if encdec else P)  # the decoder's positions count the prefix
    steps = {}
    for tag, woven in (("kernel", kern), ("eager", eager)):
        steps[tag] = (build_prefill_step(woven, cache_max_len=run["cache_max_len"]),
                      build_decode_step(woven))

    def greedy(tag, logits, cache, check_cross=False):
        """n greedy decode steps from a prefill's `logits` and `cache`: the
        tokens fed (B, n), the first step's logits, the cache."""
        decode = steps[tag][1]
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        cross = cache["decoder"]["cross"] if check_cross else None
        fed, first = [], None
        for i in range(n):
            pos = torch.full((B, 1), pos0 + i, dtype=torch.int32, device="cuda")
            logits, cache = decode(params, {"tokens": tok, "positions": pos}, cache)
            if cross is not None:  # the same tensors, never written
                now = cache["decoder"]["cross"]
                if any(now[k] is not cross[k] or now[k].data_ptr() != ptr[k]
                       for k in ("ck", "cv")):
                    raise AssertionError(f"frontends {arch}: decode step {i} replaced "
                                         "the cross cache")
            first = logits if first is None else first
            fed.append(tok)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        return torch.cat(fed, dim=1), first, cache

    # warm-up outside the counted runs (cuBLAS handles, the kernels' build)
    logits, cache = steps["kernel"][0](params, inputs)
    greedy("kernel", logits, cache)
    del logits, cache

    per_layer_norms = 0 if cfg.norm_type == "layernorm" else 2 * cfg.num_layers + 1
    k1 = cfg.num_layers + (cfg.enc_layers if encdec else 0)
    zero = {"flash_attention": 0, "flash_attention_bwd": 0, "flash_decode": 0, "rmsnorm": 0,
            "rglru": 0, "wkv": 0, "flash_attention_lse": 0}
    want_prefill = {**zero, "flash_attention": k1, "rmsnorm": per_layer_norms}
    want_loop = {**zero, "flash_decode": 2 * cfg.num_layers * n if encdec
                 else cfg.num_layers * n, "rmsnorm": per_layer_norms * n}

    t0 = time.perf_counter()
    (logits_k, cache), c_pre, r_pre = counted_run(
        torch, lambda: steps["kernel"][0](params, inputs), f"frontends {arch} prefill")
    prefill_s = time.perf_counter() - t0
    log(f"frontends {arch}: prefill launches {c_pre}, expected {want_prefill}; routes {r_pre}")
    if c_pre != want_prefill:
        raise AssertionError(f"frontends {arch}: prefill launches {c_pre} != {want_prefill}")
    ptr, checksum = {}, {}
    if encdec:
        cross = cache["decoder"]["cross"]
        ptr = {k: cross[k].data_ptr() for k in ("ck", "cv")}
        checksum = {k: cross[k].double().sum().item() for k in ("ck", "cv")}
    t0 = time.perf_counter()
    (fed_k, first_k, cache), c_loop, r_loop = counted_run(
        torch, lambda: greedy("kernel", logits_k, cache, check_cross=encdec),
        f"frontends {arch} decode")
    loop_s = time.perf_counter() - t0
    log(f"frontends {arch}: {n} decode steps' launches {c_loop}, expected {want_loop}; "
        f"routes {r_loop}")
    if c_loop != want_loop:
        raise AssertionError(f"frontends {arch}: decode launches {c_loop} != {want_loop}")
    if fed_k.shape != (B, n) or int(fed_k.min()) < 0 or int(fed_k.max()) >= cfg.vocab:
        raise AssertionError(f"frontends {arch}: tokens of the wrong shape or range")
    if encdec:
        cross = cache["decoder"]["cross"]
        again = {k: cross[k].double().sum().item() for k in ("ck", "cv")}
        if again != checksum or any(cross[k].data_ptr() != ptr[k] for k in ptr):
            raise AssertionError(f"frontends {arch}: the cross cache was written: "
                                 f"{checksum} -> {again}")

    def decode_steps(k):
        nonlocal cache
        for i in range(k):
            pos = torch.full((B, 1), pos0 + n + i, dtype=torch.int32, device="cuda")
            _, cache = steps["kernel"][1](params, {"tokens": fed_k[:, -1:], "positions": pos},
                                          cache)
        torch.cuda.synchronize()

    profile = profile_steps(torch, decode_steps, 4, f"decode_step_wall_ms_B{B}")
    del cache
    encoder_s = None
    if encdec:  # the encoder alone, on the kernel path
        ctx = kern.state.make_ctx()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model.encode(params, stub, ctx=ctx)
        torch.cuda.synchronize()
        encoder_s = time.perf_counter() - t0

    # the eager twin: the same prefill and first decode (fed the kernel
    # path's first token), then its own greedy tokens; beside them the gap
    # between two plain forms of the prefill, the bf16 floor the gate sits on
    logits_e, first_e, _ = first_logits(torch, eager, params, inputs, run["cache_max_len"],
                                        pos0, fed_k[:, :1])
    blocked = woven_program(torch, cfg, False, extra={"eager_attn_block": 256})
    logits_b = build_prefill_step(blocked, cache_max_len=run["cache_max_len"])(params, inputs)[0]
    gap = {"pair": f"{arch}: cuda vs eager, B{B}, bf16",
           "prefill": logit_diff(torch, "prefill", logits_k, logits_e),
           "first_decode": logit_diff(torch, "first_decode", first_k, first_e),
           "prefill_plain_blocked_vs_plain": logit_diff(torch, "prefill", logits_b, logits_e),
           "prefill_cuda_vs_plain_blocked": logit_diff(torch, "prefill", logits_k, logits_b)}
    del logits_e, first_e, logits_b, blocked
    gaps = {"bf16": gap}
    if run["gate"] == "fp32":
        k32, e32, p32 = frontend_programs(torch, arch, policy="double")
        inputs32 = {**inputs, ("frames" if encdec else "embeds"): stub32}
        a = first_logits(torch, k32, p32, inputs32, run["cache_max_len"], pos0)
        b = first_logits(torch, e32, p32, inputs32, run["cache_max_len"], pos0, a[2])
        gaps["fp32"] = {"pair": f"{arch}: cuda vs eager, B{B}, fp32",
                        "prefill": logit_diff(torch, "prefill", a[0], b[0]),
                        "first_decode": logit_diff(torch, "first_decode", a[1], b[1])}
        del k32, e32, p32, a, b
    for tag, g in gaps.items():
        log(f"frontends {arch} logits ({tag}): " + json.dumps(g))
    gate_logits(f"frontends {arch} ({run['gate']})", gaps[run["gate"]])
    fed_e, _, _ = greedy("eager", *steps["eager"][0](params, inputs))
    differ = fed_k != fed_e
    report = {
        "card": nvidia_smi_line(), "model": arch, "batch": B, "stub_len": P,
        "prompt_tokens": run["prompt"], "decode_tokens": n, "parameters": sum(
            p.numel() for p in model.parameters()), "param_count": cfg.param_count(),
        "prefill_launches": c_pre, "decode_launches": c_loop, "routes_prefill": r_pre,
        "routes_decode": r_loop, "prefill_wall_ms": prefill_s * 1e3,
        "encoder_wall_ms": None if encoder_s is None else encoder_s * 1e3,
        "decode_loop_wall_ms_per_step": loop_s * 1e3 / n, "profile": profile,
        "logits_vs_eager": gaps, "gated_logits": run["gate"],
        "greedy_token_agreement_vs_eager": 1.0 - float(differ.float().mean()),
        "greedy_first_divergence": [int(d.nonzero()[0, 0]) if d.any() else n
                                    for d in differ],
        "cross_cache_unwritten": encdec or None,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    counts = {key: c_pre[key] + c_loop[key] for key in c_pre}
    counts.update({key: r_pre[key] + r_loop[key] for key in r_pre})
    return counts, report, (kern, eager, params)


def frontends_phase(torch) -> dict:
    """whisper-small's encoder-decoder and internvl2-1b's image prefix at
    their published width and depth, random bf16 weights from seed 0, on the
    path the reference drives them by: the woven `build_prefill_step` /
    `build_decode_step` in a greedy loop (`Server` takes tokens only).

    Runs: (w) whisper-small, 8 clips of 1500 stub frames, a 4-token prompt,
    64 greedy tokens (cache 448); (v) internvl2-1b, 4 requests of 256 image
    embeddings and 512 tokens, 64 greedy tokens at positions 768 + i (cache
    1024); (t) internvl2-1b's text-only requests through `serve_continuous`
    (`family_run`: six prompts of 256..2048 tokens, max_batch 4, page 128,
    32 tokens; K2's paged split route at G = 7, K1 on admission).  Gates:
    exact launches by route — (w) a prefill K1 24 (12 non-causal in the
    encoder, 12 causal), a decode step K2 24 (12 over the self cache, 12
    cross over the 1500 encoder slots at index 1499), no K4 (LayerNorm);
    (v) a prefill K1 24, a step K2 24, K4 2 x 24 + 1 a call; all on the
    tensor-core / split routes, no plain version — the cross cache handed
    back by every decode step as the same tensors and unwritten, and the
    first prefill's and decode's full-depth logits against the eager twin
    at the logit gate (`gate_logits`; (w) in bf16, (v) in fp32, see
    `FRONTEND_RUNS`); (t) `family_run`'s and `family_logit_gate`'s gates.
    Printed: prefill wall (the encoder apart), a decode step's busy and idle
    time, peak memory, the bf16 logit gaps beside the gap between two plain
    forms of the prefill, the greedy tokens' agreement with the eager twin,
    the phase's seconds."""
    import numpy as np

    from repro_torch.runtime.server import Server, ServerConfig

    t_phase = time.perf_counter()
    out = {}
    counts, report, _ = frontend_run(torch, "whisper-small")
    log("frontends whisper " + json.dumps(report, default=str))
    out["whisper"] = counts
    gc.collect()
    torch.cuda.empty_cache()
    counts, report, (kern, eager, params) = frontend_run(torch, "internvl2-1b")
    log("frontends internvl_image " + json.dumps(report, default=str))
    out["internvl_image"] = counts

    scfg = ServerConfig(max_cache_len=2176, decode_tokens=32, seed=0)
    server = Server(kern, scfg, params=params)
    eager_srv = Server(eager, scfg, params=params)
    rng = np.random.default_rng(23)
    vocab = kern.program.cfg.vocab
    server.serve(rng.integers(0, vocab, (1, 16), dtype=np.int32), decode_tokens=2)
    prompts = [rng.integers(0, vocab, n).astype(np.int64) for n in FRONTEND_TEXT_LENS]
    counts, rep = family_run(torch, server, "internvl_text", prompts, gated_spec=False,
                             ring_pages=None)
    toks = torch.as_tensor(prompts[0][None].astype(np.int32), device="cuda")
    rep["logits_vs_eager"] = family_logit_gate(torch, server, eager_srv, toks,
                                               f"internvl_text: cuda vs eager, "
                                               f"{toks.shape[1]} tokens")
    rep.update(model="internvl2-1b", prompt_tokens=FRONTEND_TEXT_LENS)
    log("frontends internvl_text " + json.dumps(rep, default=str))
    out["internvl_text"] = counts
    del server, eager_srv, kern, eager, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"frontends: phase took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 7: serve full-width recurrentgemma-2b and rwkv6-3b
# ---------------------------------------------------------------------------


def counted_run(torch, fn, tag):
    """Run `fn` with every launch counter at 0 and every plain version a
    kernel wrapper could take forbidden; returns fn's result, the counts and
    the route counts.  Every K1 / K3 launch of these runs is bf16 and must
    have reported the tensor-core route, and every K2 launch is one bf16
    token and must have reported the split route (checked; `tag` names the
    run)."""
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
    route_counts(reset=True)
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for (mod, name), value in zip(plain, saved):
            setattr(mod, name, value)
    counts = {name: fn_.launches for name, fn_ in counters.items()}
    counts["flash_attention_lse"] = attn_ops.flash_attention.lse_launches
    routes = route_counts()
    if (routes["flash_attention_tc"] != counts["flash_attention"]
            or routes["flash_attention_bwd_tc"] != counts["flash_attention_bwd"]):
        raise AssertionError(f"{tag}: bf16 K1 / K3 launches off the tensor-core route: {routes}")
    if routes["flash_decode_split"] != counts["flash_decode"]:
        raise AssertionError(f"{tag}: single-token K2 launches off the split route: {routes}")
    return out, counts, routes


# rwkv6-3b's served layers (of 32), as many as its training runs
# (`TRAIN_FAMILY_RUNS`): the phase builds five full-width servers of it (the
# kernels', the plain chunked and sequential WKV's, the kernels' and the
# plain chunked WKV's again in fp32), each serving at this depth
RWKV_SERVE_LAYERS = 8


def recurrent_phase(torch) -> dict:
    """Full-width recurrentgemma-2b at full depth (26 layers, 18 RG-LRU and 8
    local-attention blocks) and rwkv6-3b at `RWKV_SERVE_LAYERS` of 32
    layers, random weights from seed 0, through `serve` and `serve_batch`;
    see `serve_recurrent`."""
    out = {}
    for arch, published in (("recurrentgemma-2b", (26, 2560, 256000)),
                            ("rwkv6-3b", (RWKV_SERVE_LAYERS, 2560, 65536))):
        out[arch] = serve_recurrent(torch, arch, published)
        torch.cuda.empty_cache()
    return out


def recurrent_server(torch, arch, cfg, layers: int, *, kernels: bool, policy=None,
                     wkv=None):
    """A full-width server of `layers` layers built as
    `launch/serve.build_server` builds it, woven to the CUDA kernels or to
    the plain implementations (`wkv` picks the plain WKV form), at the
    `half` policy or the given one."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.program import Program
    from repro_torch.core.strategies.kernels import KernelAspect
    from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.nn.dtypes import PolicyResolver
    from repro_torch.runtime.server import Server

    mcfg = get_config(arch)
    if layers != mcfg.num_layers:
        mcfg = mcfg.replace(num_layers=layers, layer_groups=())
    program = Program(model=build_model(mcfg), cfg=mcfg, kind="serve", device="cuda")
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
        out[what] = logit_diff(torch, what, results[0][i], results[1][i])
    return out


def logit_diff(torch, what, x, y) -> dict:
    """Worst and RMS difference of logits `x` against `y`, and `y`'s largest
    magnitude (the logit scale the gates are shares of)."""
    x, y = x.float(), y.float()
    if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
        raise AssertionError(f"{what} logits are not finite")
    if x.shape != y.shape:
        raise AssertionError(f"{what} logits have shapes {x.shape}, {y.shape}")
    return {"max_abs_err": (x - y).abs().max().item(),
            "rms_err": (x - y).pow(2).mean().sqrt().item(),
            "logit_scale": y.abs().max().item()}


def gate_logits(tag, gap: dict) -> None:
    """The full-depth logit gate: for the prefill and the first decode step,
    the worst logit within LOGIT_MAX_TOL and the RMS within LOGIT_RMS_TOL of
    the logit scale."""
    for what in ("prefill", "first_decode"):
        r = gap[what]
        if not (r["max_abs_err"] <= LOGIT_MAX_TOL * r["logit_scale"]
                and r["rms_err"] <= LOGIT_RMS_TOL * r["logit_scale"]):
            raise AssertionError(f"{tag}: {what} logits differ by {r}")


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

    from repro_torch.models.lm import RecBlock
    from repro_torch.runtime.server import ServerConfig

    decode_tokens = 32
    cfg = ServerConfig(max_cache_len=4096, decode_tokens=decode_tokens, seed=0)
    t0 = time.perf_counter()
    server = recurrent_server(torch, arch, cfg, published[0], kernels=True)
    torch.cuda.synchronize()
    model, mcfg = server.woven.program.model, server.woven.program.cfg
    layers = mcfg.num_layers
    n_params = sum(p.numel() for p in model.parameters())
    log(f"recurrent: {arch} full width: {layers} layers, d_model {mcfg.d_model}, "
        f"{n_params / 1e9:.2f} B parameters on the card in {time.perf_counter() - t0:.1f} s; "
        f"impls {server.woven.state.impls}")
    if (layers, mcfg.d_model, mcfg.vocab) != published:
        raise AssertionError(f"not the published {arch} configuration at {layers} layers")
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
    solo = rng.integers(0, mcfg.vocab, SERVE_SOLO, dtype=np.int32)
    batch = [rng.integers(0, mcfg.vocab, n).astype(np.int64) for n in SERVE_BATCH_LENS]
    server.serve(rng.integers(0, mcfg.vocab, (1, 16), dtype=np.int32), decode_tokens=2)

    def main_path():
        solo_out = server.serve(solo)
        solo_s = server.latencies[-1]
        return solo_out, solo_s, server.serve_batch(batch), server.latencies[-1]

    (solo_out, solo_s, batch_out, batch_s), counts, routes = counted_run(torch, main_path,
                                                                         arch)
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

    _, dec_counts, _ = counted_run(torch, decode_steps, arch + " decode")
    want_dec = {k: 4 * v for k, v in per_call(False).items()}
    log(f"recurrent: {arch} 4 decode steps: launches {dec_counts}, expected {want_dec}")
    if dec_counts != want_dec:
        raise AssertionError(f"{arch}: decode launches {dec_counts} != {want_dec}")
    del cache

    # -- against the same model woven to the plain implementations ------------
    eager = recurrent_server(torch, arch, cfg, layers, kernels=False)
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
        scan = recurrent_server(torch, arch, cfg, layers, kernels=False, wkv="scan")
        report["bf16_plain_scan_vs_plain_chunked"] = logit_gap(
            torch, scan, eager, toks, "plain sequential WKV vs plain chunked WKV, bf16")
        del scan, eager
        torch.cuda.empty_cache()
        k32 = recurrent_server(torch, arch, cfg, layers, kernels=True, policy="double")
        e32 = recurrent_server(torch, arch, cfg, layers, kernels=False, policy="double")
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
    gate_logits(f"{arch} ({gated})", report[gated])
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
        "launches": counts, "routes": routes, "decode_launches_4_steps": dec_counts,
        "logits_vs_eager": report, "gated_logits": gated,
        "token_agreement_vs_eager": agree_eager,
        "token_agreement_batch_vs_solo": agree_batch,
        "token_agreement_batch_vs_solo_fp32": agree_fp32,
        "ttft_ms_B2_S512": ttft_ms, "eager_ttft_ms_B2_S512": report["bf16"]["ttft_ms_b"],
        "solo_serve_s_B2_S512_N32": solo_s,
        "decode_ms_per_token_B2": (solo_s * 1e3 - ttft_ms) / decode_tokens,
        "batch_serve_s_B8_N32": batch_s, "batch_prompt_tokens": SERVE_BATCH_LENS,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("recurrent " + json.dumps(summary))
    del server
    return {**counts, **routes}


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


def gradient_digest(torch, woven, params, mb, stacks, match: str = "attn/") -> tuple:
    """One gradient of `woven` at `params` on the microbatch `mb`, kept as
    the loss, the global gradient norm and the attention weights' gradients
    (the leaves whose path holds `match`) in fp32 — each leaf of a layer
    stack (its first path component in `stacks`) as its layers' (L, n) rows,
    an unrolled block's as one row — so that the rest of the tree is freed
    before the next gradient."""
    from repro_torch.runtime.steps import build_grad_fn

    (loss, _), grads = build_grad_fn(woven)(params, mb)
    norm = sum(g.float().pow(2).sum() for _, g in _paths(grads)).sqrt().item()
    attn = {path: g.float().reshape(g.shape[0] if path.split("/")[0] in stacks else 1, -1)
            for path, g in _paths(grads) if match in path}
    return loss.item(), norm, attn


def stack_names(woven) -> set:
    """The top-level layer stacks of `woven`'s model (`gradient_digest`)."""
    return {path for path, m in woven.program.model.walk()
            if m.kind == "stack" and "/" not in path}


def eager_weave(woven, overrides):
    """`woven`'s program woven to the plain attention at `woven`'s policies."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.weave import default_weave

    eager = default_weave(woven.program, SHAPES["train_4k"], {},
                          overrides=dict(overrides))
    eager.state.policies = woven.state.policies
    if any(impl == "cuda" for _, _, impl in eager.state.impls):
        raise AssertionError("the comparison weave must run the plain attention")
    return eager


def compare_gradients(tag, got, want, n_attn: int, gated: bool = True,
                      labels=("kernels", "eager")) -> dict:
    """Two `gradient_digest`s of one microbatch on the same weights: the
    loss, the global gradient norm, and each attention weight's gradient
    (relative L2 per layer of a stack; an unrolled block's weight is its
    own layer; the worst layer a weight).  The model holds `n_attn`
    attention weights (whisper's cross-attention among them: plain on every
    path, its gradients carry the self-attention's backward through the
    layers above).  Gated within `TRAIN_*_REL_TOL` unless `gated` is False
    (a reading printed beside a gate); `labels` name the two sides."""
    (loss_a, gn_a, attn_a), (loss_b, gn_b, attn_b) = got, want
    a, b = labels
    worst = rel_l2_by_layer(attn_a, attn_b)
    out = {f"loss_{a}": loss_a, f"loss_{b}": loss_b,
           "loss_rel_err": abs(loss_a - loss_b) / abs(loss_b),
           f"grad_norm_{a}": gn_a, f"grad_norm_{b}": gn_b,
           "grad_norm_rel_err": abs(gn_a - gn_b) / gn_b,
           "attn_weights": len(worst),
           "attn_grad_rel_l2_worst": max(worst.values()),
           "attn_grad_rel_l2_worst_layer": worst}
    log(f"{tag} " + json.dumps(out))
    if len(worst) != n_attn:
        raise AssertionError(f"{tag}: expected {n_attn} attention weights, got {sorted(worst)}")
    if gated and not (out["loss_rel_err"] <= TRAIN_LOSS_REL_TOL
                      and out["grad_norm_rel_err"] <= TRAIN_GNORM_REL_TOL
                      and all(v <= TRAIN_WGRAD_REL_TOL for v in worst.values())):
        raise AssertionError(f"{tag}: the {a} path's gradient differs from the {b} "
                             f"path's: {out}")
    return out


def kernel_vs_eager_gradient(torch, woven, params, mb, overrides, n_attn: int,
                             tag: str) -> dict:
    """The gradient through the kernels (`woven`) at `params` on one
    microbatch `mb` against the gradient of the same program woven to the
    plain attention (`eager_weave`), gated (`compare_gradients`)."""
    stacks = stack_names(woven)
    got = gradient_digest(torch, woven, params, mb, stacks)
    want = gradient_digest(torch, eager_weave(woven, overrides), params, mb, stacks)
    return compare_gradients(f"{tag}-vs-eager", got, want, n_attn)


@contextlib.contextmanager
def plain_backward(torch, consistent_delta: bool):
    """K3 stood in for by its plain version, `flash_attention_bwd_ref` (the
    reference kernel's formula, in fp32), on the residuals K1 saved — the
    forward stays K1, so both paths see the same output, lse and upstream
    gradients until the first backward, and only K3 differs.  delta =
    rowsum(dO O) takes the bf16 output as K3 does, or, with
    `consistent_delta`, the fp32 output recomputed by `attention_ref`, so
    that delta is rowsum(P dP) up to fp32 rounding.  K3 does not launch
    inside (checked)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref,
        flash_attention_bwd_ref,
    )

    def bwd(q, k, v, out, lse, do, *, causal, window, softcap, **_knobs):
        if consistent_delta:
            out = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                window=window, softcap=softcap)
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                       window=window, softcap=softcap)

    kernel, launches = ops.flash_attention_bwd, ops.flash_attention_bwd.launches
    ops.flash_attention_bwd = bwd
    try:
        yield
    finally:
        ops.flash_attention_bwd = kernel
    if kernel.launches != launches:
        raise AssertionError("K3 launched on the plain backward's path")


def rel_l2_by_layer(got: dict, want: dict) -> dict:
    """Each weight's worst relative L2 error over its layers (rows)."""
    return {path: ((g - want[path]).norm(dim=1) / want[path].norm(dim=1)).max().item()
            for path, g in got.items()}


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
        elastic = elastic_restore(torch, first, ckpt)
        resumed = make(ckpt, 2)
        if not (resumed.maybe_restore() and resumed.step == 4
                and resumed.pipeline.step == 4):
            raise AssertionError("the resumed trainer did not pick up step 4")
        tail = [h["loss"] for h in resumed.run(2)]
    straight = [h["loss"] for h in make(None, 6).run()][4:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(tail, straight))
    out = {"resumed_losses": tail, "straight_losses": straight, "max_rel_err": rel,
           "elastic": elastic}
    log("train-resume " + json.dumps(out))
    if not rel <= RESUME_LOSS_REL_TOL:
        raise AssertionError(f"resumed losses {tail} differ from the straight run's "
                             f"{straight}")
    return out


def elastic_restore(torch, trainer, ckpt_dir) -> dict:
    """Elastic restore onto the card mesh (`distributed/elastic.reshard_params`)
    from the checkpoint `trainer` just wrote: every parameter leaf placed on
    the card, bit for bit the trainer's."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.elastic import plan_rescale, reshard_params
    from repro_torch.launch.mesh import make_card_mesh
    from repro_torch.optim.tree import leaves

    mesh, rules = make_card_mesh(), trainer.woven.state.rules
    plan = plan_rescale(trainer.pipeline.cfg.global_batch, mesh, rules)
    placed, manifest = reshard_params(trainer.woven.program.model, Checkpointer(ckpt_dir),
                                      mesh, rules, trainer.params, trainer.step)
    got, want = leaves(placed), leaves(trainer.params)
    same = len(got) == len(want) and all(
        g.is_cuda and g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))
    out = {"mesh": dict(mesh.shape), "plan": plan, "step": manifest["step"],
           "leaves": len(got), "bit_for_bit": same}
    log("elastic-restore " + json.dumps(out))
    if not same:
        raise AssertionError("the parameters restored onto the card mesh differ from "
                             "the trainer's")
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
    step_s, totals, route_totals = [], {k: 0 for k in want}, {}
    for i in range(steps):
        t = time.perf_counter()
        _, counts, routes = counted_run(torch, lambda: trainer.run(1), f"train step {i + 1}")
        step_s.append(time.perf_counter() - t)
        h = trainer.history[-1]
        log(f"train: step {h['step']}: loss {h['loss']:.6f}, accuracy {h['accuracy']:.4f}, "
            f"grad norm {h['grad_norm']:.4f}, {step_s[-1] * 1e3:.1f} ms, launches {counts}")
        if counts != want:
            raise AssertionError(f"step {i + 1}: launch counters {counts} != expected {want}")
        for k in totals:
            totals[k] += counts[k]
        for k, n in routes.items():
            route_totals[k] = route_totals.get(k, 0) + n
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

    nxt = trainer.pipeline.batch_at(trainer.pipeline.step)
    mb = {k: torch.as_tensor(v[:batch // accum]).to("cuda") for k, v in nxt.items()}
    compare = kernel_vs_eager_gradient(torch, woven, trainer.params, mb, overrides, 4,
                                       "train")
    policies = remat_policy_runs(torch, trainer, mb, overrides)
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
        "launches_per_step": want, "launches_6_steps": {**totals, **route_totals},
        "profile": profile_out, "vs_eager": compare, "remat_policies": policies,
    }
    log("train " + json.dumps(summary))
    del trainer
    torch.cuda.empty_cache()
    summary["resume"] = resume_phase(torch)
    return summary


def remat_policy_runs(torch, trainer, mb, overrides) -> dict:
    """gemma-2b's microbatch `mb` on the trainer's current weights, one
    gradient under each remat policy `full`, `dots` and `dots_no_batch`, each
    a counted run: the loss and every gradient bit for bit `full`'s (the
    kernels and cuBLAS are deterministic at fixed shapes), and the launches
    each policy implies — K1 (with lse) twice a layer under all three, since
    its autograd function is opaque to a selective policy and reruns whole
    in the recompute, K3 once a layer, nothing else.  Printed: each
    gradient's wall time and its peak memory above what was resident
    before it (its gradient tree included)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.weave import default_weave, train_kernel_aspects
    from repro_torch.runtime.steps import build_grad_fn

    layers = trainer.woven.program.cfg.num_layers
    want = {"flash_attention": 2 * layers, "flash_attention_lse": 2 * layers,
            "flash_attention_bwd": layers, "flash_decode": 0, "rmsnorm": 0, "rglru": 0,
            "wkv": 0}
    full, out = None, {}
    for policy in ("full", "dots", "dots_no_batch"):
        woven = default_weave(trainer.woven.program, SHAPES["train_4k"], {},
                              overrides={**overrides, "remat": policy},
                              extra_aspects=train_kernel_aspects())
        if woven.state.extra.get("remat") != policy:
            raise AssertionError(f"remat {policy}: the weave holds {woven.state.extra}")
        grad_fn = build_grad_fn(woven)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        ((loss, _), grads), counts, routes = counted_run(
            torch, lambda: grad_fn(trainer.params, mb), f"remat {policy}")
        wall = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
        if counts != want:
            raise AssertionError(f"remat {policy}: launch counters {counts} != {want}")
        flat = [g for _, g in _paths(grads)]
        if full is None:
            full = (loss, flat)
        elif not (torch.equal(loss, full[0])
                  and all(torch.equal(a, b) for a, b in zip(flat, full[1]))):
            raise AssertionError(f"remat {policy}: the gradient differs from remat full's")
        out[policy] = {"loss": loss.item(), "bitwise_equal_full": True,
                       "launches": {**counts, **routes}, "grad_s": wall,
                       "peak_gb_over_resident": peak}
        log(f"train-remat {policy}: " + json.dumps(out[policy]))
        del grads, flat
    del full
    return out


# The families' training runs (`train_families_phase`): the model, its depth
# (None: the published one), the global batch x sequence, the microbatches,
# the counted steps (the first pays one-time set-up, so the steady step
# time is the median of the later ones: rwkv6-3b takes two, ~15 s each on
# an H100, and its steady time is step 2's alone), the attention layers and
# weights the model holds, and the gradient gates at one microbatch on the
# weights the steps left (none: no kernel runs, nothing differs):
# - "fp32": the kernel path against the plain attention in fp32 on the same
#   weights (the FMA route), the bf16 kernel-vs-eager reading printed
#   beside; mixtral-8x22b's bf16 paths may route tokens to other experts.
# - "formula": in bf16, the kernel path against the same program with K3
#   stood in for by its plain version on K1's residuals (`plain_backward`).
#   K3 takes delta = rowsum(dO O) from the bf16 output, as the reference's
#   kernel does (`src/repro/kernels/flash_attention/kernel.py:734`), while
#   the plain attention's autograd sums P dP over fp32 probabilities; where
#   the keys share a large common part, dS's rows then miss summing to 0 by
#   O's rounding and dq / dk carry that part.  So the kernel is held to the
#   formula it implements, and the same plain backward with delta from the
#   fp32 output is held to the plain attention (the witness that O's
#   rounding is the whole gap); each bf16 path's distance from the fp32
#   plain gradient is printed (`delta_witness`).
TRAIN_FAMILY_RUNS = {
    "h": dict(arch="recurrentgemma-2b", layers=None, batch=2, seq=4096, accum=2, steps=3,
              attn_layers=8, attn_weights=32, gates=("formula", "fp32")),
    # cut to 4 of 32 layers: at full depth its profiled step alone took
    # 99 s on an H100 (the profiler over ~300 k kernels), the script's
    # largest single cost; at 8 layers its steps took 5.5-5.8 s
    "s": dict(arch="rwkv6-3b", layers=4, batch=4, seq=1024, accum=2, steps=2,
              attn_layers=0, attn_weights=0, gates=()),
    "m": dict(arch="mixtral-8x22b", layers=1, batch=1, seq=6144, accum=1, steps=3,
              attn_layers=1, attn_weights=4, gates=("fp32",)),
    "w": dict(arch="whisper-small", layers=None, batch=8, seq=448, accum=1, steps=3,
              frames=1500, attn_layers=24, attn_weights=12, gates=("formula", "fp32")),
}


def family_stepper(torch, run):
    """The run's model at published width on the card (random weights from
    seed 0, policy `half`, remat `full`, `train_kernel_aspects`) and a
    function that takes one training step: through the launcher's
    `program_trainer` (a published config or one cut in depth), or, for the
    encoder-decoder, through `runtime/steps.build_train_step` with frames
    from a seed beside the token pipeline's batches (the launcher's
    pipeline makes none).  Returns (woven, step(i) -> metrics, params(),
    next_microbatch(), first_loss(), info); `first_loss` is the loss on
    the first global batch at the current weights (the mean over its
    microbatches, as a step reports it), without a gradient."""
    from functools import partial

    import numpy as np

    from repro_torch.configs.base import SHAPES
    from repro_torch.core.program import Program
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.train import program_trainer
    from repro_torch.launch.weave import default_weave, train_kernel_aspects
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.nn.module import init_params
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.steps import (
        build_loss_fn,
        build_train_step,
        model_flops_per_token,
    )
    from repro_torch.runtime.trainer import TrainerConfig

    published = get_config(run["arch"])
    cfg = (published if run["layers"] is None
           else published.replace(num_layers=run["layers"], layer_groups=()))
    overrides = {"accum_steps": run["accum"], "remat": "full", "precision": "half"}
    lr = partial(constant, peak=3e-4)
    B, S, mbs = run["batch"], run["seq"], run["batch"] // run["accum"]
    program = Program(model=build_model(cfg), cfg=cfg, kind="train",
                      device=torch.device("cuda"))

    def first_loss_of(woven, params, batch):
        loss_fn = build_loss_fn(woven)
        with torch.no_grad():
            return float(np.mean([
                loss_fn(params(), {k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()})[0]
                .item() for i in range(run["accum"])]))

    if cfg.family != "encdec":
        trainer = program_trainer(program, batch=B, seq=S, overrides=overrides,
                                  tcfg=TrainerConfig(steps=99, log_every=0, seed=0),
                                  lr_fn=lr)
        trainer.init_state()

        def on_card(i):
            return {k: torch.as_tensor(v).to("cuda")
                    for k, v in trainer.pipeline.batch_at(i).items()}

        def step(i):
            h = trainer.run(1)[-1]
            return {"loss": h["loss"], "grad_norm": h["grad_norm"]}

        def next_mb():
            return {k: v[:mbs] for k, v in on_card(trainer.pipeline.step).items()}

        def params():
            return trainer.params

        info = {"flops_per_step": trainer.info["flops_per_step"], "tokens_per_step": B * S}
        return (trainer.woven, step, params, next_mb,
                lambda: first_loss_of(trainer.woven, params, on_card(0)), info)

    woven = default_weave(program, SHAPES["train_4k"], {}, overrides=dict(overrides),
                          extra_aspects=train_kernel_aspects())
    state = {"params": init_params(program.model, 0, woven.state.policies, "cuda")}
    state["opt"] = adamw.init_state(state["params"], adamw.AdamWConfig())
    train_step = build_train_step(woven, lr_fn=lr)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=S, global_batch=B))
    T = run["frames"]

    def batch_at(i):
        batch = {k: torch.as_tensor(v).to("cuda") for k, v in pipe.batch_at(i).items()}
        frames = np.random.default_rng([24, i]).standard_normal((B, T, cfg.d_model),
                                                                dtype=np.float32)
        batch["frames"] = torch.as_tensor(frames, device="cuda").to(torch.bfloat16)
        return batch

    counter = [0]

    def step(i):
        state["params"], state["opt"], m = train_step(state["params"], state["opt"],
                                                      batch_at(counter[0]), counter[0])
        counter[0] += 1
        return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}

    def next_mb():
        return {k: v[:mbs] for k, v in batch_at(counter[0]).items()}

    def params():
        return state["params"]

    # 6 x (encoder parameters x frames + the rest x tokens) a sample
    enc = sum(p.numel() for path, p in _paths(state["params"])
              if path.split("/")[0] in ("encoder", "enc_norm"))
    rest = sum(p.numel() for _, p in _paths(state["params"])) - enc
    flops = 6.0 * B * (enc * T + rest * S)
    info = {"flops_per_step": flops, "tokens_per_step": B * S, "frames_per_step": B * T,
            "flops_note": f"6 x ({enc} encoder parameters x {T} frames + {rest} others x "
                          f"{S} tokens) x {B}; cfg 6 N: {model_flops_per_token(cfg)}"}
    return (woven, step, params, next_mb,
            lambda: first_loss_of(woven, params, batch_at(0)), info)


def delta_witness(tag, bf16: dict, fp32_eager) -> dict:
    """How far each bf16 path's attention gradients (`bf16`: name ->
    `gradient_digest`) lie from the fp32 plain path's on the same weights
    and microbatch, and from the bf16 plain attention's (`eager`): the worst
    layer a weight, and its worst weight.  With the kernels, `formula` (K3's
    delta from the bf16 output) and `formula_consistent_delta` (delta from
    the fp32 output) side by side, it shows whether the rounding of O in
    delta explains the kernel path's distance from the plain attention."""
    out = {}
    for name, (_, _, attn) in bf16.items():
        by_weight = rel_l2_by_layer(attn, fp32_eager[2])
        out[name] = {"vs_fp32_eager_worst": max(by_weight.values()),
                     "vs_fp32_eager_by_weight": by_weight}
        if name != "eager":
            out[name]["vs_bf16_eager_worst"] = max(
                rel_l2_by_layer(attn, bf16["eager"][2]).values())
    log(f"train-{tag}-delta-witness " + json.dumps(out))
    return out


def train_family_run(torch, tag, run) -> dict:
    """One run of `train_families_phase`: `run["steps"]` counted steps with
    exact launches (K1 with lse twice an attention layer and microbatch —
    the forward and the remat recompute — and K3 once; every bf16 launch on
    the tensor-core route, `counted_run`; nothing else), finite losses, one
    profiled step, the first batch's loss after the steps below the first
    step's, and the run's gradient gates at one microbatch
    (`TRAIN_FAMILY_RUNS`), or, with no attention, every parameter leaf
    changed."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.weave import default_weave, train_kernel_aspects
    from repro_torch.nn.dtypes import PolicyResolver
    from repro_torch.optim.tree import tree_map

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    woven, step, params, next_mb, first_loss, info = family_stepper(torch, run)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    cfg = woven.program.cfg
    n_params = sum(p.numel() for _, p in _paths(params()))
    kernels_woven = [i for i in woven.state.impls if i[2] == "cuda"]
    log(f"train-families ({tag}): {run['arch']} at full width ({cfg.num_layers} layers"
        f"{f' + {cfg.enc_layers} encoder layers' if cfg.enc_layers else ''}, d_model "
        f"{cfg.d_model}, {cfg.n_heads} q / {cfg.kv_heads} KV heads of "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab}): {n_params / 1e9:.3f} B parameters "
        f"and AdamW state on the card in {time.perf_counter() - t0:.1f} s; kernels woven "
        f"{kernels_woven}, remat {woven.state.extra.get('remat')}, accum "
        f"{woven.state.extra.get('accum_steps')}, global batch {run['batch']} x {run['seq']}")
    if kernels_woven != [("*", "attention", "cuda")]:
        raise AssertionError(f"training must weave the attention kernels alone: {kernels_woven}")
    k1 = 2 * run["accum"] * run["attn_layers"]
    want = {"flash_attention": k1, "flash_attention_lse": k1,
            "flash_attention_bwd": run["accum"] * run["attn_layers"], "flash_decode": 0,
            "rmsnorm": 0, "rglru": 0, "wkv": 0}
    before = (torch.stack([torch.linalg.vector_norm(p.detach(), dtype=torch.float64)
                           for _, p in _paths(params())]) if not run["attn_layers"] else None)
    step_s, metrics, totals = [], [], {}
    for i in range(run["steps"]):
        t = time.perf_counter()
        m, counts, routes = counted_run(torch, lambda: step(i), f"train ({tag}) step {i + 1}")
        step_s.append(time.perf_counter() - t)
        metrics.append(m)
        log(f"train-families ({tag}): step {i + 1}: loss {m['loss']:.6f}, grad norm "
            f"{m['grad_norm']:.4f}, {step_s[-1] * 1e3:.1f} ms, launches {counts}")
        if counts != want:
            raise AssertionError(f"train ({tag}) step {i + 1}: launch counters {counts} != "
                                 f"expected {want}")
        for key, n in {**counts, **routes}.items():
            totals[key] = totals.get(key, 0) + n
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in metrics]
    if not all(np.isfinite(losses + [m["grad_norm"] for m in metrics])):
        raise AssertionError(f"train ({tag}): non-finite loss or gradient norm: {metrics}")
    steady = step_s[1:]  # the first step pays one-time set-up
    step_median = float(np.median(steady))
    t = time.perf_counter()
    # the device's activity alone: rwkv6-3b's step dispatches ~300 k kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(run["steps"])
        torch.cuda.synchronize()
    rows = sorted(((_device_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    profile_out = {
        "device_busy_ms_per_step": busy_ms if busy_ms > 0 else None,
        "device_idle_share": 1.0 - busy_ms / (step_median * 1e3) if busy_ms > 0 else None,
        "device_launches_per_step": sum(r[1] for r in rows),
        "top_kernels_ms_per_step": [{"kernel": key[:80], "ms": us / 1e3, "calls": count}
                                    for us, count, key in rows[:8]],
    }
    del prof, rows
    seconds = {"set_up": t_setup, "steps": sum(step_s), "profiled_step": time.perf_counter() - t}
    # the weights after every step (the profiled one too) on the first batch
    first_after = first_loss()
    if not first_after < losses[0]:
        raise AssertionError(f"train ({tag}): the first batch's loss did not fall: "
                             f"{losses[0]} at step 1, {first_after} after "
                             f"{run['steps'] + 1} steps")
    changed = None
    if before is not None:
        after = torch.stack([torch.linalg.vector_norm(p.detach(), dtype=torch.float64)
                             for _, p in _paths(params())])
        changed = int((after != before).sum().item())
        if changed != len(before):
            raise AssertionError(f"train ({tag}): {len(before) - changed} of {len(before)} "
                                 "parameter leaves did not change")
    summary = {
        "model": run["arch"], "layers": cfg.num_layers, "params_b": n_params / 1e9,
        "global_batch": run["batch"], "seq": run["seq"], "accum_steps": run["accum"],
        "steps": run["steps"], "losses": losses,
        "first_batch_loss_after_steps": first_after,
        "grad_norms": [m["grad_norm"] for m in metrics], "step_s": step_s,
        # the median of steps 2.. (one step's time where there are two steps)
        "steady_step_s": step_median, "steady_steps": list(range(2, run["steps"] + 1)),
        "tokens_per_s": info["tokens_per_step"] / step_median,
        "mfu": info["flops_per_step"] / step_median / PEAK_FLOPS["bf16"],
        "model_flops_per_step": info["flops_per_step"], "peak_memory_gb": peak_gb,
        "launches_per_step": want, "launches": totals, "profile": profile_out,
        "parameter_leaves_changed": changed, "seconds": seconds,
    }
    if "frames_per_step" in info:
        summary["frames_per_s"] = info["frames_per_step"] / step_median
        summary["model_flops_note"] = info["flops_note"]
    overrides = {"accum_steps": run["accum"], "remat": "full", "precision": "half"}
    if run["gates"]:
        t = time.perf_counter()
        mb, n_attn, stacks = next_mb(), run["attn_weights"], stack_names(woven)
        bf16 = {"kernels": gradient_digest(torch, woven, params(), mb, stacks),
                "eager": gradient_digest(torch, eager_weave(woven, overrides), params(), mb,
                                         stacks)}
        summary["vs_eager"] = compare_gradients(f"train-{tag}-vs-eager", bf16["kernels"],
                                                bf16["eager"], n_attn, gated=False)
        if "formula" in run["gates"]:
            for name, consistent in (("formula", False), ("formula_consistent_delta", True)):
                with plain_backward(torch, consistent):
                    bf16[name] = gradient_digest(torch, woven, params(), mb, stacks)
            summary["vs_plain_formula"] = compare_gradients(
                f"train-{tag}-vs-plain-formula", bf16["kernels"], bf16["formula"], n_attn,
                labels=("kernels", "formula"))
            # the witness's gate: with delta consistent with P, K3's formula
            # meets the kernel-vs-eager gate the bf16 output's rounding fails
            summary["consistent_delta_vs_eager"] = compare_gradients(
                f"train-{tag}-consistent-delta-vs-eager", bf16["formula_consistent_delta"],
                bf16["eager"], n_attn, labels=("consistent_delta", "eager"))
        # the same microbatch on the same weights widened to fp32 (the FMA
        # route), once the optimizer state is dropped
        weights = tree_map(lambda p: p.detach().float(), params())
        del step, params, next_mb, first_loss, info
        gc.collect()
        torch.cuda.empty_cache()
        woven32 = default_weave(woven.program, SHAPES["train_4k"], {},
                                overrides=dict(overrides), extra_aspects=train_kernel_aspects())
        woven32.state.policies = PolicyResolver.default("f32")
        route_counts(reset=True)
        fp32_k = gradient_digest(torch, woven32, weights, mb, stacks)
        fp32_routes = route_counts()
        fp32_e = gradient_digest(torch, eager_weave(woven32, overrides), weights, mb, stacks)
        summary["vs_eager_fp32"] = compare_gradients(f"train-{tag}-f32-vs-eager", fp32_k,
                                                     fp32_e, n_attn)
        summary["vs_eager_fp32"]["routes"] = fp32_routes
        # one microbatch: K1 twice an attention layer, K3 once, all fp32
        if (fp32_routes["flash_attention_fma"] != 2 * run["attn_layers"]
                or fp32_routes["flash_attention_bwd_fma"] != run["attn_layers"]):
            raise AssertionError(f"train ({tag}): the fp32 gate left the FMA route: "
                                 f"{fp32_routes}")
        summary["delta_witness"] = delta_witness(tag, bf16, fp32_e)
        del weights, bf16, fp32_k, fp32_e
        seconds["gradient_gates"] = time.perf_counter() - t
    log(f"train-families ({tag}) " + json.dumps(summary))
    return summary


def train_families_phase(torch) -> dict:
    """Training the hybrid, ssm, MoE and encoder-decoder families on the card
    at published width (`TRAIN_FAMILY_RUNS`): (h) recurrentgemma-2b, 26
    layers (per-block remat; K1 with lse and K3 at H10 K1 D256, window 2048
    at S 4096, which prunes), B2 x 4096 in 2 microbatches; (s) rwkv6-3b cut
    to 4 of 32 layers, B4 x 1024 in 2 — no hand-written kernel on its training path
    (every counter 0): its parameters change, its losses are finite and
    its first batch's loss falls; (m) mixtral-8x22b cut to one layer (2.90 B parameters with the
    embeddings, the depth one card trains), B1 x 6144 (K1 / K3 at G 6, window
    4096, which prunes); (w) whisper-small, 12 + 12 layers, B8 x (1500
    frames from a seed, 448 tokens) through `build_train_step` (K1
    non-causal over a ragged 1500 at G 1 in the encoder, causal in the
    decoder; the cross-attention plain on both paths).  The gradient gates
    of (h), (m) and (w) run in fp32 on the same weights (the FMA route);
    those of (h) and (w) also in bf16, against K1's and K3's plain
    formula, with the witness of what delta's rounding explains beside
    (`TRAIN_FAMILY_RUNS` says why).  Each: `train_family_run`.  Peak
    memory is read from the start of each run."""
    out, t0 = {}, time.perf_counter()
    for tag, run in TRAIN_FAMILY_RUNS.items():
        out[tag] = train_family_run(torch, tag, run)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"train-families: the phase in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: the four examples on the card
# ---------------------------------------------------------------------------

# train_100m's documented full run (`examples_torch/train_100m.py`'s docstring)
EXAMPLE_100M_RUN = {"steps": 300, "batch": 16, "seq": 256}
# a docking score against the same score in float64 numpy, relative
DOCKING_REL_TOL = 1e-4


def example(name: str):
    """`examples_torch/<name>.py`, loaded by path (the folder is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(HERE, "examples_torch", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example_trainer_run(torch, tag, trainer) -> dict:
    """An example's trainer through its own `run()` as one counted run: one
    microbatch and remat `none`, so K1 with lse once an attention layer and
    step and K3 once, nothing else (every bf16 launch on the tensor-core
    route, `counted_run`); finite losses, the last below the first.  Step
    time is the median of the trainer's own synchronised sensor (steps 2
    on); MFU = 6·N·tokens / step / 989 TFLOP/s; peak memory over the run."""
    import numpy as np

    woven, steps = trainer.woven, trainer.cfg.steps
    cfg = woven.program.cfg
    kernels_woven = [i for i in woven.state.impls if i[2] == "cuda"]
    if kernels_woven != [("*", "attention", "cuda")]:
        raise AssertionError(f"examples {tag}: training must weave the attention kernels "
                             f"alone: {kernels_woven}")
    if (woven.state.extra.get("remat"), woven.state.extra.get("accum_steps")) != ("none", 1):
        raise AssertionError(f"examples {tag}: remat / accum {woven.state.extra}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    history, counts, routes = counted_run(torch, trainer.run, f"examples {tag}")
    wall = time.perf_counter() - t0
    n = steps * cfg.num_layers
    want = {"flash_attention": n, "flash_attention_lse": n, "flash_attention_bwd": n,
            "flash_decode": 0, "rmsnorm": 0, "rglru": 0, "wkv": 0}
    log(f"examples ({tag}): {steps} steps, launches {counts}, expected {want}; "
        f"routes {routes}")
    if counts != want:
        raise AssertionError(f"examples {tag}: launch counters {counts} != expected {want}")
    losses = [h["loss"] for h in history]
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"examples {tag}: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"examples {tag}: the loss did not fall: {losses}")
    step_s = float(np.median([h["step_time"] for h in history[1:]]))
    flops = trainer.info["flops_per_step"]
    return {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params_m": sum(p.numel() for p in woven.program.model.parameters()) / 1e6,
        "global_batch": trainer.pipeline.cfg.global_batch,
        "seq": trainer.pipeline.cfg.seq_len, "steps": steps,
        "loss_first": losses[0], "loss_last": losses[-1], "run_wall_s": wall,
        "step_s_median": step_s,
        "tokens_per_s": trainer.info["tokens_per_step"] / step_s,
        "mfu": flops / step_s / PEAK_FLOPS["bf16"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": {**counts, **routes},
    }


def example_trainer_profile(torch, trainer, summary: dict) -> None:
    """Five more steps timed on the host's clock, then under the profiler
    (`profile_steps`): the device's busy time a step and MFU over it."""

    def run(n):
        trainer.run(n)
        torch.cuda.synchronize()

    prof = profile_steps(torch, run, 5, "step_wall_ms")
    busy = prof["device_busy_ms_per_step"]
    summary["profile"] = prof
    summary["mfu_busy"] = (trainer.info["flops_per_step"] / (busy / 1e3) / PEAK_FLOPS["bf16"]
                           if busy else None)


def example_quickstart(torch) -> dict:
    """`examples_torch/quickstart.py` as it runs: reduced yi-6b woven with
    `half`, remat `none`, accum 1, ExaMon and the training kernels, 30 steps
    of 8 x 32 tokens."""
    mod = example("quickstart")
    woven = mod.build("cuda")
    log("examples (quickstart): weave report\n" + woven.report.table())
    trainer = mod.build_trainer(woven)
    summary = example_trainer_run(torch, "quickstart", trainer)
    example_trainer_profile(torch, trainer, summary)
    return summary


def example_train_100m(torch) -> dict:
    """`examples_torch/train_100m.py` at its documented full run
    (`EXAMPLE_100M_RUN`): `CFG_100M` at full width and depth, checkpoints
    every 100 steps into a temporary directory.  Gates besides
    `example_trainer_run`'s: checkpoints at steps 100, 200 and 300 on disk,
    and the newest restored into a fresh trainer bit for bit (parameters,
    optimizer state, the pipeline's step)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.optim.tree import leaves

    mod = example("train_100m")
    run = EXAMPLE_100M_RUN
    with tempfile.TemporaryDirectory(prefix="antarex_100m_torch_") as ckpt:
        def build():
            return mod.build_trainer(mod.CFG_100M, "cuda", ckpt_dir=ckpt, **run)

        trainer = build()
        cfg = trainer.woven.program.cfg
        if (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim,
                cfg.d_ff, cfg.vocab, cfg.tie_embeddings) != (12, 768, 12, 4, 64, 2048, 32768,
                                                             True):
            raise AssertionError(f"not the example's CFG_100M: {cfg}")
        summary = example_trainer_run(torch, "train_100m", trainer)
        saved = Checkpointer(ckpt).all_steps()
        want = list(range(100, run["steps"] + 1, 100))
        t0 = time.perf_counter()
        fresh = build()
        restored = fresh.maybe_restore()
        restore_s = time.perf_counter() - t0
        pairs = (list(zip(leaves(fresh.params), leaves(trainer.params)))
                 + list(zip(leaves(fresh.opt_state), leaves(trainer.opt_state))))
        same = restored and len(pairs) == (len(leaves(trainer.params))
                                           + len(leaves(trainer.opt_state))) and all(
            a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
            for a, b in pairs)
        summary["checkpoint"] = {
            "steps_on_disk": saved, "restored_step": fresh.step,
            "pipeline_step": fresh.pipeline.step, "leaves": len(pairs),
            "restore_s": restore_s, "bit_for_bit": same}
        log("examples (train_100m): checkpoint " + json.dumps(summary["checkpoint"]))
        if saved != want:
            raise AssertionError(f"examples train_100m: checkpoints at {saved}, not {want}")
        if not (same and fresh.step == trainer.step == run["steps"]
                and fresh.pipeline.step == trainer.pipeline.step):
            raise AssertionError("examples train_100m: the newest checkpoint did not restore "
                                 "bit for bit into a fresh trainer")
        del fresh, pairs
        example_trainer_profile(torch, trainer, summary)
    return summary


def example_navigation(torch) -> dict:
    """`examples_torch/navigation_serve.py` as it runs: reduced gemma-2b woven
    with `MemoizeStep` and the serving kernels, 12 serves over 6 routes at
    the decode budget mARGOt picks.  The first serve on the card pays one-time
    set-up (cuBLAS handles, the allocator) that mARGOt would read as load,
    so one serve on a server of its own (its own memo table) warms the card
    first.  One counted run: K1 once a layer for each serve the memo did not
    answer, K2 once a layer and decode step (split route), K4 2L + 1 times a
    forward; the memo answers every repeated (route, budget), 6 of the 12;
    `served` counts the 6 it did not (a hit returns before it is recorded)."""
    import numpy as np

    mod = example("navigation_serve")
    mod.build_server("cuda").serve(np.zeros((1, 12), np.int32), decode_tokens=6)
    margot = mod.make_margot()
    server = mod.build_server("cuda", margot)
    cfg = server.woven.program.cfg
    routes = mod.make_routes(cfg.vocab)
    t0 = time.perf_counter()
    served, counts, rc = counted_run(torch, lambda: mod.navigate(server, margot, routes),
                                     "examples navigation")
    wall = time.perf_counter() - t0
    seen, misses = set(), []
    for i, (n, toks) in enumerate(served):
        if toks.shape != (1, n) or toks.min() < 0 or toks.max() >= cfg.vocab:
            raise AssertionError(f"examples navigation: serve {i} gave {toks}")
        if (i % len(routes), n) not in seen:
            seen.add((i % len(routes), n))
            misses.append(n)
    layers = cfg.num_layers
    want = {"flash_attention": layers * len(misses), "flash_attention_lse": 0,
            "flash_attention_bwd": 0, "flash_decode": layers * sum(misses),
            "rmsnorm": (2 * layers + 1) * sum(1 + n for n in misses), "rglru": 0, "wkv": 0}
    memo = server.memo
    summary = {
        "model": cfg.name, "layers": layers, "serves": len(served),
        "decode_tokens": [n for n, _ in served], "memo_hits": memo.hits,
        "memo_misses": memo.misses, "memo_hit_rate": memo.hit_rate,
        "served": server.served, "knob": margot.current.knobs,
        "serve_latencies_ms": [s * 1e3 for s in server.latencies],
        "serve_latency_ms_median": float(np.median(server.latencies)) * 1e3,
        "run_wall_s": wall, "launches": {**counts, **rc}}
    log(f"examples (navigation): launches {counts}, expected {want}; routes {rc}")
    if counts != want:
        raise AssertionError(f"examples navigation: launch counters {counts} != {want}")
    if not (len(served) == 12 and memo.hits == 6 and memo.misses == len(misses) == 6
            and server.served == 6):
        raise AssertionError(f"examples navigation: memo hits {memo.hits} / misses "
                             f"{memo.misses}, served {server.served}, budgets "
                             f"{summary['decode_tokens']}")
    return summary


def example_docking(torch) -> dict:
    """`examples_torch/drug_discovery.py` as it runs on the card: the LAT
    exploration over 5 chunkings x 3 tests (times by `torch.cuda.synchronize`
    and the host clock, over chunks: the example's ideal-parallel model),
    mARGOt on the knowledge base with a budget of twice the best time, 64
    ligands docked.  Gates: 15 measurements, every docking score within
    `DOCKING_REL_TOL` of float64 numpy, and the point mARGOt settles on meets
    the budget in the knowledge base (the observed time a ligand, which runs
    the chunks one after another on one card, is printed beside)."""
    import numpy as np

    mod = example("drug_discovery")
    ligands, pocket = mod.make_inputs(torch.device("cuda"))
    measured = []

    def time_of(chunks):
        measured.append(chunks)
        return mod.time_for(ligands[0], pocket, chunks)

    t0 = time.perf_counter()
    lat = mod.explore(time_of)
    margot, budget_s = mod.plan(lat)
    t1 = time.perf_counter()
    docked = mod.dock(ligands, pocket, margot)
    dock_s = time.perf_counter() - t1
    table = [{"chunks": r["knobs"]["chunks"], "time_ms": r["metrics"]["time"][0] * 1e3,
              "std_ms": r["metrics"]["time"][1] * 1e3} for r in lat.results]
    lig, poc = ligands.double().cpu().numpy(), pocket.double().cpu().numpy()
    worst = 0.0
    for ligand, (_, score) in zip(lig, docked):
        want = np.sqrt(((ligand[:, None] - poc[None]) ** 2).sum(-1).min(1)).sum()
        worst = max(worst, abs(float(score) - want) / abs(want))
    settled = margot.current.knobs["chunks"]
    settled_ms = next(r["time_ms"] for r in table if r["chunks"] == settled)
    summary = {"dse": table, "measurements": len(measured), "budget_ms": budget_s * 1e3,
               "chunks_chosen": [c for c, _ in docked], "settled_chunks": settled,
               "settled_time_ms": settled_ms, "observed_ms_per_ligand": dock_s / 64 * 1e3,
               "score_max_rel_err_vs_float64": worst, "dse_and_plan_s": t1 - t0}
    if sorted(measured) != sorted(mod.CHUNKS * 3) or len(table) != len(mod.CHUNKS):
        raise AssertionError(f"examples docking: the DSE measured {measured}")
    if len(docked) != 64 or not worst <= DOCKING_REL_TOL:
        raise AssertionError(f"examples docking: {len(docked)} ligands, worst score error "
                             f"{worst}")
    if not settled_ms <= budget_s * 1e3:
        raise AssertionError(f"examples docking: chunks={settled} ({settled_ms} ms) over the "
                             f"budget {budget_s * 1e3} ms")
    return summary


def examples_phase(torch) -> dict:
    """The four examples of `examples_torch/` on the card through their own
    functions, at the reference's sizes (train_100m at its documented full
    run); one `examples` line each."""
    out, t0 = {}, time.perf_counter()
    for tag, fn in (("quickstart", example_quickstart), ("train_100m", example_train_100m),
                    ("navigation", example_navigation), ("drug_discovery", example_docking)):
        t = time.perf_counter()
        out[tag] = fn(torch)
        out[tag]["phase_s"] = time.perf_counter() - t
        log(f"examples {tag} " + json.dumps(out[tag]))
        gc.collect()
        torch.cuda.empty_cache()
    log(f"examples: the phase in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the roofline against measured steps
# ---------------------------------------------------------------------------

# a step can not beat its own bound: roofline_share = step_s / busy time
ROOFLINE_SHARE_MAX = 1.05


def busy_ms(torch, run, steps: int, tag: str) -> dict:
    """Device-busy time of one step: the profiler's sum of kernel time over
    `steps` steps (`profile_steps`). A profile with no device time fails
    the cell: a wall time would hold the gaps between kernels too."""
    out = profile_steps(torch, run, steps, f"{tag}_wall_ms")
    if out["device_busy_ms_per_step"] is None:
        raise AssertionError(f"roofline {tag}: the profile recorded no device time")
    return out


def roofline_cell(tag, arch, shape, busy, overrides=None) -> dict:
    """The composed roofline (`roofline/components.compose_cell`, on the
    meta device, on the card mesh) of one step the card ran, beside that
    step's measured device-busy time: MFU = model_flops / (989 TFLOP/s x
    busy) and roofline_share = step_s / busy, gated at ROOFLINE_SHARE_MAX."""
    from repro_torch.launch.mesh import make_card_mesh
    from repro_torch.roofline.components import compose_cell

    t0 = time.perf_counter()
    r = compose_cell(arch, shape, mesh=make_card_mesh(), overrides=overrides,
                     verbose=False)
    busy_s = busy["device_busy_ms_per_step"] / 1e3
    out = {"cell": tag, "arch": arch, "batch": shape.global_batch, "seq": shape.seq_len,
           "kind": shape.kind, "compute_s": r["compute_s"], "memory_s": r["memory_s"],
           "step_s": r["step_s"], "bottleneck": r["bottleneck"],
           "model_flops": r["model_flops"], "flops": r["flops_per_device"],
           "bytes": r["bytes_per_device"], "busy_ms": busy["device_busy_ms_per_step"],
           "mfu": r["model_flops"] / (PEAK_FLOPS["bf16"] * busy_s),
           "roofline_share": r["step_s"] / busy_s,
           "components": [[c["name"], c["count"], c["flops"], c["bytes"]]
                          for c in r["components"]],
           "top_kernels_ms_per_step": busy.get("top_kernels_ms_per_step"),
           "compose_host_s": time.perf_counter() - t0}
    log("roofline " + json.dumps(out))
    if not out["roofline_share"] <= ROOFLINE_SHARE_MAX:
        raise AssertionError(f"roofline {tag}: the step ran in {out['busy_ms']} ms, under "
                             f"its own bound {r['step_s'] * 1e3} ms (share "
                             f"{out['roofline_share']})")
    return out


def roofline_serve_cells(torch, server, requests, serve_counts, k1_main) -> dict:
    """The serving half of the roofline phase, on the serve phase's yi-6b
    server: (r1) a decode step at B8 against 4096-slot caches filled to
    4064 tokens (K2's split route and K4), (r2) a B1 x 2048 prefill (K1 and
    K4) — each a counted run with exact launches, its busy time measured —
    and the same dense requests the serve phase made, again, through a
    `Server` on the card mesh over the same weights: tokens bit for bit,
    launches by route the same."""
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_card_mesh
    from repro_torch.runtime.server import Server

    t0 = time.perf_counter()
    mcfg = server.woven.program.cfg
    L, T = mcfg.num_layers, server.cfg.max_cache_len
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    cells = {}

    # (r1): 8 requests, one token each, against caches of T slots filled
    # to T - 32 (every step reads nearly the whole cache, as the bound does)
    B, steps = 8, 6
    toks = torch.randint(0, mcfg.vocab, (B, T - 32), generator=gen, device="cuda",
                         dtype=torch.int32)
    state = {}

    def decode(k):
        for _ in range(k):
            positions = torch.full((B, 1), state["pos"], dtype=torch.int32, device="cuda")
            _, state["cache"] = server.decode_vc(
                None, server.params, {"tokens": state["tok"], "positions": positions},
                state["cache"])
            state["pos"] += 1
        torch.cuda.synchronize()

    def r1():
        logits, state["cache"] = server.prefill_vc(None, server.params, {"tokens": toks})
        if state["cache"]["blocks0"]["k"].shape[2] != T:
            raise AssertionError("roofline r1: the prefill cache is not T slots long")
        state["tok"] = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        state["pos"] = toks.shape[1]
        return busy_ms(torch, decode, steps, "decode_B8_T4096")

    prof, counts, _ = counted_run(torch, r1, "roofline r1")
    state.clear()
    # profile_steps' warm-up, timed and profiled steps
    n = 2 + 2 * steps
    want = {"flash_attention": L, "flash_decode": L * n, "rmsnorm": (2 * L + 1) * (n + 1)}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"roofline r1: launches {counts} != {want}")
    cells["r1"] = roofline_cell("r1_yi6b_decode_B8_T4096", "yi-6b",
                                ShapeConfig("r1_decode_B8_T4096", T, B, "decode"), prof)

    # (r2): one prompt of 2048 tokens
    prompt = torch.randint(0, mcfg.vocab, (1, 2048), generator=gen, device="cuda",
                           dtype=torch.int32)

    def prefill(k):
        for _ in range(k):
            server.prefill_vc(None, server.params, {"tokens": prompt})
        torch.cuda.synchronize()

    steps = 4
    prof, counts, _ = counted_run(torch, lambda: busy_ms(torch, prefill, steps,
                                                         "prefill_B1_S2048"), "roofline r2")
    n = 2 + 2 * steps
    want = {"flash_attention": L * n, "flash_decode": 0, "rmsnorm": (2 * L + 1) * n}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"roofline r2: launches {counts} != {want}")
    cells["r2"] = roofline_cell("r2_yi6b_prefill_B1_S2048", "yi-6b",
                                ShapeConfig("r2_prefill_B1_S2048", 2048, 1, "prefill"), prof)
    core = next(c for c in cells["r2"]["components"] if c[0] == "attn_core")
    core_ms = core[2] / PEAK_FLOPS["bf16"] * 1e3
    cells["r2"]["attn_core_ms"] = core_ms
    cells["r2"]["k1_bound_ms"] = k1_main["bound_ms"]
    log(f"roofline: r2's attention core over the peak {core_ms} ms, K1's bound_ms "
        f"{k1_main['bound_ms']} ms ({k1_main['case']})")
    if k1_main["case"] != "yi6b_S2048_H32_K4_D128_bf16" or \
            abs(core_ms - k1_main["bound_ms"]) > 1e-12 * core_ms:
        raise AssertionError("roofline: r2's attention core is not K1's bound")

    # the serve phase's dense requests through a server on the card mesh
    meshed = Server(server.woven, server.cfg, mesh=make_card_mesh(), params=server.params)

    def serve_again():
        solo = [meshed.serve(p) for p in requests["solo"]]
        return solo, meshed.serve_batch(requests["batch"])

    (solo, batch), counts, routes = counted_run(torch, serve_again, "mesh-of-one serve")
    same_tokens = all(np.array_equal(a, b) for a, b in zip(solo, requests["solo_out"])) \
        and all(np.array_equal(a, b) for a, b in zip(batch, requests["batch_out"]))
    got = {**counts, **routes}
    same_launches = all(got[k] == v for k, v in serve_counts.items()) and all(
        v == 0 for k, v in got.items() if k not in serve_counts)
    del meshed
    mesh_of_one = {"tokens_bit_for_bit": same_tokens, "launches": got,
                   "launches_as_mesh_none": same_launches}
    log("roofline-mesh-of-one " + json.dumps(mesh_of_one))
    if not same_tokens:
        raise AssertionError("the card-mesh server's tokens differ from mesh=None's")
    if not same_launches:
        raise AssertionError(f"the card-mesh server's launches {got} differ from "
                             f"mesh=None's {serve_counts}")
    return {"cells": cells, "mesh_of_one": mesh_of_one, "seconds": time.perf_counter() - t0}


def roofline_phase(torch, serve_cells: dict, train: dict) -> dict:
    """The roofline phase's training cell and its report: (r3) the
    training step `train_phase` ran (gemma-2b, 4 x 1024 in 2 microbatches,
    remat `full`: K1-lse, K3), its profiled busy time against the composed
    roofline; one dry-run record (`launch/dryrun.lower_cell`, yi-6b
    decode_32k on the card mesh, on the meta device: its 275 GB cache does
    not fit 80 GB); the card's own memory beside the roofline's 80 GB."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    busy = train["profile"]
    if busy["device_busy_ms_per_step"] is None:
        raise AssertionError("roofline r3: the training profile recorded no device time")
    r3 = roofline_cell("r3_gemma2b_train_B4_S1024_accum2", "gemma-2b",
                       ShapeConfig("r3_train_B4_S1024", 1024, 4, "train"), busy,
                       overrides={"accum_steps": 2, "remat": "full", "precision": "half"})
    with tempfile.TemporaryDirectory() as out:
        saved, dryrun.ARTIFACT_DIR = dryrun.ARTIFACT_DIR, out
        try:
            rec = dryrun.lower_cell("yi-6b", "decode_32k", mesh="card", verbose=False)
        finally:
            dryrun.ARTIFACT_DIR = saved
    line = {k: rec[k] for k in ("arch", "shape", "mesh", "hbm_fits", "hbm_capacity",
                                "analytic_hbm_per_device", "step_s", "bottleneck")}
    line["argument_bytes"] = rec["memory_per_device"]["argument"]
    line["card_total_memory"] = torch.cuda.get_device_properties(0).total_memory
    log("roofline-dryrun " + json.dumps(line))
    if rec["hbm_fits"] is not False:
        raise AssertionError("dry run: yi-6b decode_32k's cache cannot fit one card")
    summary = {"cells": {**serve_cells["cells"], "r3": r3},
               "mesh_of_one": serve_cells["mesh_of_one"], "dryrun": line,
               "seconds": serve_cells["seconds"] + time.perf_counter() - t0}
    log("roofline-phase " + json.dumps({
        "shares": {k: c["roofline_share"] for k, c in summary["cells"].items()},
        "mfu": {k: c["mfu"] for k, c in summary["cells"].items()},
        "seconds": summary["seconds"]}))
    return summary


# ---------------------------------------------------------------------------
# phase 12: a live mesh of two ranks on the one card
# ---------------------------------------------------------------------------

# gemma-2b layers of a full-width copy per rank (the (2, 1) mesh holds two)
# with AdamW state and a 2 x 512 microbatch per rank: 4 fit, 2 keep the
# phase's time (the gradient's all-reduce through the host is most of a
# (2, 1) step) for the serving runs under fsdp_sp
MESH_TRAIN_DEPTH = 2
MESH_TRAIN = {"batch": 4, "seq": 512, "steps": 2, "lr": 1e-3}
MESH_TRAIN_SHAPES = {"data2": (2, 1), "model2": (1, 2)}
MESH_CONTINUOUS = 2  # prompts of the continuous traffic served on the mesh
# the meshed yi-6b server's layers (of 32), reused by (q1), (d2) and (d4):
# its ranks' serve took 101.4-168.2 s at full depth, 83.3 s at 8 layers and
# 45.5 s at 4 on an H100 over gloo, the time the families' fsdp_sp runs
# (p1)-(p3) and serving runs (s1)-(s4) need; its launch gates are step 5's
# one-card counts scaled to the depth (`depth_counts`)
MESH_SERVE_DEPTH = 2


def yi_server(torch, mesh, depth, cfg):
    """Full-width yi-6b's server as `launch/serve.build_server` builds it, cut
    to `depth` layers (None: all 32), on `mesh` (None: one card)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.program import Program
    from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.runtime.server import Server

    mcfg = get_config("yi-6b")
    if depth is not None:
        mcfg = mcfg.replace(num_layers=depth, layer_groups=())
    program = Program(model=build_model(mcfg), cfg=mcfg, kind="serve", device="cuda")
    woven = default_weave(program, SHAPES["prefill_32k"],
                          dict(mesh.shape) if mesh is not None else {},
                          extra_aspects=cuda_kernel_aspects())
    return Server(woven, cfg, mesh=mesh)


def depth_counts(counts: dict, layers: int, depth: int | None) -> dict:
    """A serve's launch counts by route at `layers` layers as the same serve
    at `depth` (None: `layers`) gives them: each attention kernel launches
    once a layer and model call, RMSNorm twice a layer and once at the
    end."""
    if depth is None:
        return dict(counts)
    out = {}
    for key, n in counts.items():
        per, rest = divmod(n, 2 * layers + 1) if key == "rmsnorm" else divmod(n, layers)
        if rest:
            raise AssertionError(f"{key}: {n} launches are no whole number of calls "
                                 f"of {layers} layers")
        out[key] = per * (2 * depth + 1) if key == "rmsnorm" else per * depth
    return out


def every_rank(obj, mesh) -> list:
    """Each rank's `obj`, in rank order, on every rank."""
    import torch.distributed as dist

    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def mesh_serve_rank(torch, mesh, solo, batch, depth, quant: bool = False,
                    control=()) -> dict:
    """yi-6b at `depth` layers (None: all) on this rank of the (1, 2) mesh:
    step 5's requests, counted;
    the prefill logits of the first; a profiled decode step; a short
    continuous serve, counted and checked against the server's own step
    counts (then, with "d4" in `control`, `refine_kernel_tuner` after it:
    (d2) decodes in verify rounds only); with `quant`, (q1) the same
    prompts over an int8 pool, plain and self-drafted (`mesh_quant_serve`);
    with "d2" in `control`, (d2) (`control_power`), then with "d4"
    `refine_speculative` after it."""
    import numpy as np

    from repro_torch.distributed import collectives
    from repro_torch.runtime.server import ServerConfig

    t0 = time.perf_counter()
    server = yi_server(torch, mesh, depth,
                       ServerConfig(max_cache_len=4096, decode_tokens=32, seed=0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mcfg = server.woven.program.cfg
    layout = server.woven.state.extra.get("layout")
    server.serve(np.random.default_rng(0).integers(0, mcfg.vocab, (1, 16), dtype=np.int32),
                 decode_tokens=2)  # warm-up, as step 5's
    collectives.reset_counts()
    (solo_out, batch_out), wall, counts, routes = counted_serve(
        torch, lambda: ([server.serve(p) for p in solo], server.serve_batch(batch)))
    colls = collectives.counts()
    toks = torch.as_tensor(solo[0], device="cuda")
    logits, cache = server.prefill_vc(None, server.params, {"tokens": toks})
    logits = logits.float().cpu()
    del cache
    prof = profile_decode(torch, server, toks)
    prompts, opts = continuous_traffic(mcfg)
    prompts = prompts[:MESH_CONTINUOUS]
    collectives.reset_counts()
    cont, cwall, ccounts, croutes = counted_serve(torch, lambda: server.serve_continuous(
        prompts, max_batch=MESH_CONTINUOUS, page_size=opts["page_size"]))
    check_paged_run(server, "mesh", f"rank{mesh.rank} continuous", prompts, cont, ccounts,
                    croutes, False)
    ccolls, cpool = collectives.counts(), server.last_pool_stats
    cstep = dict(server.last_step_counts)
    ctrl = {}
    if "d4" in control:
        ctrl["d4_refine_paged"] = mesh_refine(torch, server, mesh, "paged")
    quant = mesh_quant_serve(torch, server, mesh, prompts, opts,
                             cpool["page_hbm_bytes"]) if quant else None
    if "d2" in control:
        ctrl["d2"] = control_power(torch, server, mesh)
        if "d4" in control:
            ctrl["d4_refine_speculative"] = mesh_refine(torch, server, mesh, "speculative")
    out = {"rank": mesh.rank, "layout": layout, "build_s": build_s,
           "serve_wall_s": wall, "launches": counts, "routes": routes,
           "collectives": colls, "continuous_wall_s": cwall,
           "continuous_launches": ccounts, "continuous_routes": croutes,
           "continuous_steps": cstep, "continuous_collectives": ccolls,
           "pool_bytes_per_rank": cpool["page_hbm_bytes"],
           "profile": prof, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    tokens = {"solo": [o.tolist() for o in solo_out], "batch": [o.tolist() for o in batch_out],
              "continuous": [o.tolist() for o in cont]}
    if quant is not None:
        out["quant"] = quant.pop("runs")
        tokens.update(quant)
    if ctrl:
        out["control"] = ctrl
    del server
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return {"ranks": every_rank(out, mesh), "logits": logits, "tokens": tokens}


def mesh_quant_serve(torch, server, mesh, prompts, opts, bf16_page_bytes) -> dict:
    """(q1) on this rank: `prompts` through `serve_continuous` over an int8
    pool, `QUANT_Q1_TOKENS` tokens a request (K2d on the rank's KV heads),
    then self-drafted at k = 2 over it
    (K2's widened verify over codes, the draft's steps on the split route,
    the verify round's decisions rank 0's).  Gated: launches by route as
    the server's step counts say, every outcome ok, the rank's int8 page at
    most 0.55x its bf16 page, and the speculative serve's step counts and
    emitted tokens against its spec stats (`check_spec_stats`).  Returns
    the runs' counts and each run's tokens."""
    n, keep = QUANT_Q1_TOKENS, server.cfg.decode_tokens
    runs, tokens = {}, {}
    server.cfg.cache_dtype, server.cfg.decode_tokens = "int8", n
    try:
        for tag, k in (("int8", 0), ("int8_k2", 2)):
            out, wall, counts, routes = counted_serve(torch, lambda: server.serve_continuous(
                prompts, max_batch=len(prompts), page_size=opts["page_size"], draft_len=k))
            name = f"rank{mesh.rank} continuous {tag}"
            check_paged_run(server, "mesh", name, prompts, out, counts, routes, True)
            st, sp, pool = server.last_step_counts, server.last_spec_stats, server.last_pool_stats
            if k:
                check_spec_stats(f"mesh {name}", st, sp, out, n * len(prompts), k)
            if not pool["page_hbm_bytes"] <= 0.55 * bf16_page_bytes:
                raise AssertionError(f"mesh {name}: a page of {pool['page_hbm_bytes']} B "
                                     f"against the bf16 pool's {bf16_page_bytes} (bound 0.55x)")
            runs[tag] = {"wall_s": wall, "launches": counts, "routes": routes,
                         "steps": dict(st), "page_hbm_bytes": pool["page_hbm_bytes"],
                         "verify_launches": server.woven.program.cfg.num_layers * st["verify"],
                         "spec": {key: sp[key] for key in ("acceptance", "rounds",
                                                          "verify_steps", "draft_steps")}
                         if sp else None}
            tokens[f"continuous_{tag}"] = [o.tolist() for o in out]
    finally:
        server.cfg.cache_dtype, server.cfg.decode_tokens = None, keep
    return {"runs": runs, **tokens}


# (q2)-(q4) on the same two ranks at (1, 2): yi-6b at full width and 4 of
# 32 layers, (q2) in fp32 over an int8 pool (plain and self-drafted at
# k = 2; the first prefill's logits over the pool), (q3) under `fixed`
# (int8 MLP weights, bf16); (q4) gemma-2b at `MESH_TRAIN_DEPTH` layers
# trained two steps under `CompressionAspect`
QUANT_MESH_RUNS = ("q1", "q2", "q3", "q4")
# (q1)'s greedy tokens a request: a step of the full model on two gloo
# ranks sharing an H100 takes ~0.8 s (32 tokens: 26.4 s plain, 53.1 s
# self-drafted)
QUANT_Q1_TOKENS = 8
QUANT_MESH_SERVE = dict(arch="yi-6b", layers=4, max_len=4096)
QUANT_FIXED_PROMPT = 128  # (q3)'s dense prefill
FP32_POOL_LOGIT_TOL = 1e-5  # (q2): of the logit scale, the fp32 gate


def pool_first_logits(torch, server, prompt, dtype: str | None = "int8"):
    """A first prefill of `prompt` into a fresh `dtype` pool: the logits it
    returns (the last prompt token's), whole, and the pool it wrote (each
    layer group's `pk` / `pv`, and an int8 pool's scale sidecars), on the
    host."""
    from repro_torch.runtime.pages import PagedCacheManager

    captured = {}
    first_token = server._first_token

    def capture(manager, rid, logits, fault=None):
        captured["logits"] = logits[0, -1].float().cpu()
        return first_token(manager, rid, logits, fault)

    server._first_token = capture
    try:
        manager = PagedCacheManager(16, 128, max_len=server.cfg.max_cache_len,
                                    prefix_sharing=False, cache_dtype=dtype)
        server._paged_admit(manager, 0, prompt, len(prompt) + 1, None)
    finally:
        server._first_token = first_token
    pools = {f"{name}/{key}": t.cpu() for name, group in manager._pools.items()
             for key, t in group.items()}
    return captured["logits"], pools


def quant_fp32_rank(torch, server, mesh, prompts) -> dict:
    """(q2) on this rank with `server`, fp32 yi-6b at 4 layers: the first
    prefill's logits over an int8 pool, then `prompts` over an int8 pool,
    plain and at k = 2 (exact launches from the step counts; fp32 q rows
    take the FMA body).  Gated here: the speculative serve's tokens bit for
    bit the plain serve's on the mesh."""
    server._begin()
    layers = server.woven.program.cfg.num_layers
    first = {dt or "fp32": pool_first_logits(torch, server, prompts[0], dt)
             for dt in (None, "int8")}
    runs, tokens = {}, {}
    server.cfg.cache_dtype = "int8"
    try:
        for tag, k in (("plain", 0), ("k2", 2)):
            out, wall, counts, routes = counted_serve(torch, lambda: server.serve_continuous(
                prompts, max_batch=len(prompts), page_size=128, draft_len=k))
            st = server.last_step_counts
            want, _ = expected_launches(st, layers, True)
            if counts != want or any(o["status"] != "ok" for o in server.last_outcomes):
                raise AssertionError(f"(q2) rank{mesh.rank} {tag}: launches {counts} != "
                                     f"{want}, or outcomes {server.last_outcomes}")
            if k:
                check_spec_stats(f"(q2) rank{mesh.rank} {tag}", st, server.last_spec_stats,
                                 out, server.cfg.decode_tokens * len(prompts), k)
            runs[tag] = {"wall_s": wall, "launches": counts, "routes": routes,
                         "steps": dict(st), "verify_launches": layers * st["verify"]}
            tokens[tag] = [o.tolist() for o in out]
    finally:
        server.cfg.cache_dtype = None
    if tokens["k2"] != tokens["plain"]:
        raise AssertionError(f"(q2) rank{mesh.rank}: the fp32 speculative serve over the "
                             "int8 pool parts from plain greedy on the mesh")
    heads = local_heads(QUANT_MESH_SERVE["arch"], mesh)
    return {"ranks": every_rank(runs, mesh), "tokens": tokens,
            "first": every_rank({"heads": heads, **first}, mesh)}


def local_heads(arch, mesh) -> list:
    """The one-card KV heads a rank's pool holds (its q heads')."""
    from repro_torch.kernels.flash_attention.ops import local_kv_heads
    from repro_torch.models.registry import get_config

    cfg = get_config(arch)
    h_loc = cfg.n_heads // mesh.shape["model"]
    return local_kv_heads(cfg.n_heads, cfg.kv_heads, mesh.coord("model") * h_loc, h_loc)


def row_parallel_codes(torch, params, mesh=None, tp: int = 1) -> dict:
    """blake2b digests of the int8 codes and scales of every row-parallel
    weight (the MLPs' `wo`), layer by layer: on a rank of `mesh`, those of
    its rows (`_quantize_int8` over the mesh); on one card, the rows each of
    `tp` ranks holds, cut from the whole weight's codes — {path/layer:
    [(codes, scales) a rank]}."""
    import hashlib

    from repro_torch.nn.blocks import _quantize_int8

    def digest(t):
        return hashlib.blake2b(t.contiguous().cpu().numpy().tobytes(), digest_size=16).hexdigest()

    out = {}
    for path, w in _paths(params):
        if not path.endswith("ffn/wo/w"):
            continue
        for layer in range(w.shape[0]):
            q, scale = _quantize_int8(w[layer], mesh)
            n = q.shape[0] // tp
            out[f"{path}/{layer}"] = [(digest(q[r * n:(r + 1) * n]), digest(scale))
                                      for r in range(tp)]
    return out


def quant_fixed_rank(torch, mesh, prompt) -> dict:
    """(q3) on this rank: yi-6b at 4 layers under `fixed`, the codes and
    scales of its row-parallel weights (`row_parallel_codes`) and a dense
    prefill of `prompt`, counted (K1 a layer, K4 twice a layer and once)."""
    server = family_mesh_server(torch, QUANT_MESH_SERVE, mesh, policy="fixed")
    server._begin()
    layers = server.woven.program.cfg.num_layers
    codes = row_parallel_codes(torch, server.params, mesh)
    toks = torch.as_tensor(prompt[None], device="cuda")
    (logits, cache), wall, counts, routes = counted_serve(
        torch, lambda: server.prefill_vc(None, server.params, {"tokens": toks}))
    want = {"flash_attention": layers, "flash_decode": 0, "flash_decode_quantized": 0,
            "rmsnorm": 2 * layers + 1}
    if counts != want or routes["flash_attention_tc"] != layers:
        raise AssertionError(f"(q3) rank{mesh.rank}: launches {counts} {routes}, "
                             f"expected {want} on the tensor cores")
    out = {"rank": mesh.rank, "coord": mesh.coord("model"), "codes": codes, "wall_s": wall,
           "launches": counts, "routes": routes}
    logits = logits.float().cpu()
    del server, cache
    release(torch)
    return {"ranks": every_rank(out, mesh), "logits": logits}


def compressed_digest(torch, woven, params, mb, mesh=None, match: str = "attn/") -> tuple:
    """The gradient AdamW's first step hands on under int8 compression — the
    gradient of `mb` (on a live mesh: this rank's rows, meaned as the train
    step means them), clipped, compressed with a zero residual
    (`compression.ef_compress`, a row's scale over the ranks that split it)
    — kept as `gradient_digest` keeps a gradient: the loss, the norm, the
    matched leaves gathered whole as (L, n) rows."""
    import math

    from repro_torch.distributed.sharding import (gather_shards, input_shardings,
                                                  local_shard, param_shardings)
    from repro_torch.optim.adamw import AdamWConfig, global_norm
    from repro_torch.optim.compression import ef_compress
    from repro_torch.optim.tree import leaves, rebuild
    from repro_torch.runtime.steps import build_grad_fn, build_mesh_mean

    split = None
    if mesh is not None:
        shard = input_shardings(mb, mesh, woven.state.rules)
        mb = {k: local_shard(v, shard[k]) for k, v in mb.items()}
    (loss, _), grads = build_grad_fn(woven, mesh)(params, mb)
    if mesh is not None:
        split, mean = build_mesh_mean(woven, mesh)
        grads, metrics = mean(grads, {"loss": loss})
        loss = metrics["loss"]
        shardings = leaves(param_shardings(woven.program.model, mesh, woven.state.rules))
    scale = min(1.0, AdamWConfig().clip_norm / max(global_norm(grads, mesh, split).item(),
                                                   1e-12))
    flat = []
    for i, g in enumerate(leaves(grads)):
        kw = {}
        if mesh is not None:
            kw = {"mesh": mesh, "row_axes": shardings[i].dim_axes(-1),
                  "numel": g.numel() * math.prod(mesh.shape[a] for a in split[i])}
        g = g.float() * scale
        flat.append(ef_compress(g, torch.zeros_like(g), **kw)[0])
    grads = rebuild(grads, flat)
    norm = global_norm(grads, mesh, split).item()
    whole = dict(_paths(param_shardings(woven.program.model, mesh, woven.state.rules))) \
        if mesh is not None else {}
    stacks = stack_names(woven)
    attn = {k: (gather_shards(g, whole[k]) if mesh is not None else g).float()
            .reshape(g.shape[0] if k.split("/")[0] in stacks else 1, -1).cpu()
            for k, g in _paths(grads) if match in k}
    return loss.item(), norm, attn


def quant_compress_rank(torch, mesh) -> dict:
    """(q4) on this rank: gemma-2b at `MESH_TRAIN_DEPTH` layers under
    `CompressionAspect`: the compressed gradient's digest at the initial
    weights on the first batch (`compressed_digest`), `MESH_TRAIN["steps"]`
    counted steps, the first batch's loss again, and `ef` shaped as the
    rank's blocks."""
    from repro_torch.core.strategies.parallelization import CompressionAspect
    from repro_torch.distributed.sharding import input_shardings, local_shard
    from repro_torch.optim.tree import leaves
    from repro_torch.runtime.steps import build_loss_fn

    trainer = mesh_trainer(torch, mesh, aspects=[CompressionAspect()])
    trainer.init_state()
    if not trainer.opt_cfg.compression:
        raise AssertionError("(q4): the woven trainer does not compress")
    mb = first_batch(torch, trainer)
    digest = compressed_digest(torch, trainer.woven, trainer.params, mb, mesh)
    layers = trainer.woven.program.cfg.num_layers
    want = {"flash_attention": 2 * layers, "flash_attention_lse": 2 * layers,
            "flash_attention_bwd": layers, "flash_decode": 0, "rmsnorm": 0,
            "rglru": 0, "wkv": 0}
    steps, step_s = [], []
    for i in range(MESH_TRAIN["steps"]):
        t0 = time.perf_counter()
        _, counts, routes = counted_run(torch, lambda: trainer.run(1),
                                        f"mesh (q4) step {i + 1}")
        step_s.append(time.perf_counter() - t0)
        if counts != want:
            raise AssertionError(f"mesh (q4) step {i + 1}: launches {counts} != {want}")
        steps.append({"counts": counts, "routes": routes})
    shard = input_shardings(mb, trainer.mesh, trainer.woven.state.rules)
    with torch.no_grad():
        after, _ = build_loss_fn(trainer.woven, mesh)(
            trainer.params, {k: local_shard(v, shard[k]) for k, v in mb.items()})
    ef = [tuple(e.shape) for e in leaves(trainer.opt_state["ef"])]
    blocks = [tuple(p.shape) for p in leaves(trainer.params)]
    if ef != blocks or not any(bool(e.any()) for e in leaves(trainer.opt_state["ef"])):
        raise AssertionError(f"(q4) rank{mesh.rank}: ef shaped {ef}, the rank's blocks "
                             f"{blocks}, or all zero")
    out = {"rank": mesh.rank, "losses": [h["loss"] for h in trainer.history],
           "first_batch_loss": [digest[0], after.item()], "step_s": step_s,
           "launches_per_step": steps[-1]["counts"], "routes_per_step": steps[-1]["routes"],
           "ef_blocks": len(ef), "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del trainer
    release(torch)
    return {"ranks": every_rank(out, mesh), "digest": digest if mesh.rank == 0 else None}


def quant_mesh_rank(torch, mesh, runs, prompts, control=()) -> dict:
    """(q2)-(q4) of `runs` on this rank of the (1, 2) mesh, and (d1), (d3)
    and (d4)'s drain of `control` on (q2)'s fp32 server."""
    out = {}
    if "q2" in runs or set(control) & {"d1", "d3", "d4"}:
        server = family_mesh_server(torch, QUANT_MESH_SERVE, mesh, policy="double")
        if "q2" in runs:
            out["q2"] = quant_fp32_rank(torch, server, mesh, prompts)
        out["control"] = control_fp32_rank(torch, server, mesh, control)
        del server
        release(torch)
    if "q3" in runs:
        out["q3"] = quant_fixed_rank(torch, mesh, fixed_prompt())
    if "q4" in runs:
        out["q4"] = quant_compress_rank(torch, mesh)
    return out


# (d1)-(d4) on the same two ranks at (1, 2): the serving control plane —
# the QoS governor, a fleet of meshed replicas, a drain and the tuner's
# feedback, every host decision rank 0's.  (d1), (d3) and (d4)'s drain
# serve on (q2)'s fp32 server at 4 layers, (d2) and (d4)'s refines on the
# full-depth bf16 server of `mesh_serve_rank`
CONTROL_MESH_RUNS = ("d1", "d2", "d3", "d4")
# (d1), (d3), (d4)'s drain: the continuous traffic's first 8 prompts (the
# eight sharers of its 1024-token prefix, two arriving at wave 2),
# FAMILY_MESH_DECODE tokens each
CONTROL_PROMPTS = 8
# (d2): four short prompts from seed 41 arriving at waves 0, 0, 1, 2, six
# tokens each: a step of the full model on the two ranks takes ~0.8 s, and
# a verify wave at k = 4 takes six
CONTROL_D2 = {"lens": (96, 160, 224, 288), "arrivals": (0, 0, 1, 2), "tokens": 6}
# (d4): the polls of its handler after which a preemption lands on one rank
CONTROL_DRAIN_AFTER = 3


def control_traffic():
    """(d1), (d3) and (d4)'s drain: the prompts and the serving options."""
    from repro_torch.models.registry import get_config

    prompts, kw = continuous_traffic(get_config("yi-6b"))
    return prompts[:CONTROL_PROMPTS], dict(kw, arrival_waves=kw["arrival_waves"][:CONTROL_PROMPTS])


def fp32_launch_gate(tag, steps: dict, layers: int, counts, routes) -> dict:
    """The launches by route a counted fp32 serve's model calls (`steps`)
    must give: `expected_launches`' counts, every K1 and K2 launch on the
    FMA body (an fp32 q)."""
    want, _ = expected_launches(steps, layers, False)
    want_routes = {"flash_attention_tc": 0, "flash_attention_fma": want["flash_attention"],
                   "flash_decode_tc": 0, "flash_decode_split": 0,
                   "flash_decode_fma": want["flash_decode"]}
    if counts != want or any(routes[k] != v for k, v in want_routes.items()):
        raise AssertionError(f"{tag}: launches {counts} / routes {routes} against {want} / "
                             f"{want_routes} from steps {steps}")
    return {"launches": counts, "routes": routes, "steps": dict(steps),
            "verify_launches": layers * steps["verify"]}


def check_fp32_serve(server, tag, prompts, out, counts, routes, statuses=("ok",)) -> dict:
    """Gates of a counted serve of an fp32 server: an outcome in `statuses`
    for every request, and `fp32_launch_gate` from the server's step
    counts."""
    bad = [o for o in server.last_outcomes if o["status"] not in statuses]
    if bad or len(out) != len(prompts):
        raise AssertionError(f"{tag}: outcomes {bad}")
    return fp32_launch_gate(tag, server.last_step_counts, server.woven.program.cfg.num_layers,
                            counts, routes)


def same_on_every_rank(tag, ranks: list) -> None:
    """Every rank's record (`every_rank`) equal to rank 0's."""
    for r, got in enumerate(ranks):
        if got != ranks[0]:
            keys = sorted(k for k in got if got[k] != ranks[0].get(k))
            raise AssertionError(f"{tag}: rank {r} parts from rank 0 in {keys}")


def control_governed(torch, server, mesh) -> dict:
    """(d1) on this rank: `control_traffic` through the fp32 server
    ungoverned, then under `QOS_BASE` + `QOS_MODEL_SLO` (planned, the draft
    length governed, self-drafted).  Gated: every outcome ok and the
    launches by route from the step counts, both serves; the governed
    tokens bit for bit the ungoverned; distinct_ops >= 2; the draft length
    at 0 and later above it; every rank's `last_qos_stats`, the operating
    point of each wave, the step counts and the tokens rank 0's."""
    prompts, kw = control_traffic()
    runs, tokens = {}, {}
    for tag, qos in (("ungoverned", None), ("governed", {**QOS_BASE, **QOS_MODEL_SLO})):
        events = []
        out, wall, counts, routes = counted_serve(torch, lambda: server.serve_continuous(
            prompts, **kw, qos=qos, on_event=events.append))
        runs[tag] = {"wall_s": wall, **check_fp32_serve(
            server, f"mesh (d1) rank{mesh.rank} {tag}", prompts, out, counts, routes)}
        tokens[tag] = [o.tolist() for o in out]
    q = server.last_qos_stats
    ks = [h["knobs"]["draft_len"] for h in q["op_history"]]
    if tokens["governed"] != tokens["ungoverned"] or q["distinct_ops"] < 2 or 0 not in ks \
            or not any(k > 0 for k in ks[ks.index(0) + 1:]):
        raise AssertionError(f"mesh (d1) rank{mesh.rank}: governed tokens == ungoverned "
                             f"{tokens['governed'] == tokens['ungoverned']}, "
                             f"{q['distinct_ops']} distinct operating points, draft lengths {ks}")
    same_on_every_rank("mesh (d1)", every_rank(
        {"qos": q, "ops": [(e["wave"], e["op"]) for e in events if e["event"] == "wave"],
         "steps": runs["governed"]["steps"], "tokens": tokens["governed"]}, mesh))
    return {"runs": runs, "qos": q, "tokens": tokens["governed"]}


def control_fleet(torch, server, mesh) -> dict:
    """(d3) on this rank: `FLEET`'s replicas and spare of the fp32 server on
    the mesh (`counted_replicas` over its param tree, the rank's shards),
    `control_traffic`'s prompts: clean, a replica lost at its second
    dispatch half-way through its decode, replica 0 drained; and one meshed
    server's `serve_continuous` of the same prompts.  Gated: every outcome
    ok; launches by route from the step counts; the clean tokens bit for
    bit the one server's, the loss's and the drain's the clean run's; the
    loss's `replica_loss`, `declared_dead` and `spare_in` events and a
    re-dispatch, the drain's hand-off; every replica and spare holding the
    server's shards, the peak memory over what was resident below one copy
    of them; every rank's outcomes, events and tokens rank 0's."""
    from repro_torch.core.strategies.resilience import FaultInjector
    from repro_torch.optim.tree import leaves
    from repro_torch.runtime.fleet import ServingFleet
    from repro_torch.runtime.server import _step_counts

    prompts, kw = control_traffic()
    layers, n = server.woven.program.cfg.num_layers, server.cfg.decode_tokens
    shard_bytes = sum(t.numel() * t.element_size() for t in leaves(server.params))
    single, _, counts, routes = counted_serve(torch, lambda: server.serve_continuous(
        prompts, max_batch=kw["max_batch"], page_size=kw["page_size"]))
    runs = {"single": check_fp32_serve(server, f"mesh (d3) rank{mesh.rank} one server",
                                       prompts, single, counts, routes)}
    tokens = {"single": [o.tolist() for o in single]}
    mine = {}
    for tag, fkw, inj, drain in (
            ("clean", {}, None, None),
            ("replica_loss", {"kill_step": n // 2},
             FaultInjector.single("replica_loss", "raise", at=1), None),
            ("drain", {}, None, 0)):
        steps = _step_counts()
        release(torch)
        resident = torch.cuda.memory_allocated()
        fleet = ServingFleet(counted_replicas(server, steps, kw["page_size"], mesh),
                             injector=inj, **FLEET, **fkw)
        if drain is not None:
            fleet.request_drain(drain)
        out, wall, counts, routes = counted_serve(
            torch, lambda: fleet.serve(prompts, decode_tokens=n))
        peak = torch.cuda.max_memory_allocated()
        name = f"mesh (d3) rank{mesh.rank} {tag}"
        st = fleet.last_fleet_stats
        servers = [r.server for r in fleet.replicas] + [r.server for r in fleet.spares]
        if st["outcomes"] != {"ok": len(prompts)} or \
                any(s.params is not server.params for s in servers) \
                or not peak - resident < shard_bytes:
            raise AssertionError(f"{name}: outcomes {st['outcomes']}, shared shards "
                                 f"{[s.params is server.params for s in servers]}, peak "
                                 f"{peak} B over {resident} resident, shards {shard_bytes} B")
        tokens[tag] = [o.tolist() for o in out]
        runs[tag] = {"wall_s": wall, **fp32_launch_gate(name, steps, layers, counts, routes),
                     "rounds": st["rounds"], "redispatched": st["redispatched"],
                     "event_kinds": [e["kind"] for e in st["events"]],
                     "peak_over_resident_gb": (peak - resident) / 1e9,
                     "shard_gb": shard_bytes / 1e9}
        mine[tag] = {"outcomes": fleet.last_outcomes, "events": st["events"],
                     "tokens": tokens[tag]}
    loss = runs["replica_loss"]
    drains = [e for e in mine["drain"]["events"] if e["kind"] == "drain"]
    if tokens["clean"] != tokens["single"] \
            or tokens["replica_loss"] != tokens["clean"] or tokens["drain"] != tokens["clean"] \
            or not {"replica_loss", "declared_dead", "spare_in"} <= set(loss["event_kinds"]) \
            or loss["redispatched"] < 1 or not drains or drains[0]["host"] != 0 \
            or drains[0]["handoff"] < 1:
        raise AssertionError(f"mesh (d3) rank{mesh.rank}: tokens equal one server / clean "
                             f"{[tokens[t] == tokens['single'] for t in mine]}, loss "
                             f"{loss['event_kinds']} {loss['redispatched']} re-dispatched, "
                             f"drains {drains}")
    same_on_every_rank("mesh (d3)", every_rank(mine, mesh))
    return {"runs": runs, "tokens": tokens}


def control_drain(torch, server, mesh) -> dict:
    """(d4)'s drain on this rank: `control_traffic`'s prompts two at a time,
    with a `PreemptionHandler` whose `pending` turns true on one rank alone
    after `CONTROL_DRAIN_AFTER` polls — rank 0's, then rank 1's.  Every rank
    polls its own handler and takes rank 0's reading.  Gated: every rank
    drains the same requests at the same waves — some where the preemption
    reaches rank 0, none where it reaches rank 1 alone —, polls its handler
    as often and gives the same outcomes and tokens; the launches by route
    from the step counts; the serve ends."""
    from repro_torch.distributed.fault import PreemptionHandler

    class OneRank(PreemptionHandler):
        def __init__(self, rank):
            super().__init__(install=False)
            self.mine, self.polls = mesh.rank == rank, 0

        @property
        def pending(self) -> bool:
            self.polls += 1
            if self.mine and self.polls > CONTROL_DRAIN_AFTER:
                self.request()
            return self.requested.is_set()

    prompts, kw = control_traffic()
    runs = {}
    for rank in (0, 1):
        pre, events = OneRank(rank), []
        toks, wall, counts, routes = counted_serve(torch, lambda: server.serve_continuous(
            prompts, **dict(kw, max_batch=2), preemption=pre, on_event=events.append))
        tag = f"mesh (d4) drain reaching rank {rank}"
        rep = check_fp32_serve(server, f"{tag}, rank{mesh.rank}", prompts, toks, counts,
                               routes, statuses=("ok", "drained"))
        drained = [(e["rid"], e["wave"]) for e in events
                   if e["event"] == "outcome" and e["status"] == "drained"]
        same_on_every_rank(tag, every_rank(
            {"drained": drained, "polls": pre.polls, "tokens": [t.tolist() for t in toks],
             "outcomes": [o["status"] for o in server.last_outcomes]}, mesh))
        if bool(drained) != (rank == 0):
            raise AssertionError(f"{tag}: drained {drained}")
        runs[f"reaches_rank{rank}"] = {"wall_s": wall, **rep, "drained": drained,
                                       "polls": pre.polls}
    return {"runs": runs}


def control_fp32_rank(torch, server, mesh, runs) -> dict:
    """(d1), (d3) and (d4)'s drain of `runs` on this rank with (q2)'s fp32
    server: rank 0's reports, each run's seconds, and every rank's launches
    by route (and verify launches) by run."""
    out, counted = {}, {}
    for tag, fn in (("d1", control_governed), ("d3", control_fleet), ("d4", control_drain)):
        if tag not in runs:
            continue
        t0 = time.perf_counter()
        out[tag] = fn(torch, server, mesh)
        out[tag]["seconds"] = time.perf_counter() - t0
        counted.update({f"{tag}_{name}": {**rep["launches"], **rep["routes"],
                                          "verify_launches": rep["verify_launches"]}
                        for name, rep in out[tag]["runs"].items()})
    out["launches"] = every_rank(counted, mesh)
    return out


def control_power(torch, server, mesh) -> dict:
    """(d2) on this rank: `CONTROL_D2`'s prompts through the full-depth bf16
    server under `QOS_BASE` + `QOS_POWER` with `reactive` on: rank 0's
    governor plans and learns from rank 0's clock, one broadcast a
    re-selection.  Gated: every outcome ok and exact launches by route
    (`check_paged_run`); every rank's `op_history` and operating point of
    each wave rank 0's; freq < 1 in force at some wave.  Printed: the
    op_history, modeled energy, TTFT and gap, and on rank 0 the host µs of
    `decide` beside a re-selection's (`decide` and its broadcast)."""
    import numpy as np

    from repro_torch.runtime import server as server_mod
    from repro_torch.runtime.qos import QoSGovernor

    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, server.woven.program.cfg.vocab, s) for s in CONTROL_D2["lens"]]
    gov = QoSGovernor({**QOS_BASE, **QOS_POWER, "reactive": True}, broker=server.broker)
    glog = governed(gov)
    plane, events = [], []
    real = server_mod._RankZeroGovernor.decide

    def timed(self, **load):
        t0 = time.perf_counter()
        knobs = real(self, **load)
        plane.append(time.perf_counter() - t0)
        return knobs

    keep = server.cfg.decode_tokens
    server_mod._RankZeroGovernor.decide = timed
    server.cfg.decode_tokens = CONTROL_D2["tokens"]
    try:
        t0 = time.perf_counter()
        out, wall, counts, routes = counted_serve(torch, lambda: server.serve_continuous(
            prompts, page_size=128, max_batch=len(prompts),
            arrival_waves=list(CONTROL_D2["arrivals"]), qos=gov, on_event=events.append))
        check_paged_run(server, "mesh", f"rank{mesh.rank} (d2)", prompts, out, counts,
                        routes, False)
    finally:
        server_mod._RankZeroGovernor.decide = real
        server.cfg.decode_tokens = keep
    q, st, sp = server.last_qos_stats, dict(server.last_step_counts), server.last_spec_stats
    ops = [(e["wave"], e["op"]) for e in events if e["event"] == "wave"]
    same_on_every_rank("mesh (d2)", every_rank({"op_history": q["op_history"], "ops": ops},
                                               mesh))
    freq = min(op["freq"] for _, op in ops)
    if not freq < 1.0:
        raise AssertionError(f"mesh (d2) rank{mesh.rank}: freq never fell below 1 ({ops})")
    rep = {"op_history": q["op_history"], "switches": q["switches"],
           "distinct_ops": q["distinct_ops"], "waves": q["waves"],
           "energy_j_modeled": q["energy_j"], "tokens_per_joule_modeled": q["tokens_per_joule"],
           "capper": q["power"], "freq_min_in_force": freq, **latency_summary(server, wall),
           "launches": counts, "routes": routes, "steps": st,
           "verify_launches": server.woven.program.cfg.num_layers * st["verify"],
           "spec": {k: sp[k] for k in ("rounds", "verify_steps", "draft_steps", "acceptance")},
           "seconds": time.perf_counter() - t0}
    if mesh.rank == 0:
        decide = 1e6 * float(np.mean(glog["decide_s"]))
        rep.update(decide_us=decide, reselection_us=1e6 * float(np.mean(plane)),
                   broadcast_us=1e6 * float(np.mean(plane)) - decide,
                   observe_wave_us=1e6 * float(np.mean(glog["observe_s"])))
    return rep


def mesh_refine(torch, server, mesh, kind: str) -> dict:
    """(d4)'s feedback on this rank after `server`'s last serve: rank 0
    tunes the signature the refine keys on into a file of its own
    (`KernelTuner.tune` on the card), then every rank calls
    `refine_kernel_tuner` (kind "paged") or `refine_speculative` over a
    tuner of that file, with a budget of twice what it observed.  Gated: one
    cache write, rank 0's; every rank returns rank 0's knobs, and knobs.
    Printed: rank 0's stored `error_coef` and observation."""
    import numpy as np

    from repro_torch.autotune import kernel_tuner as kt

    t0 = time.perf_counter()
    home = os.path.dirname(os.environ["REPRO_TORCH_TUNER_CACHE"])
    tuner = kt.KernelTuner(os.path.join(home, f"mesh_{kind}.json"))
    cfg = server.woven.program.cfg
    if kind == "paged":
        lat = server._step_lat_by_batch
        batch = max(lat, key=lambda b: len(lat[b]))
        observed = float(np.mean(lat[batch]))
        sig = server._paged_signature(batch=batch, dtype=server._paged_dtype)
        refine = server.refine_kernel_tuner
    else:
        st = server.last_spec_stats
        batch = max(1, round(st["request_rounds"] / max(st["rounds"], 1)))
        observed = float(st["verify_latency_s"])
        sig = kt.speculative_signature(batch, server.cfg.max_cache_len, cfg.n_heads,
                                       cfg.kv_heads, cfg.resolved_head_dim, server._paged_dtype)
        refine = server.refine_speculative
    if mesh.rank == 0:
        tuner.tune(sig, num_tests=3)
    tune_s = time.perf_counter() - t0
    puts, put = [], tuner.cache.put
    tuner.cache.put = lambda key, entry: (puts.append(key), put(key, entry))
    knobs = refine(latency_budget=2 * observed, tuner=tuner)
    ranks = every_rank({"knobs": knobs, "writes": len(puts)}, mesh)
    if [r["writes"] for r in ranks] != [1] + [0] * (mesh.size - 1) or knobs is None \
            or any(r["knobs"] != ranks[0]["knobs"] for r in ranks):
        raise AssertionError(f"mesh (d4) {kind} refine: {ranks}")
    entry = tuner.cache.get(tuner._key(sig)) if mesh.rank == 0 else None
    return {"signature": sig.key(), "ranks": ranks, "tune_s": tune_s,
            "runtime": entry["runtime"] if entry else None,
            "seconds": time.perf_counter() - t0}


def fixed_prompt():
    """(q3)'s prompt, from seed 31."""
    import numpy as np

    from repro_torch.models.registry import get_config

    vocab = get_config(QUANT_MESH_SERVE["arch"]).vocab
    return np.random.default_rng(31).integers(0, vocab, QUANT_FIXED_PROMPT)


def release(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def mesh_gradient_digest(torch, trainer, mb, match: str = "attn/") -> tuple:
    """`gradient_digest` of a meshed trainer: this rank's rows of `mb`, the
    gradients and the loss meaned over the mesh as the train step means
    them (`steps.build_mesh_mean`), the norm over every shard, the matched
    weights' gradients gathered whole."""
    from repro_torch.distributed.sharding import (gather_shards, input_shardings,
                                                  local_shard, param_shardings)
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime.steps import build_grad_fn, build_mesh_mean

    mesh, woven = trainer.mesh, trainer.woven
    shard = input_shardings(mb, mesh, woven.state.rules)
    local = {k: local_shard(v, shard[k]) for k, v in mb.items()}
    (loss, _), grads = build_grad_fn(woven, mesh)(trainer.params, local)
    split, mean = build_mesh_mean(woven, mesh)
    grads, metrics = mean(grads, {"loss": loss})
    norm = global_norm(grads, mesh, split).item()
    shardings = dict(_paths(param_shardings(woven.program.model, mesh, woven.state.rules)))
    stacks = stack_names(woven)
    attn = {k: gather_shards(g, shardings[k]).float()
            .reshape(g.shape[0] if k.split("/")[0] in stacks else 1, -1).cpu()
            for k, g in _paths(grads) if match in k}
    return metrics["loss"].item(), norm, attn


def mesh_train_program(torch, device="cuda"):
    from repro_torch.core.program import Program
    from repro_torch.models.registry import build_model, get_config

    cfg = get_config("gemma-2b").replace(num_layers=MESH_TRAIN_DEPTH)
    return Program(model=build_model(cfg), cfg=cfg, kind="train", device=device)


def mesh_trainer(torch, mesh, aspects=()):
    from functools import partial

    from repro_torch.launch.train import program_trainer
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.trainer import TrainerConfig

    t = MESH_TRAIN
    return program_trainer(
        mesh_train_program(torch), batch=t["batch"], seq=t["seq"], mesh=mesh,
        overrides={"accum_steps": 1, "remat": "full", "precision": "half"},
        tcfg=TrainerConfig(steps=t["steps"], log_every=0, seed=0),
        lr_fn=partial(constant, peak=t["lr"]), extra_aspects=list(aspects))


def first_batch(torch, trainer):
    """The batch the trainer's pipeline gives first (a fresh pipeline of
    its configuration), on the card."""
    from repro_torch.data.pipeline import TokenPipeline

    return {k: torch.as_tensor(v).cuda()
            for k, v in next(TokenPipeline(trainer.pipeline.cfg)).items()}


def mesh_train_rank(torch, mesh, tag) -> dict:
    """gemma-2b at `MESH_TRAIN_DEPTH` layers trained on this rank of `mesh`:
    the gradient digest at the initial weights on the first batch,
    `MESH_TRAIN["steps"]` counted steps, the first batch's loss again."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.collectives import all_reduce
    from repro_torch.distributed.sharding import input_shardings, local_shard
    from repro_torch.runtime.steps import build_loss_fn

    trainer = mesh_trainer(torch, mesh)
    trainer.init_state()
    mb = first_batch(torch, trainer)
    digest = mesh_gradient_digest(torch, trainer, mb)
    layers = trainer.woven.program.cfg.num_layers
    want = {"flash_attention": 2 * layers, "flash_attention_lse": 2 * layers,
            "flash_attention_bwd": layers, "flash_decode": 0, "rmsnorm": 0,
            "rglru": 0, "wkv": 0}
    collectives.reset_counts()
    steps, step_s = [], []
    for i in range(MESH_TRAIN["steps"]):
        t0 = time.perf_counter()
        _, counts, routes = counted_run(torch, lambda: trainer.run(1),
                                        f"mesh {tag} step {i + 1}")
        step_s.append(time.perf_counter() - t0)
        if counts != want:
            raise AssertionError(f"mesh {tag} step {i + 1}: launches {counts} != {want}")
        steps.append({"counts": counts, "routes": routes})
    shard = input_shardings(mb, mesh, trainer.woven.state.rules)
    with torch.no_grad():
        after, _ = build_loss_fn(trainer.woven, mesh)(
            trainer.params, {k: local_shard(v, shard[k]) for k, v in mb.items()})
    after = (all_reduce(after, mesh, "data") / mesh.shape["data"]).item()
    out = {"rank": mesh.rank, "mesh": dict(mesh.shape),
           "layout": trainer.woven.state.extra.get("layout"),
           "losses": [h["loss"] for h in trainer.history],
           "grad_norms": [h["grad_norm"] for h in trainer.history],
           "first_batch_loss": [digest[0], after], "step_s": step_s,
           "launches_per_step": steps[-1]["counts"], "routes_per_step": steps[-1]["routes"],
           "collectives_all_steps": collectives.counts(),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return {"ranks": every_rank(out, mesh), "digest": digest if mesh.rank == 0 else None}


# AutoShard's FSDP layouts on the same two ranks, each model at published
# width and cut in depth so that both ranks' state fits the one card:
# (f1) qwen2-72b at 1 of 80 layers, AutoShard's own megatron_tp with `embed`
# over data (3.369 B parameters, 47.2 GB of state whole); (f2) rwkv6-3b and
# (f3) recurrentgemma-2b under dp_fsdp, served (K6 and K5 on each rank's
# rows) and trained, with the `embed` rule of rwkv6-3b's full depth carried
# by the `rules` override; (f4) gemma-2b under fsdp_sp, its pod layout,
# forced through AutoShard's `layout=` with the pod's `embed` rule.  One
# counted step each (profiled where the run says: a first step, its train
# step's build included), and (f2) / (f3) / (f4) at 2 / 3 / 2 layers, to
# leave the script's time limit room for (g1)-(g3) and (s1)-(s4).
FSDP_RUNS = {
    "f1": dict(arch="qwen2-72b", layers=1, mesh=(2, 1), layout="megatron_tp",
               rules=None, serve=None, match="attn/", attn=1, profile=True),
    # not profiled: the profiler's own cost on the plain WKV's kernels under
    # autograd (19 s on a 9.7 s step) is over the phase's budget
    "f2": dict(arch="rwkv6-3b", layers=2, mesh=(1, 2), layout="dp_fsdp",
               rules={"embed": ("data", "model")}, serve="double", match="time_mix/",
               attn=0, profile=False),
    "f3": dict(arch="recurrentgemma-2b", layers=3, mesh=(2, 1), layout="dp_fsdp",
               rules={"embed": ("data", "model")}, serve="half", match="attn/", attn=1,
               profile=True),
    "f4": dict(arch="gemma-2b", layers=2, mesh=(1, 2), layout="fsdp_sp",
               rules={"embed": ("data", "model")}, serve=None, match="attn/", attn=2,
               profile=True),
}
FSDP_TRAIN = {"batch": 4, "seq": 512, "steps": 1, "lr": 1e-3}
# every model call of a served FSDP run gathers every weight through the host
# (~0.5 GB/s a rank over gloo): the serving traffic's first two prompts, one
# a rank, two tokens each
FSDP_PROMPTS = 2
FSDP_DECODE = 2
FSDP_LOGIT_ROWS = 4  # (f4) logit positions shipped back: each rank's block's ends


def fsdp_program(run, kind: str, device="cuda"):
    from repro_torch.core.program import Program
    from repro_torch.models.registry import build_model, get_config

    cfg = get_config(run["arch"]).replace(num_layers=run["layers"])
    return Program(model=build_model(cfg), cfg=cfg, kind=kind, device=device)


def fsdp_aspects(run, mesh_axes: dict, train: bool) -> list:
    """The aspects that lay `run` out as it says, after `default_weave`'s
    own AutoShard: AutoShard's `layout=` where it forces one, the `embed`
    rule where the run carries one."""
    from repro_torch.core.strategies.parallelization import AutoShard, ShardingAspect

    out = []
    if run["layout"] == "fsdp_sp":
        out.append(AutoShard(dict(mesh_axes), train=train, layout="fsdp_sp"))
    if run["rules"]:
        out.append(ShardingAspect(run["rules"]))
    return out


def fsdp_server(torch, run, mesh):
    """`run`'s server, woven to the CUDA kernels as `launch/serve` weaves
    them, on `mesh` (None: one card) at the run's serving policy."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
    from repro_torch.nn.dtypes import PolicyResolver
    from repro_torch.runtime.server import Server, ServerConfig

    axes = dict(mesh.shape) if mesh is not None else {}
    woven = default_weave(fsdp_program(run, "serve"), SHAPES["prefill_32k"], axes,
                          extra_aspects=cuda_kernel_aspects() + fsdp_aspects(run, axes, False))
    woven.state.policies = PolicyResolver.default(run["serve"])
    return Server(woven, ServerConfig(max_cache_len=4096, decode_tokens=FSDP_DECODE,
                                      seed=0), mesh=mesh)


def fsdp_trainer(torch, run, mesh):
    from functools import partial

    from repro_torch.launch.train import program_trainer
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.trainer import TrainerConfig

    t = FSDP_TRAIN
    axes = dict(mesh.shape) if mesh is not None else {}
    overrides = {"accum_steps": 1, "remat": "full", "precision": "half"}
    return program_trainer(
        fsdp_program(run, "train"), batch=t["batch"], seq=t["seq"], mesh=mesh,
        overrides=overrides, extra_aspects=fsdp_aspects(run, axes, True),
        tcfg=TrainerConfig(steps=t["steps"], log_every=0, seed=0),
        lr_fn=partial(constant, peak=t["lr"]))


@contextlib.contextmanager
def k5_capture(torch, box: list):
    """The first K5 call's inputs and output, on the host, into `box`."""
    from repro_torch.kernels.rglru import ops as lru_ops

    real = lru_ops.rglru

    def record(a, b, h0):
        out = real(a, b, h0)
        if not box:
            box.append({"a": a.float().cpu(), "b": b.float().cpu(), "h0": h0.float().cpu(),
                        "h": out[0].cpu(), "h_last": out[1].cpu()})
        return out

    record.launches = real.launches  # the wrapper counts through its module's name
    lru_ops.rglru = record
    try:
        yield box
    finally:
        lru_ops.rglru = real
        real.launches = record.launches


def resident_check(torch, tag, trainer) -> dict:
    """Every leaf of this rank's parameters and AdamW state is its block
    of the whole leaf (`shard_shape` of the model's spec), none kept
    gathered; the resident parameter + master + m + v bytes, against the
    whole model's."""
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.nn.module import flatten_specs

    model = trainer.woven.program.model
    shardings = dict(_paths(param_shardings(model, trainer.mesh, trainer.woven.state.rules)))
    whole = {path.split("/", 1)[1]: spec.shape for path, spec in flatten_specs(model).items()}
    local, full, split = 0, 0, 0
    for tree in ("params", "master", "m", "v"):
        leaves = dict(_paths(trainer.params if tree == "params" else trainer.opt_state[tree]))
        for path, t in leaves.items():
            want = shardings[path].shard_shape(whole[path])
            if tuple(t.shape) != tuple(want):
                raise AssertionError(f"fsdp {tag}: {tree} {path} holds {tuple(t.shape)}, "
                                     f"its block is {want}")
            n = 1
            for d in whole[path]:
                n *= d
            local += t.numel() * t.element_size()
            full += n * t.element_size()
            split += t.numel() < n
    return {"resident_gb": local / 1e9, "whole_gb": full / 1e9, "split_leaves": split,
            "leaves": 4 * len(shardings)}


def fsdp_prompts(vocab: int) -> list:
    """The serving traffic's first `FSDP_PROMPTS` prompts
    (`SERVE_BATCH_LENS`) in `vocab`, from seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int64)
            for n in SERVE_BATCH_LENS[:FSDP_PROMPTS]]


def fsdp_serve_rank(torch, mesh, tag, run) -> dict:
    """`run` served on this rank: a counted `serve_batch` of the traffic's
    first `FSDP_PROMPTS` prompts (the rank serves its rows), recording the
    prefill logits of its first prompt and K5's first call on it."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import local_shard

    server = fsdp_server(torch, run, mesh)
    prompts = fsdp_prompts(server.woven.program.cfg.vocab)
    first, prefill = {}, server.prefill_vc

    def recording(*a, **k):  # the rank's first prefill: its first prompt's logits
        logits, cache = prefill(*a, **k)
        first.setdefault("logits", logits.float().cpu())
        return logits, cache

    server.prefill_vc = recording
    collectives.reset_counts()
    t0 = time.perf_counter()
    with k5_capture(torch, []) as k5:
        out, counts, routes = counted_run(torch, lambda: server.serve_batch(prompts),
                                          f"fsdp {tag} serve")
    wall = time.perf_counter() - t0
    server.prefill_vc = prefill
    rank_log(mesh, f"fsdp {tag}: served in {wall:.2f} s")
    mine = local_shard(torch.arange(len(prompts)), server._rows(len(prompts))).tolist()
    res = {"rank": mesh.rank, "layout": server.woven.state.extra.get("layout"),
           "embed": server.woven.state.rules.get("embed"), "rows": mine,
           "launches": counts, "routes": routes, "serve_wall_s": wall,
           "collectives": collectives.counts(), "tokens": [o.tolist() for o in out],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "logits": first["logits"], "k5": k5[0] if k5 else None}
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return res


def busy_step(torch, fn) -> dict:
    """`fn()` (one step) under `torch.profiler`: the host wall, the device's
    busy time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(_device_us(e) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"profiled_step_wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None}


def fsdp_train_rank(torch, mesh, tag, run) -> dict:
    """`run` trained on this rank: under fsdp_sp the dense logits of the
    first batch's first row at the initial weights, `FSDP_TRAIN["steps"]`
    counted steps (the first recording its gradient's digest, the last
    profiled where the run says), the first batch's loss again, the
    resident state."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import input_shardings, local_shard
    from repro_torch.runtime.steps import build_loss_fn, build_mesh_mean

    trainer = fsdp_trainer(torch, run, mesh)
    trainer.init_state()
    rank_log(mesh, f"fsdp {tag}: trainer state on the card")
    mb = first_batch(torch, trainer)
    logits = None
    if run["layout"] == "fsdp_sp":  # the dense logits of the first row, whole
        from repro_torch.models.lm import whole_logits

        toks = mb["tokens"][:1]
        with torch.no_grad():
            x, _ = trainer.woven.program.model(
                trainer.params, {"tokens": toks}, ctx=trainer.woven.state.make_ctx(mesh=mesh),
                mode="dense")
            x = whole_logits(x, mesh, trainer.woven.program.cfg.vocab)
        logits = x[0, fsdp_logit_positions(toks.shape[1])].float().cpu()
        del x
    n = run["attn"]
    want = {"flash_attention": 2 * n, "flash_attention_lse": 2 * n,
            "flash_attention_bwd": n, "flash_decode": 0, "rmsnorm": 0, "rglru": 0, "wkv": 0}
    collectives.reset_counts()
    step_s, prof, digest = [], None, []
    for i in range(FSDP_TRAIN["steps"]):
        last = i == FSDP_TRAIN["steps"] - 1
        t0 = time.perf_counter()
        box = {}

        def step():
            if last and run["profile"]:
                box.update(busy_step(torch, lambda: trainer.run(1)))
            else:
                trainer.run(1)

        # the first step builds the train step: its gradient mean records the
        # digest of the first batch's gradient at the initial weights
        with step_digest(torch, run["match"], digest) if i == 0 else contextlib.nullcontext():
            _, counts, routes = counted_run(torch, step, f"fsdp {tag} step {i + 1}")
        step_s.append(time.perf_counter() - t0)
        prof = box or prof
        rank_log(mesh, f"fsdp {tag}: step {i + 1} in {step_s[-1]:.2f} s")
        if counts != want:
            raise AssertionError(f"fsdp {tag} step {i + 1}: launches {counts} != {want}")
    colls = collectives.counts()
    shard = input_shardings(mb, mesh, trainer.woven.state.rules)
    with torch.no_grad():
        after, _ = build_loss_fn(trainer.woven, mesh)(
            trainer.params, {k: local_shard(v, shard[k]) for k, v in mb.items()})
    after = build_mesh_mean(trainer.woven, mesh)[1]({}, {"loss": after})[1]["loss"].item()
    out = {"rank": mesh.rank, "mesh": dict(mesh.shape),
           "layout": trainer.woven.state.extra.get("layout"),
           "rules": {k: v for k, v in trainer.woven.state.rules.items()
                     if k in ("batch", "embed", "vocab", "res_seq", "heads", "mlp")},
           "losses": [h["loss"] for h in trainer.history],
           "grad_norms": [h["grad_norm"] for h in trainer.history],
           "first_batch_loss": [digest[0][0], after], "step_s": step_s, "profile": prof,
           "launches_per_step": counts, "routes_per_step": routes,
           "collectives_per_run": colls, "resident": resident_check(torch, tag, trainer),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {**out, "digest": digest[0], "logits": logits}


@contextlib.contextmanager
def step_digest(torch, match: str, box: list):
    """`mesh_gradient_digest`'s reading of the train step built inside:
    its gradient mean (`steps.build_mesh_mean`) records, on its first call,
    the meaned loss, the global norm over every shard and the matched
    weights' gradients gathered whole, into `box`."""
    from repro_torch.distributed.sharding import gather_shards
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime import steps

    real = steps.build_mesh_mean

    def build(woven, mesh, variant=None):
        from repro_torch.distributed.sharding import param_shardings

        split, mean = real(woven, mesh, variant)
        shardings = dict(_paths(param_shardings(woven.program.model, mesh,
                                                woven.state.rules)))
        stacks = stack_names(woven)

        def recording(grads, metrics):
            grads, metrics = mean(grads, metrics)
            if not box:
                # copies: the optimizer scales the gradients in place next
                attn = {k: gather_shards(g, shardings[k]).to("cpu", torch.float32, copy=True)
                        .reshape(g.shape[0] if k.split("/")[0] in stacks else 1, -1)
                        for k, g in _paths(grads) if match in k}
                box.append((metrics["loss"].item(), global_norm(grads, mesh, split).item(),
                            attn))
            return grads, metrics

        return split, recording

    steps.build_mesh_mean = build
    try:
        yield box
    finally:
        steps.build_mesh_mean = real


def rank_log(mesh, msg: str) -> None:
    """`log` from the first rank of a live mesh."""
    if mesh.rank == 0:
        log(msg)


def fsdp_logit_positions(S: int) -> list:
    """The first and last position of each half of a sequence of S."""
    return [0, S // 2 - 1, S // 2, S - 1][:FSDP_LOGIT_ROWS]


def fsdp_rank(torch, mesh, tag, run) -> dict:
    """(f1)..(f4) on this rank; each rank's results on every rank, and this
    rank's gradient digest beside its own (`rank0_digest`)."""
    out = {}
    if run["serve"]:
        out["serve"] = every_rank(fsdp_serve_rank(torch, mesh, tag, run), mesh)
    torch.cuda.reset_peak_memory_stats()
    out["train"] = rank0_digest(fsdp_train_rank(torch, mesh, tag, run), mesh)
    torch.cuda.reset_peak_memory_stats()
    return out


def rank0_digest(out: dict, mesh) -> list:
    """`every_rank` of a rank's results but its gradient digest (`digest`),
    which goes back into its own entry only: the parent reads rank 0's, and
    a digest (whole attention-weight gradients) would otherwise be pickled
    and moved through the host once for every rank."""
    digest = out.pop("digest")
    ranks = every_rank(out, mesh)
    ranks[mesh.rank]["digest"] = digest
    return ranks


def mesh_rank(solo, batch, serve_depth, train_shapes, fsdp_runs, family_runs, family_sp_runs,
              serve_sp_runs, quant_runs, control_runs, t_spawn, mesh) -> dict:
    """Phase 12's body on each rank: serve on the mesh run_on_mesh gives (yi-6b
    at `serve_depth` layers; (q1) over the int8 pool with "q1" in
    `quant_runs`, (d2) and (d4)'s refines of `control_runs`), then train on
    each of `train_shapes` ({tag: shape}) over the same ranks, then
    `fsdp_runs` ({tag: run}), each on its mesh of the same ranks, then
    `family_runs` and `family_sp_runs` ({tag: run}), `serve_sp_runs`
    (tags of `SERVE_SP_RUNS`), the rest of
    `quant_runs` and (d1), (d3) and (d4)'s drain on (1, 2).  `t_spawn`: the
    parent's `time.time()` at the spawn, for the ranks' start-up time."""
    import torch

    from repro_torch.kernels import build

    build.library()  # built by the parent: loaded here
    rank_log(mesh, f"mesh ranks: running {time.time() - t_spawn:.1f} s after the spawn")
    meshes = {mesh.axis_sizes: mesh}
    clock = PhaseClock(time.perf_counter()) if mesh.rank == 0 else (lambda name: None)
    out = {"serve": mesh_serve_rank(torch, mesh, solo, batch, serve_depth,
                                    quant="q1" in quant_runs, control=control_runs)}
    clock("mesh serve yi-6b")
    for tag, shape in train_shapes.items():
        out[tag] = mesh_train_rank(torch, mesh_of(meshes, mesh, shape), tag)
        clock(f"mesh train {tag}")
    out.update(fsdp_ranks(torch, fsdp_runs, mesh, meshes))
    clock("mesh fsdp runs")
    for tag, run in family_runs.items():
        out[tag] = family_mesh_rank(torch, mesh_of(meshes, mesh, (1, 2)), tag, run)
        clock(f"mesh family {tag}")
    for tag, run in family_sp_runs.items():
        out[tag] = family_sp_rank(torch, mesh_of(meshes, mesh, (1, 2)), tag, run)
        clock(f"mesh family {tag}")
    if serve_sp_runs:
        out["serve_sp"] = serve_sp_rank(torch, mesh_of(meshes, mesh, (1, 2)), serve_sp_runs)
        clock("mesh serve (s1)-(s4)")
    if set(quant_runs) - {"q1"} or set(control_runs) & {"d1", "d3", "d4"}:
        out["quant"] = quant_mesh_rank(torch, mesh_of(meshes, mesh, (1, 2)), quant_runs,
                                       quant_prompts(), control_runs)
        clock("mesh (q2)-(q4), (d1), (d3), (d4)")
    rank_log(mesh, f"mesh ranks: done {time.time() - t_spawn:.1f} s after the spawn")
    return out


def quant_prompts() -> list:
    """(q1) / (q2)'s prompts: the first `MESH_CONTINUOUS` of the continuous
    traffic."""
    from repro_torch.models.registry import get_config

    return continuous_traffic(get_config("yi-6b"))[0][:MESH_CONTINUOUS]


def mesh_of(meshes: dict, mesh, shape):
    """The mesh of `shape` over `mesh`'s ranks: one set of process groups
    per shape, made by every rank alike."""
    from repro_torch.launch.mesh import make_mesh

    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, backend=mesh.backend, device=mesh.device.type)
    return meshes[shape]


def fsdp_ranks(torch, fsdp_runs, mesh, meshes=None) -> dict:
    """Every run of `fsdp_runs` on this rank, each on its mesh."""
    meshes = meshes if meshes is not None else {mesh.axis_sizes: mesh}
    out = {}
    for tag, run in fsdp_runs.items():
        t0 = time.perf_counter()
        out[tag] = fsdp_rank(torch, mesh_of(meshes, mesh, run["mesh"]), tag, run)
        out[tag]["rank0_wall_s"] = time.perf_counter() - t0
    return out


def fsdp_gathers(tag, rules_embed, mesh_shape: dict, colls: dict, backward: bool) -> None:
    """The FSDP gathers (and, with `backward`, their reduce-scatters) were
    counted over every axis of the `embed` rule that spans ranks."""
    axes = [a for a in (rules_embed or ()) if mesh_shape.get(a, 1) > 1]
    kinds = ("fsdp_gather", "fsdp_reduce_scatter") if backward else ("fsdp_gather",)
    for a in axes:
        for kind in kinds:
            if not colls.get(kind, {}).get(a, {}).get("calls"):
                raise AssertionError(f"fsdp {tag}: no {kind} over {a}: {colls}")
    if not axes:
        raise AssertionError(f"fsdp {tag}: the embed rule {rules_embed} splits no axis")


def fsdp_serve_check(torch, tag, run, ranks) -> dict:
    """Each rank's serving against one card serving that rank's rows: the
    launches by route equal, the prefill logits of its first prompt at the
    logit gates, K5 on its rows bit for bit one card's (the kernel on the
    rank's recorded inputs; the one-card server's own K5 call on the same
    prompt beside, printed), the FSDP gathers counted."""
    import numpy as np

    from repro_torch.kernels.rglru import ops as lru_ops

    one = fsdp_server(torch, run, None)
    prompts = fsdp_prompts(one.woven.program.cfg.vocab)
    one.serve(np.zeros((1, 16), np.int32), decode_tokens=2)
    out = []
    for r in ranks:
        if r["layout"] != "dp_fsdp":
            raise AssertionError(f"fsdp {tag} serve: layout {r['layout']}")
        mine = [prompts[i] for i in r["rows"]]
        want_tok, counts, routes = counted_run(torch, lambda: one.serve_batch(mine),
                                               f"fsdp {tag} one card")
        got, want = {**r["launches"], **r["routes"]}, {**counts, **routes}
        if got != want:
            raise AssertionError(f"fsdp {tag} serve rank {r['rank']}: launches by route "
                                 f"{got} != one card's on its rows {want}")
        agree = float(np.mean([np.mean(np.asarray(r["tokens"][i]) == w)
                               for i, w in zip(r["rows"], want_tok)]))
        toks = torch.as_tensor(mine[0], device="cuda").to(torch.int32)[None]
        with k5_capture(torch, []) as k5:
            logits, cache = one.prefill_vc(None, one.params, {"tokens": toks})
        del cache
        gap = logit_diff(torch, f"fsdp {tag} rank {r['rank']} prefill", r["logits"],
                         logits.float().cpu())
        if not (gap["max_abs_err"] <= LOGIT_MAX_TOL * gap["logit_scale"]
                and gap["rms_err"] <= LOGIT_RMS_TOL * gap["logit_scale"]):
            raise AssertionError(f"fsdp {tag} serve rank {r['rank']}: prefill logits "
                                 f"against one card {gap}")
        row = {"rank": r["rank"], "rows": r["rows"], "launches": got,
               "serve_wall_s": r["serve_wall_s"], "collectives": r["collectives"],
               "prefill_logits_vs_one_card": gap, "token_agreement_vs_one_card": agree,
               "peak_memory_gb": r["peak_memory_gb"]}
        if r["k5"] is not None:
            x = r["k5"]
            h, h_last = lru_ops.rglru(x["a"].cuda(), x["b"].cuda(), x["h0"].cuda())
            row["k5_bitwise_one_card"] = bool(torch.equal(h.cpu(), x["h"])
                                              and torch.equal(h_last.cpu(), x["h_last"]))
            if not row["k5_bitwise_one_card"]:
                raise AssertionError(f"fsdp {tag} rank {r['rank']}: K5 on one card differs "
                                     "from K5 on the rank's rows")
            c = k5[0]
            row["k5_path_inputs_bitwise"] = all(torch.equal(c[k], x[k]) for k in ("a", "b", "h0"))
            row["k5_path_output_bitwise"] = bool(torch.equal(c["h"], x["h"]))
        fsdp_gathers(tag, r["embed"], dict(zip(("data", "model"), run["mesh"])),
                     r["collectives"], backward=False)
        log(f"fsdp {tag} serve rank {r['rank']}: " + json.dumps(row, default=float))
        out.append(row)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    return {"ranks": out}


def fsdp_train_check(torch, tag, run, ranks) -> dict:
    """Each rank's training: the layout, the first batch's loss falling, the
    FSDP gathers and reduce-scatters counted; the meshed gradient at the
    training gates against one card's (and, under fsdp_sp, the dense
    logits against one card's)."""
    import numpy as np

    from repro_torch.nn.module import init_params

    for r in ranks:
        if r["layout"] != run["layout"]:
            raise AssertionError(f"fsdp {tag} rank {r['rank']}: layout {r['layout']}")
        before, after = r["first_batch_loss"]
        if not (np.isfinite(r["losses"]).all() and after < before):
            raise AssertionError(f"fsdp {tag} rank {r['rank']}: the first batch's loss did "
                                 f"not fall: {before} -> {after}")
        fsdp_gathers(tag, r["rules"].get("embed"), r["mesh"], r["collectives_per_run"],
                     backward=True)
        log(f"fsdp {tag} train rank {r['rank']}: losses {r['losses']}, first batch "
            f"{before} -> {after}, {r['step_s']} s a step, {r['profile']}, resident "
            f"{r['resident']}, peak {r['peak_memory_gb']} GB")
    one = fsdp_trainer(torch, run, None)
    params = init_params(one.woven.program.model, 0, one.woven.state.policies, "cuda")
    mb = first_batch(torch, one)
    loss, norm, attn = gradient_digest(torch, one.woven, params, mb,
                                       stack_names(one.woven), run["match"])
    want = (loss, norm, {k: g.cpu() for k, g in attn.items()})
    del attn
    out = {"ranks": [{k: v for k, v in r.items() if k not in ("digest", "logits")}
                     for r in ranks]}
    out["gradient_vs_one_card"] = compare_gradients(
        f"fsdp-{tag}-train", ranks[0]["digest"], want, len(want[2]),
        gated=run.get("gated", True), labels=("mesh", "one_card"))
    if run["layout"] == "fsdp_sp":
        with torch.no_grad():
            x, _ = one.woven.program.model(params, {"tokens": mb["tokens"][:1]},
                                           ctx=one.woven.state.make_ctx(), mode="dense")
        x = x[0, fsdp_logit_positions(mb["tokens"].shape[1])].float().cpu()
        gaps = []
        for r in ranks:
            gap = logit_diff(torch, f"fsdp {tag} rank {r['rank']} logits", r["logits"], x)
            if not (gap["max_abs_err"] <= LOGIT_MAX_TOL * gap["logit_scale"]
                    and gap["rms_err"] <= LOGIT_RMS_TOL * gap["logit_scale"]):
                raise AssertionError(f"fsdp {tag} rank {r['rank']}: logits against one "
                                     f"card {gap}")
            gaps.append(gap)
        out["logits_vs_one_card"] = gaps
        log(f"fsdp {tag} logits vs one card: {gaps}")
    del one, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fsdp_checks(torch, fsdp_runs, res) -> dict:
    """The FSDP runs' one-card references, built after the ranks have gone,
    and their gates: {"fsdp_<tag>": summary}."""
    out = {}
    for tag, run in dict(fsdp_runs).items():
        t1 = time.perf_counter()
        got = res[tag]
        out[f"fsdp_{tag}"] = {
            "arch": run["arch"], "layers": run["layers"], "mesh": list(run["mesh"]),
            "layout": run["layout"], "rules": run["rules"], "ranks_wall_s": got["rank0_wall_s"],
            **({"serve": fsdp_serve_check(torch, tag, run, got["serve"])}
               if "serve" in got else {}),
            "train": fsdp_train_check(torch, tag, run, got["train"])}
        out[f"fsdp_{tag}"]["one_card_s"] = time.perf_counter() - t1
    return out


# ---------------------------------------------------------------------------
# phase 12, (g1)-(g3): the MoE, encoder-decoder and VLM families on the mesh
# ---------------------------------------------------------------------------

# Each at published width on the same two ranks, (1, 2), under AutoShard's
# own `megatron_tp` (every head count divides 2; whisper-small's 51865-row
# and internvl2-1b's 151655-row vocabularies do not, and stay whole on each
# rank): (g1) mixtral-8x22b cut to 1 of 56 layers (2.906 B parameters, 5.8
# GB in bf16; AutoShard keeps `embed` whole at that depth), two prompts past
# its 4096-token window through `serve_continuous` (a paged ring pool);
# (g2) whisper-small at full depth, two clips of 1500 stub frames and a
# 4-token prompt through `serve`; (g3) internvl2-1b at full depth, two
# requests of 256 image embeddings and 256 tokens through `serve`.  Each
# trains `FAMILY_MESH_TRAIN["steps"]` steps of 2 x 512 tokens (whisper 2 x
# 448 beside 1500 frames, through `build_train_step`).  `gate`: the policy
# the prefill logits are held to one card's in — fp32 for mixtral (whose
# bf16 routing parts from one card's where two gates nearly tie) and for
# internvl's image prefix, as on one card (`FRONTEND_RUNS`).
FAMILY_MESH_RUNS = {
    "g1": dict(arch="mixtral-8x22b", layers=1, lens=[4500, 5000], max_len=6144,
               gate="double", attn=1, attn_weights=4),
    "g2": dict(arch="whisper-small", layers=None, batch=2, stub=1500, prompt=4,
               max_len=448, seq=448, gate="half", attn=24, attn_weights=12),
    "g3": dict(arch="internvl2-1b", layers=None, batch=2, stub=256, prompt=256,
               max_len=1024, gate="double", attn=24, attn_weights=7),
}
FAMILY_MESH_DECODE = 8
FAMILY_MESH_TRAIN = {"batch": 2, "seq": 512, "steps": 2, "lr": 1e-3}


def family_mesh_program(run, kind: str):
    from repro_torch.core.program import Program
    from repro_torch.models.registry import build_model, get_config

    cfg = get_config(run["arch"])
    if run["layers"] is not None:
        cfg = cfg.replace(num_layers=run["layers"], layer_groups=())
    return Program(model=build_model(cfg), cfg=cfg, kind=kind, device="cuda")


def family_mesh_server(torch, run, mesh, policy: str = "half", layout: str | None = None):
    """The run's server at `policy`, woven as `launch/serve` weaves a server
    (`weave_server`: the CUDA kernels, and on a live mesh AutoShard's
    `layout` where it is forced; one card has none), on `mesh` (None: one
    card), random weights from seed 0 (a rank's blocks are slices of one
    card's)."""
    from repro_torch.launch.serve import weave_server
    from repro_torch.nn.dtypes import PolicyResolver
    from repro_torch.runtime.server import Server, ServerConfig

    woven = weave_server(family_mesh_program(run, "serve"), mesh=mesh,
                         layout=layout if mesh is not None else None)
    woven.state.policies = PolicyResolver.default(policy)
    return Server(woven, ServerConfig(max_cache_len=run["max_len"],
                                      decode_tokens=run.get("decode", FAMILY_MESH_DECODE),
                                      seed=0), mesh=mesh)


def family_mesh_traffic(cfg, run) -> dict:
    """The run's requests from seed 30: the MoE family's prompts; the
    others' token rows with their frames or image embeddings (fp32)."""
    import numpy as np

    rng = np.random.default_rng(30)
    if cfg.family == "moe":
        return {"prompts": [rng.integers(0, cfg.vocab, n).astype(np.int64)
                            for n in run["lens"]]}
    side = "frames" if cfg.family == "encdec" else "embeds"
    return {"tokens": rng.integers(0, cfg.vocab, (run["batch"], run["prompt"]),
                                   dtype=np.int32),
            side: rng.standard_normal((run["batch"], run["stub"], cfg.d_model),
                                      dtype=np.float32)}


def family_mesh_serve(torch, server, tag, traffic) -> tuple:
    """One counted serve of the traffic: the MoE family's prompts through
    `serve_continuous` (`check_paged_run`'s gates: every outcome ok, the
    launches the server's own step counts give; a ring pool of at most
    4096 / 128 pages a request, no page shared); the others' rows through
    `serve` with their frames or image embeddings, the launches gated at
    the count their layers give.  Returns (tokens, launches with routes,
    wall)."""
    cfg = server.woven.program.cfg
    n = FAMILY_MESH_DECODE
    if cfg.family == "moe":
        prompts = traffic["prompts"]
        out, wall, counts, routes = counted_serve(torch, lambda: server.serve_continuous(
            prompts, max_batch=len(prompts), page_size=FAMILY_PAGE))
        check_paged_run(server, "mesh", f"{tag} serve", prompts, out, counts, routes, False)
        pool = server.last_pool_stats
        ring = len(prompts) * -(-cfg.attn_window // FAMILY_PAGE)
        if pool["prefix_hits"] or pool["cow_splits"] or not pool["peak_live_pages"] <= ring:
            raise AssertionError(f"mesh {tag} serve: not a ring pool of {ring} pages: {pool}")
        return [o.tolist() for o in out], {**counts, **routes}, wall
    side = {k: v for k, v in traffic.items() if k != "tokens"}
    t0 = time.perf_counter()
    out, counts, routes = counted_run(
        torch, lambda: server.serve(traffic["tokens"], inputs=side), f"mesh {tag} serve")
    wall = time.perf_counter() - t0
    encdec, L = cfg.family == "encdec", cfg.num_layers
    norms = 0 if cfg.norm_type == "layernorm" else 2 * L + 1
    want = {"flash_attention": L + (cfg.enc_layers if encdec else 0),
            "flash_decode": (2 if encdec else 1) * L * n, "rmsnorm": norms * (1 + n),
            "flash_attention_bwd": 0, "flash_attention_lse": 0, "rglru": 0, "wkv": 0}
    if counts != want:
        raise AssertionError(f"mesh {tag} serve: launches {counts} != {want}")
    if out.shape != (traffic["tokens"].shape[0], n) or out.min() < 0 or out.max() >= cfg.vocab:
        raise AssertionError(f"mesh {tag} serve: tokens of the wrong shape or range")
    return out.tolist(), {**counts, **routes}, wall


def family_mesh_feed(torch, cfg, traffic, dtype) -> dict:
    """The prefill inputs of the traffic's first request (MoE) or rows, on
    the card, the frames or image embeddings in `dtype`."""
    if cfg.family == "moe":
        return {"tokens": torch.as_tensor(traffic["prompts"][0][None].astype("int32"),
                                          device="cuda")}
    return {k: torch.as_tensor(v, device="cuda").to(torch.int32 if k == "tokens" else dtype)
            for k, v in traffic.items()}


def family_mesh_prefill(torch, server, feed) -> tuple:
    """The prefill logits of `feed` on the server's program (fp32 on the
    host) and its MoE routings in call order (`RouteRecorder`)."""
    from repro_torch.runtime.steps import build_prefill_step

    step = build_prefill_step(server.woven, mesh=server.mesh,
                              cache_max_len=server.cfg.max_cache_len)
    with RouteRecorder() as rec, torch.no_grad():
        logits, cache = step(server.params, feed)
    del cache
    return logits.float().cpu(), rec.calls


def cross_cache_unwritten(torch, server, feed) -> dict:
    """An encoder-decoder's prefill, then two decode steps: the cross caches
    come back as the same tensors, their bytes unchanged."""
    from repro_torch.runtime.steps import build_decode_step, build_prefill_step

    logits, cache = build_prefill_step(server.woven, mesh=server.mesh,
                                       cache_max_len=server.cfg.max_cache_len)(
        server.params, feed)
    cross = cache["decoder"]["cross"]
    ptr = {k: cross[k].data_ptr() for k in ("ck", "cv")}
    before = {k: cross[k].double().sum().item() for k in ("ck", "cv")}
    decode = build_decode_step(server.woven, mesh=server.mesh)
    pos = feed["tokens"].shape[1]
    for i in range(2):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        logits, cache = decode(server.params, {"tokens": tok,
                                               "positions": torch.full_like(tok, pos + i)},
                               cache)
    cross = cache["decoder"]["cross"]
    out = {"same_tensors": all(cross[k].data_ptr() == ptr[k] for k in ptr),
           "bytes_unchanged": {k: cross[k].double().sum().item() for k in ptr} == before,
           "kv_heads": int(cross["ck"].shape[-2])}
    if not (out["same_tensors"] and out["bytes_unchanged"]):
        raise AssertionError(f"the cross cache was written: {out}")
    return out


def family_mesh_stepper(torch, run, mesh, aspects=()) -> dict:
    """The run's training at published width (its depth cut as it says), bf16
    (`half`), remat `full`, on `mesh` (None: one card), laid out by
    AutoShard and then `aspects`, random weights from seed 0: through the
    launcher's `program_trainer` (a `Trainer`), or for the encoder-decoder
    and a run with `image` set through `runtime/steps.build_train_step`
    with frames (image embeddings) from a seed beside the token pipeline's
    batches.  {"woven", "step" (one step; the first builds the train step),
    "params" (), "opt" (), "batch0" (the first global batch, on the
    card)}."""
    from functools import partial

    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import is_live
    from repro_torch.launch.train import program_trainer
    from repro_torch.launch.weave import default_weave, train_kernel_aspects
    from repro_torch.nn.module import init_params
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.steps import build_train_step
    from repro_torch.runtime.trainer import TrainerConfig

    t = FAMILY_MESH_TRAIN
    program = family_mesh_program(run, "train")
    cfg = program.cfg
    B, S = t["batch"], run.get("seq", t["seq"])
    overrides = {"accum_steps": 1, "remat": "full", "precision": "half"}
    lr = partial(constant, peak=t["lr"])
    if cfg.family != "encdec" and not run.get("image"):
        trainer = program_trainer(program, batch=B, seq=S, mesh=mesh, overrides=overrides,
                                  tcfg=TrainerConfig(steps=99, log_every=0, seed=0),
                                  lr_fn=lr, extra_aspects=list(aspects))
        trainer.init_state()
        return {"woven": trainer.woven, "step": lambda: trainer.run(1)[-1],
                "params": lambda: trainer.params, "opt": lambda: trainer.opt_state,
                "batch0": first_batch(torch, trainer)}
    axes = dict(mesh.shape) if mesh is not None else {}
    woven = default_weave(program, SHAPES["train_4k"], axes, overrides=dict(overrides),
                          extra_aspects=train_kernel_aspects() + list(aspects))
    shardings = param_shardings(program.model, mesh, woven.state.rules) \
        if is_live(mesh) else None
    state = {"params": init_params(program.model, 0, woven.state.policies, "cuda",
                                   shardings=shardings), "i": 0, "step": None}
    state["opt"] = adamw.init_state(state["params"], adamw.AdamWConfig())

    def batch_at(i):
        return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                for k, v in family_train_batch(torch, run, cfg, i).items()}

    def step():
        if state["step"] is None:
            state["step"] = build_train_step(woven, mesh=mesh, lr_fn=lr)
        state["params"], state["opt"], m = state["step"](state["params"], state["opt"],
                                                         batch_at(state["i"]), state["i"])
        state["i"] += 1
        return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}

    return {"woven": woven, "step": step, "params": lambda: state["params"],
            "opt": lambda: state["opt"], "batch0": batch_at(0)}


def family_train_batch(torch, run, cfg, i: int) -> dict:
    """The run's global batch `i` on the card: the token pipeline's batch at
    the run's sequence length (`FAMILY_MESH_TRAIN`'s batch) and, for the
    encoder-decoder and a run with `image` set, its frames or image
    embeddings from seed [30, i] (fp32)."""
    import numpy as np

    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    B = FAMILY_MESH_TRAIN["batch"]
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, global_batch=B,
                                        seq_len=run.get("seq", FAMILY_MESH_TRAIN["seq"])))
    batch = {k: torch.as_tensor(v).to("cuda") for k, v in pipe.batch_at(i).items()}
    if cfg.family == "encdec" or run.get("image"):
        stub = np.random.default_rng([30, i]).standard_normal(
            (B, run["stub"], cfg.d_model), dtype=np.float32)
        batch["frames" if cfg.family == "encdec" else "embeds"] = torch.as_tensor(
            stub, device="cuda")
    return batch


def family_mesh_train_rank(torch, mesh, tag, run) -> dict:
    """The run trained on this rank: counted steps (the first recording its
    gradient's digest through the train step's gradient mean), the first
    batch's loss again after them."""
    from repro_torch.distributed.sharding import input_shardings, local_shard
    from repro_torch.runtime.steps import build_loss_fn, build_mesh_mean

    st = family_mesh_stepper(torch, run, mesh)
    woven, mb = st["woven"], st["batch0"]
    n = run["attn"]
    want = {"flash_attention": 2 * n, "flash_attention_lse": 2 * n,
            "flash_attention_bwd": n, "flash_decode": 0, "rmsnorm": 0, "rglru": 0, "wkv": 0}
    step_s, digest, history = [], [], []
    for i in range(FAMILY_MESH_TRAIN["steps"]):
        t0 = time.perf_counter()
        with step_digest(torch, "attn/", digest) if i == 0 else contextlib.nullcontext():
            m, counts, routes = counted_run(torch, st["step"], f"mesh {tag} step {i + 1}")
        step_s.append(time.perf_counter() - t0)
        history.append(m)
        if counts != want:
            raise AssertionError(f"mesh {tag} step {i + 1}: launches {counts} != {want}")
    shard = input_shardings(mb, mesh, woven.state.rules)
    with torch.no_grad():
        after, _ = build_loss_fn(woven, mesh)(
            st["params"](), {k: local_shard(v, shard[k]) for k, v in mb.items()})
    after = build_mesh_mean(woven, mesh)[1]({}, {"loss": after})[1]["loss"].item()
    return {"rank": mesh.rank, "layout": woven.state.extra.get("layout"),
            "losses": [h["loss"] for h in history], "first_batch_loss": [digest[0][0], after],
            "step_s": step_s, "launches_per_step": counts, "routes_per_step": routes,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "digest": digest[0]}


def family_mesh_rank(torch, mesh, tag, run) -> dict:
    """(g1)..(g3) on this rank: the counted serve, the prefill logits and
    routings at the gate's policy (and at the serving policy's, for the
    routing), the cross caches left unwritten, the counted training; each
    rank's results on every rank."""
    from repro_torch.distributed import collectives

    t0 = time.perf_counter()
    server = family_mesh_server(torch, run, mesh)
    cfg = server.woven.program.cfg
    traffic = family_mesh_traffic(cfg, run)
    collectives.reset_counts()
    tokens, counts, wall = family_mesh_serve(torch, server, tag, traffic)
    colls = collectives.counts()
    rank_log(mesh, f"mesh {tag}: served in {wall:.2f} s")
    feed = family_mesh_feed(torch, cfg, traffic, torch.bfloat16)
    logits_bf16, routes_bf16 = family_mesh_prefill(torch, server, feed)
    cross = cross_cache_unwritten(torch, server, feed) if cfg.family == "encdec" else None
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    del server
    gc.collect()
    torch.cuda.empty_cache()
    logits, routes = logits_bf16, routes_bf16
    if run["gate"] != "half":
        gate_srv = family_mesh_server(torch, run, mesh, run["gate"])
        logits, routes = family_mesh_prefill(
            torch, gate_srv, family_mesh_feed(torch, cfg, traffic, torch.float32))
        del gate_srv
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train = family_mesh_train_rank(torch, mesh, tag, run)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": mesh.rank, "tokens": tokens, "launches": counts, "serve_wall_s": wall,
           "collectives": colls, "serve_peak_memory_gb": serve_peak, "cross_cache": cross,
           "logits_gate": logits, "logits_bf16": logits_bf16, "routing_gate": routes,
           "routing_bf16": routes_bf16, "train": train,
           "wall_s": time.perf_counter() - t0, "digest": train.pop("digest")}
    ranks = rank0_digest(out, mesh)
    ranks[mesh.rank]["train"]["digest"] = ranks[mesh.rank].pop("digest")
    return ranks


def routing_share(got: list, want: list) -> dict:
    """How many (grouped) tokens were routed to another set of experts in
    `got` than in `want` (routings in call order: one a MoE layer)."""
    differ = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                 for a, b in zip(got, want))
    total = sum(int(a[..., 0].numel()) for a in want)
    return {"tokens_routed_differently": differ, "routings_compared": total,
            "share": differ / total if total else None}


def family_mesh_check(torch, tag, run, ranks) -> dict:
    """The run's one-card references, built after the ranks have gone, and
    its gates: each rank's launches by route equal one card's on the same
    traffic; the ranks' routings identical, bit for bit (the share of
    tokens one card routes elsewhere printed, at both policies); the
    prefill logits at the logit gate against one card's, at the run's gate
    policy; the cross caches unwritten; each rank's training: the layout,
    the first batch's loss falling, its gradient at the training gates
    against one card's."""
    import numpy as np

    t0 = time.perf_counter()
    for r in ranks[1:]:
        for key in ("routing_gate", "routing_bf16"):
            if len(r[key]) != len(ranks[0][key]) or not all(
                    torch.equal(a, b) for a, b in zip(r[key], ranks[0][key])):
                raise AssertionError(f"mesh {tag}: rank {r['rank']} routes otherwise than "
                                     f"rank 0 ({key})")
    one = family_mesh_server(torch, run, None)
    cfg = one.woven.program.cfg
    traffic = family_mesh_traffic(cfg, run)
    tokens, counts, wall = family_mesh_serve(torch, one, f"{tag} one card", traffic)
    feed = family_mesh_feed(torch, cfg, traffic, torch.bfloat16)
    logits_bf16, routes_bf16 = family_mesh_prefill(torch, one, feed)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    logits, routes = logits_bf16, routes_bf16
    if run["gate"] != "half":
        gate_srv = family_mesh_server(torch, run, None, run["gate"])
        logits, routes = family_mesh_prefill(
            torch, gate_srv, family_mesh_feed(torch, cfg, traffic, torch.float32))
        del gate_srv
        gc.collect()
        torch.cuda.empty_cache()
    out = {"arch": run["arch"], "layers": cfg.num_layers, "one_card_serve_wall_s": wall,
           "ranks": []}
    for r in ranks:
        if r["launches"] != counts:
            raise AssertionError(f"mesh {tag} rank {r['rank']}: launches by route "
                                 f"{r['launches']} != one card's {counts}")
        if not r["collectives"].get("all_reduce", {}).get("model", {}).get("calls"):
            raise AssertionError(f"mesh {tag} rank {r['rank']}: no all-reduce over model")
        gap = logit_diff(torch, f"mesh {tag} rank {r['rank']}", r["logits_gate"], logits)
        if not (gap["max_abs_err"] <= LOGIT_MAX_TOL * gap["logit_scale"]
                and gap["rms_err"] <= LOGIT_RMS_TOL * gap["logit_scale"]):
            raise AssertionError(f"mesh {tag} rank {r['rank']}: prefill logits ({run['gate']}) "
                                 f"against one card {gap}")
        agree = float(np.mean([np.mean(np.asarray(a) == np.asarray(b))
                               for a, b in zip(r["tokens"], tokens)]))
        row = {"rank": r["rank"], "launches": r["launches"], "serve_wall_s": r["serve_wall_s"],
               "serve_peak_memory_gb": r["serve_peak_memory_gb"],
               "collectives": r["collectives"], "cross_cache": r["cross_cache"],
               f"prefill_logits_vs_one_card_{run['gate']}": gap,
               "prefill_logits_vs_one_card_bf16": logit_diff(
                   torch, f"mesh {tag} bf16", r["logits_bf16"], logits_bf16),
               "token_agreement_vs_one_card": agree, "wall_s": r["wall_s"]}
        if routes:
            row["routing_vs_one_card"] = {run["gate"]: routing_share(r["routing_gate"], routes),
                                          "half": routing_share(r["routing_bf16"], routes_bf16)}
        out["ranks"].append(row)
        log(f"mesh {tag} serve rank {r['rank']}: " + json.dumps(row, default=float))
    if ranks[0]["cross_cache"] is not None and ranks[0]["cross_cache"]["kv_heads"] * 2 \
            != cfg.kv_heads:
        raise AssertionError(f"mesh {tag}: a rank's cross cache holds "
                             f"{ranks[0]['cross_cache']['kv_heads']} of {cfg.kv_heads} heads")
    trains = [r["train"] for r in ranks]
    for t in trains:
        before, after = t["first_batch_loss"]
        if t["layout"] != "megatron_tp" or not (np.isfinite(t["losses"]).all()
                                                and after < before):
            raise AssertionError(f"mesh {tag} train rank {t['rank']}: layout {t['layout']}, "
                                 f"the first batch's loss {before} -> {after}")
        log(f"mesh {tag} train rank {t['rank']}: losses {t['losses']}, first batch "
            f"{before} -> {after}, {t['step_s']} s a step, peak {t['peak_memory_gb']} GB")
    st = family_mesh_stepper(torch, run, None)
    loss, norm, attn = gradient_digest(torch, st["woven"], st["params"](), st["batch0"],
                                       stack_names(st["woven"]))
    want = (loss, norm, {k: g.cpu() for k, g in attn.items()})
    del st, attn
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = {"ranks": [{k: v for k, v in t.items() if k != "digest"} for t in trains],
                    "gradient_vs_one_card": compare_gradients(
                        f"mesh-{tag}-train", trains[0]["digest"], want, run["attn_weights"],
                        labels=("mesh", "one_card"))}
    out["one_card_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 12, (p1)-(p3): the MoE, encoder-decoder and VLM families trained
# under fsdp_sp
# ---------------------------------------------------------------------------

# Each at published width on the same two ranks, (1, 2), under `fsdp_sp`
# forced through AutoShard's `layout=` (as (f4) forces it): each rank holds
# its block of the sequence — internvl2-1b's image prefix and tokens
# together, whisper-small's frames and its tokens — and runs K1 (with its
# lse) and K3 on the gathered sequence; whisper-small's 51865-row and
# internvl2-1b's 151655-row vocabularies do not split over the axis and
# stay whole on each rank, mixtral-8x22b's head (its `embed` dim FSDP over
# `(data, model)`, AutoShard's own rule at this depth) too, while its table
# splits its 32768 rows.  (p1) internvl2-1b at full depth, 2 x (256 image
# embeddings + 256 tokens); (p2) whisper-small at full depth, 2 x 448
# tokens over 1500 frames; both through `build_train_step` with their side
# inputs from a seed, two counted steps; (p3) mixtral-8x22b at 1 of 56
# layers, 2 x 512 tokens through the launcher's `Trainer`, one counted step
# (every weight crosses the host at ~0.5 GB/s a rank).  The first batch's
# dense logits are held at `gate`'s policy (fp32 for internvl's image
# prefix and for mixtral, whose bf16 routing parts from one card's where
# two gates nearly tie), with RMSNorm's kernel woven in beside K1 (a
# forward without a gradient); `attn_weights`: the attention weights a
# gradient digest holds, as in (g1)-(g3).
FAMILY_SP_RUNS = {
    "p1": dict(arch="internvl2-1b", layers=None, image=True, stub=256, seq=256, steps=2,
               gate="double", attn=24, attn_weights=7),
    "p2": dict(arch="whisper-small", layers=None, stub=1500, seq=448, steps=2,
               gate="half", attn=24, attn_weights=12),
    "p3": dict(arch="mixtral-8x22b", layers=1, seq=512, steps=1, gate="double",
               attn=1, attn_weights=4),
}
FAMILY_SP_ASPECTS = {"layout": "fsdp_sp", "rules": None}  # `fsdp_aspects`' reading


def family_sp_logits(torch, run, mesh) -> dict:
    """The first batch's dense logits of the run at its gate policy on
    `mesh` (None: one card), from seed 0, with every forward kernel woven
    (K1, and K4 where the model has RMSNorm): the logits of the first row
    at each sequence block's ends (`fsdp_logit_positions`), the launches
    by route (`counted_serve`: no plain version), and the MoE layers' top-k
    experts and keep masks in call order."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.strategies.kernels import KernelAspect
    from repro_torch.distributed.sharding import (input_shardings, local_shard,
                                                  param_shardings, seq_axis)
    from repro_torch.launch.mesh import is_live
    from repro_torch.launch.weave import default_weave, train_kernel_aspects
    from repro_torch.models.lm import whole_logits
    from repro_torch.nn.dtypes import PolicyResolver
    from repro_torch.nn.module import init_params

    axes = dict(mesh.shape) if mesh is not None else {}
    program = family_mesh_program(run, "train")
    cfg = program.cfg
    woven = default_weave(program, SHAPES["train_4k"], axes,
                          overrides={"accum_steps": 1, "remat": "full"},
                          extra_aspects=train_kernel_aspects()
                          + [KernelAspect("*", "norm", "cuda")]
                          + fsdp_aspects(FAMILY_SP_ASPECTS, axes, True))
    woven.state.policies = PolicyResolver.default(run["gate"])
    shardings = param_shardings(program.model, mesh, woven.state.rules) \
        if is_live(mesh) else None
    params = init_params(program.model, 0, woven.state.policies, "cuda",
                         shardings=shardings)
    feed = family_train_batch(torch, run, cfg, 0)
    dtype = torch.float32 if run["gate"] != "half" else torch.bfloat16
    feed = {k: v.to(dtype) if v.is_floating_point() else v for k, v in feed.items()
            if k != "labels"}
    if is_live(mesh):
        shard = input_shardings(feed, mesh, woven.state.rules)
        feed = {k: local_shard(v, shard[k]) for k, v in feed.items()}
    with RouteRecorder() as rec, torch.no_grad():
        x, wall, counts, routes = counted_serve(torch, lambda: program.model(
            params, feed, ctx=woven.state.make_ctx(mesh=mesh), mode="dense")[0])
        if is_live(mesh):
            x = whole_logits(x, mesh, cfg.vocab, seq_axis(mesh, woven.state.rules))
    logits = x[0, fsdp_logit_positions(x.shape[1])].float().cpu()
    del x, params
    return {"logits": logits, "launches": {**counts, **routes}, "wall_s": wall,
            "routing": rec.calls, "keep": rec.keeps}


def family_sp_rank(torch, mesh, tag, run) -> dict:
    """(p1)..(p3) on this rank: the first batch's dense logits at the gate's
    policy (`family_sp_logits`), then `run["steps"]` counted steps (the
    first recording its gradient's digest through the train step's gradient
    mean), the first batch's loss again after them, the collectives of the
    steps and the rank's resident state; each rank's results on every
    rank."""
    from types import SimpleNamespace

    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import input_shardings, local_shard
    from repro_torch.runtime.steps import build_loss_fn, build_mesh_mean

    t0 = time.perf_counter()
    dense = family_sp_logits(torch, run, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    rank_log(mesh, f"mesh {tag}: dense logits in {dense['wall_s']:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    st = family_mesh_stepper(torch, run, mesh,
                             fsdp_aspects(FAMILY_SP_ASPECTS, dict(mesh.shape), True))
    woven, mb = st["woven"], st["batch0"]
    n = run["attn"]
    want = {"flash_attention": 2 * n, "flash_attention_lse": 2 * n,
            "flash_attention_bwd": n, "flash_decode": 0, "rmsnorm": 0, "rglru": 0, "wkv": 0}
    collectives.reset_counts()
    step_s, digest, history = [], [], []
    for i in range(run["steps"]):
        t1 = time.perf_counter()
        with step_digest(torch, "attn/", digest) if i == 0 else contextlib.nullcontext():
            m, counts, routes = counted_run(torch, st["step"], f"mesh {tag} step {i + 1}")
        step_s.append(time.perf_counter() - t1)
        history.append(m)
        rank_log(mesh, f"mesh {tag}: step {i + 1} in {step_s[-1]:.2f} s")
        if counts != want:
            raise AssertionError(f"mesh {tag} step {i + 1}: launches {counts} != {want}")
    colls = collectives.counts()
    shard = input_shardings(mb, mesh, woven.state.rules)
    with torch.no_grad():
        after, _ = build_loss_fn(woven, mesh)(
            st["params"](), {k: local_shard(v, shard[k]) for k, v in mb.items()})
    after = build_mesh_mean(woven, mesh)[1]({}, {"loss": after})[1]["loss"].item()
    resident = resident_check(torch, tag, SimpleNamespace(
        woven=woven, mesh=mesh, params=st["params"](), opt_state=st["opt"]()))
    train = {"rank": mesh.rank, "layout": woven.state.extra.get("layout"),
             "rules": {k: v for k, v in woven.state.rules.items()
                       if k in ("batch", "embed", "vocab", "res_seq", "heads", "mlp")},
             "losses": [h["loss"] for h in history], "first_batch_loss": [digest[0][0], after],
             "step_s": step_s, "launches_per_step": counts, "routes_per_step": routes,
             "collectives_per_run": colls, "resident": resident,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del st, woven
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"rank": mesh.rank, "dense": dense, "train": train, "digest": digest[0],
           "wall_s": time.perf_counter() - t0}
    return rank0_digest(out, mesh)


def family_sp_check(torch, tag, run, ranks) -> dict:
    """The run's one-card references, built after the ranks have gone, and
    its gates: each rank's dense-logit launches by route equal one card's
    on the same batch, its logits at the logit gate against one card's (at
    the gate's policy), MoE keep masks bit for bit one card's and alike on
    both ranks; each rank's training: the layout, the launches (K1 twice an
    attention layer and step, with its lse, K3 once: one card's on the
    gathered sequence), the first batch's loss falling, the sequence's
    gathers and (FSDP) the weights' gathers and reduce-scatters counted,
    its resident blocks, and the meshed gradient at the training gates
    against one card's."""
    import numpy as np

    t0 = time.perf_counter()
    one = family_sp_logits(torch, run, None)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": run["arch"], "layers": run["layers"], "ranks": []}
    for r in ranks:
        d, t = r["dense"], r["train"]
        if d["launches"] != one["launches"]:
            raise AssertionError(f"mesh {tag} rank {r['rank']}: dense-logit launches by route "
                                 f"{d['launches']} != one card's {one['launches']}")
        gap = logit_diff(torch, f"mesh {tag} rank {r['rank']}", d["logits"], one["logits"])
        if not (gap["max_abs_err"] <= LOGIT_MAX_TOL * gap["logit_scale"]
                and gap["rms_err"] <= LOGIT_RMS_TOL * gap["logit_scale"]):
            raise AssertionError(f"mesh {tag} rank {r['rank']}: logits ({run['gate']}) "
                                 f"against one card {gap}")
        keep = None
        if one["keep"]:
            same = len(d["keep"]) == len(one["keep"]) and all(
                torch.equal(a, b) for a, b in zip(d["keep"], one["keep"]))
            alike = all(torch.equal(a, b) for a, b in zip(d["keep"], ranks[0]["dense"]["keep"]))
            keep = {"bitwise_one_card": same, "bitwise_rank0": alike,
                    "kept": [float(k.float().mean()) for k in d["keep"]],
                    "routing_vs_one_card": routing_share(d["routing"], one["routing"])}
            if not (same and alike):
                raise AssertionError(f"mesh {tag} rank {r['rank']}: keep masks {keep}")
        before, after = t["first_batch_loss"]
        if t["layout"] != "fsdp_sp" or not (np.isfinite(t["losses"]).all() and after < before):
            raise AssertionError(f"mesh {tag} train rank {r['rank']}: layout {t['layout']}, "
                                 f"the first batch's loss {before} -> {after}")
        colls = t["collectives_per_run"]
        for kind in ("all_gather", "all_reduce"):
            if not colls.get(kind, {}).get("model", {}).get("calls"):
                raise AssertionError(f"mesh {tag} rank {r['rank']}: no {kind} over model")
        if t["rules"].get("embed"):
            fsdp_gathers(tag, t["rules"]["embed"], {"data": 1, "model": 2}, colls,
                         backward=True)
        row = {"rank": r["rank"], "dense_launches": d["launches"],
               "dense_wall_s": d["wall_s"], f"logits_vs_one_card_{run['gate']}": gap,
               "keep": keep, "wall_s": r["wall_s"],
               "train": {k: v for k, v in t.items() if k != "rank"}}
        out["ranks"].append(row)
        log(f"mesh {tag} rank {r['rank']}: " + json.dumps(row, default=float))
    st = family_mesh_stepper(torch, run, None, fsdp_aspects(FAMILY_SP_ASPECTS, {}, True))
    loss, norm, attn = gradient_digest(torch, st["woven"], st["params"](), st["batch0"],
                                       stack_names(st["woven"]))
    want = (loss, norm, {k: g.cpu() for k, g in attn.items()})
    del st, attn
    gc.collect()
    torch.cuda.empty_cache()
    out["gradient_vs_one_card"] = compare_gradients(
        f"mesh-{tag}-train", ranks[0]["digest"], want, run["attn_weights"],
        labels=("mesh", "one_card"))
    out["one_card_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 12, (s1)-(s4): serving under fsdp_sp
# ---------------------------------------------------------------------------

# Each on the same two ranks, (1, 2), under `fsdp_sp` forced through
# AutoShard's `layout=`: every rank holds its share of every KV cache and
# page pool (`sharding.seq_share`: a dense cache's half of the slots, half
# the slots of every page of 128), a decode step's token is whole on both
# ranks, K2's block mode attends each rank's share and returns its lse, and
# the ranks' partials are merged (`collectives.combine_attention`).  (s1)
# gemma-2b at 4 of 18 layers, full width: the continuous traffic of step 6
# (ten requests over a page-128 pool, eight sharing a 1024-token prefix)
# with chunked prefill in bf16, the same without chunks at 2 layers in
# fp32, over the int8 pool plain and self-drafted at k = 2, and a
# `serve_batch` of a 1024- and a 1023-token prompt (the axis divides the
# first, not the second: that prefill runs whole on both ranks), with
# `SERVE_SP_DECODE` tokens a request; (s2) whisper-small at full depth, two
# clips of 1500 frames through `serve` (cross caches of 750 frames a rank);
# (s3) internvl2-1b at full depth, two requests of 256 image embeddings +
# 256 tokens; (s4) mixtral-8x22b at 1 of 56 layers, two prompts past its
# window through `serve_continuous` (a ring pool split over the ranks).
# (s2)-(s4) serve (g2), (g3) and (g1)'s traffic, from the same weights;
# (s3) and (s4)'s logits are held in fp32 (their gate policy), within
# `FP32_SERVE_TOL` of the scale as (s1)'s fp32 run is.
SERVE_SP_DECODE = 8
SERVE_SP_RUNS = {
    "s1": dict(arch="gemma-2b", layers=4, fp32_layers=2, max_len=4096,
               batch=(1024, 1023)),
    "s2": FAMILY_MESH_RUNS["g2"],
    "s3": FAMILY_MESH_RUNS["g3"],
    "s4": FAMILY_MESH_RUNS["g1"],
}
FP32_SERVE_TOL = 1e-5  # fp32 logits against one card's, a share of the scale


def logit_pair(torch, server, feed) -> dict:
    """A prefill of `feed` and one greedy decode step on the server's steps:
    both logits (fp32 on the host), the first layer group's self-cache
    slots, and the cross caches' frames where the model has them (with
    `cross_cache_unwritten`'s reading)."""
    from repro_torch.runtime.steps import build_decode_step, build_prefill_step

    with RouteRecorder() as rec, torch.no_grad():
        logits, cache = build_prefill_step(server.woven, mesh=server.mesh,
                                           cache_max_len=server.cfg.max_cache_len)(
            server.params, feed)
        prefill = logits.float().cpu()
        pos = feed["tokens"].shape[1] + (feed["embeds"].shape[1] if "embeds" in feed else 0)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        step, cache = build_decode_step(server.woven, mesh=server.mesh)(
            server.params, {"tokens": tok, "positions": torch.full_like(tok, pos)}, cache)
    group = cache["decoder"]["self"] if "decoder" in cache else cache["blocks0"]
    out = {"prefill": prefill, "decode": step.float().cpu(),
           "cache_slots": int(group["k"].shape[-3]), "routing": rec.calls}
    if "decoder" in cache:
        out["cross_frames"] = int(cache["decoder"]["cross"]["ck"].shape[-3])
        out["cross"] = cross_cache_unwritten(torch, server, feed)
    del cache
    return out


def gemma_sp_server(torch, mesh, layers: int, policy: str):
    """(s1)'s gemma-2b server at `layers` layers and `policy`, on `mesh`
    (None: one card) under `fsdp_sp`, random weights from seed 0."""
    run = dict(SERVE_SP_RUNS["s1"], layers=layers, decode=SERVE_SP_DECODE)
    return family_mesh_server(torch, run, mesh, policy, "fsdp_sp")


class FirstLogits:
    """While active, keeps each paged admission's first logits (fp32, host)."""

    def __enter__(self):
        from repro_torch.runtime.server import Server

        self.rows, self.real = [], Server._first_token

        def first(server, manager, rid, logits, fault=None):
            self.rows.append(logits[0, -1].float().cpu())
            return self.real(server, manager, rid, logits, fault)

        Server._first_token = first
        return self

    def __exit__(self, *exc):
        from repro_torch.runtime.server import Server

        Server._first_token = self.real


def serve_sp_gemma(torch, mesh) -> dict:
    """(s1) on this rank (or one card, `mesh` None): each counted serve's
    tokens, launches by route, step counts, pool stats and seconds, the
    logit pairs of a 1024-token prompt in bf16 and in fp32, the int8 pool's
    first logits and the collectives counted."""
    from repro_torch.distributed import collectives

    run = SERVE_SP_RUNS["s1"]
    out = {"rank": mesh.rank if mesh is not None else None}
    collectives.reset_counts()
    srv = gemma_sp_server(torch, mesh, run["layers"], "half")
    prompts, kw = continuous_traffic(srv.woven.program.cfg)
    batch = [prompts[7][:n] for n in run["batch"]]
    out["pair_bf16"] = logit_pair(torch, srv, {
        "tokens": torch.as_tensor(batch[0][None].astype("int32"), device="cuda")})

    def counted(tag, fn, first=False):
        with FirstLogits() as fl:
            got, wall, counts, routes = counted_serve(torch, fn)
        out[tag] = {"tokens": [list(map(int, o)) for o in got], "wall_s": wall,
                    "launches": {**counts, **routes},
                    "steps": dict(srv.last_step_counts or {}),
                    "pool": dict(srv.last_pool_stats or {}),
                    "spec": dict(srv.last_spec_stats or {})}
        if first:
            out[tag]["first_logits"] = fl.rows
        if mesh is not None:
            rank_log(mesh, f"mesh s1 {tag}: {wall:.2f} s")

    counted("batch", lambda: srv.serve_batch(batch))
    counted("continuous_bf16", lambda: srv.serve_continuous(prompts, prefill_chunk=512, **kw))
    srv.cfg.cache_dtype = "int8"
    try:
        counted("continuous_int8", lambda: srv.serve_continuous(prompts, **kw), first=True)
        counted("continuous_int8_k2", lambda: srv.serve_continuous(prompts, draft_len=2, **kw))
    finally:
        srv.cfg.cache_dtype = None
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    srv = gemma_sp_server(torch, mesh, run["fp32_layers"], "double")
    out["pair_fp32"] = logit_pair(torch, srv, {
        "tokens": torch.as_tensor(batch[0][None].astype("int32"), device="cuda")})
    counted("continuous_fp32", lambda: srv.serve_continuous(prompts, **kw))
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    out["collectives"] = collectives.counts()
    return out


def serve_sp_family(torch, mesh, tag, run) -> dict:
    """(s2)-(s4) on this rank (or one card, `mesh` None): the counted serve
    of (g)'s traffic (`family_mesh_serve`'s launch gates), the pool stats,
    the logit pair at the gate's policy with its MoE routings, and the
    collectives counted."""
    from repro_torch.distributed import collectives

    collectives.reset_counts()
    srv = family_mesh_server(torch, run, mesh, "half", "fsdp_sp")
    cfg = srv.woven.program.cfg
    traffic = family_mesh_traffic(cfg, run)
    tokens, counts, wall = family_mesh_serve(torch, srv, f"s {tag}", traffic)
    out = {"rank": mesh.rank if mesh is not None else None, "tokens": tokens,
           "launches": counts, "wall_s": wall, "pool": dict(srv.last_pool_stats or {})}
    policy, dtype = run["gate"], torch.float32
    if policy == "half":
        gate_srv, dtype = srv, torch.bfloat16
    else:
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        gate_srv = family_mesh_server(torch, run, mesh, policy, "fsdp_sp")
    out["pair"] = logit_pair(torch, gate_srv, family_mesh_feed(torch, cfg, traffic, dtype))
    del gate_srv
    gc.collect()
    torch.cuda.empty_cache()
    out["collectives"] = collectives.counts()
    return out


def serve_sp_rank(torch, mesh, runs) -> dict:
    """(s1)-(s4) on this rank, each run's results from every rank."""
    out = {}
    for tag in runs:
        t0 = time.perf_counter()
        got = serve_sp_gemma(torch, mesh) if tag == "s1" else \
            serve_sp_family(torch, mesh, tag, SERVE_SP_RUNS[tag])
        got["seconds"] = time.perf_counter() - t0
        rank_log(mesh, f"mesh {tag}: served in {got['seconds']:.1f} s")
        out[tag] = every_rank(got, mesh)
    return out


def sp_launch_gate(tag, got: dict, want: dict) -> None:
    """A rank's launches by route are one card's on the same traffic, and
    every K2 launch of the rank ran in the block mode (none on one card)."""
    if want.get("flash_decode_block"):
        raise AssertionError(f"mesh {tag}: one card launched K2's block mode")
    if got.get("flash_decode_block") != got.get("flash_decode"):
        raise AssertionError(f"mesh {tag}: {got.get('flash_decode_block')} block launches of "
                             f"{got.get('flash_decode')} K2 launches")
    diff = {k: (got.get(k), v) for k, v in want.items()
            if k != "flash_decode_block" and got.get(k) != v}
    if diff:
        raise AssertionError(f"mesh {tag}: launches by route (mesh, one card) differ: {diff}")


def sp_logit_gate(torch, tag, got, want, tol=None) -> dict:
    """`logit_diff`, gated at the logit gate (or within `tol` of the scale)."""
    gap = logit_diff(torch, f"mesh {tag}", got, want)
    ok = (gap["max_abs_err"] <= tol * gap["logit_scale"]) if tol else (
        gap["max_abs_err"] <= LOGIT_MAX_TOL * gap["logit_scale"]
        and gap["rms_err"] <= LOGIT_RMS_TOL * gap["logit_scale"])
    if not ok:
        raise AssertionError(f"mesh {tag}: logits against one card {gap}")
    return gap


def serve_sp_checks(torch, res: dict, runs) -> dict:
    """(s1)-(s4) against one card, built here after the ranks have gone:
    launches by route one card's (`sp_launch_gate`), a rank's pool bytes
    and cache slots half one card's, the cross caches unwritten, the
    attention's merge counted, the logit pairs at the logit gate (fp32
    within `FP32_SERVE_TOL` of the scale, and its tokens one card's; the
    int8 pool's first logits on the gate's RMS half), MoE routing alike on
    both ranks; bf16 token agreement printed."""
    import numpy as np

    out = {}
    for tag in runs:
        t0 = time.perf_counter()
        run = SERVE_SP_RUNS[tag]
        one = serve_sp_gemma(torch, None) if tag == "s1" else \
            serve_sp_family(torch, None, tag, run)
        from repro_torch.models.registry import get_config

        cfg = get_config(run["arch"])
        cfg = cfg.replace(num_layers=run["layers"] or cfg.num_layers)
        rows = []
        for r in res[tag]:
            row = {"rank": r["rank"], "seconds": r["seconds"], "launches": {}}
            if not r["collectives"].get("attention_combine", {}).get("model", {}).get("calls"):
                raise AssertionError(f"mesh {tag} rank {r['rank']}: no attention merge counted")
            row["attention_combine"] = r["collectives"]["attention_combine"]["model"]
            serves = ("batch", "continuous_bf16", "continuous_int8", "continuous_int8_k2",
                      "continuous_fp32") if tag == "s1" else (None,)
            for key in serves:
                g, w = (r[key], one[key]) if key else (r, one)
                sp_launch_gate(f"{tag} {key or 'serve'} rank {r['rank']}", g["launches"],
                               w["launches"])
                row["launches"][key or "serve"] = g["launches"]
                if w["pool"]:  # half the slots; an int8 pool's page scales whole
                    sc = 8 * cfg.kv_heads * cfg.num_layers if w["pool"]["cache_dtype"] else 0
                    if (g["pool"]["page_hbm_bytes"] - sc) * 2 != w["pool"]["page_hbm_bytes"] - sc:
                        raise AssertionError(f"mesh {tag} {key}: a rank's page bytes "
                                             f"{g['pool']['page_hbm_bytes']} of one card's "
                                             f"{w['pool']['page_hbm_bytes']}")
                row[f"{key or 'serve'}_token_agreement"] = float(np.mean(
                    [np.mean(np.asarray(a) == np.asarray(b))
                     for a, b in zip(g["tokens"], w["tokens"])]))
                row[f"{key or 'serve'}_wall_s"] = [g["wall_s"], w["wall_s"]]
            pairs = (("pair_bf16", None), ("pair_fp32", FP32_SERVE_TOL)) if tag == "s1" \
                else (("pair", None if run["gate"] == "half" else FP32_SERVE_TOL),)
            for key, tol in pairs:
                g, w = r[key], one[key]
                if g["cache_slots"] * 2 != w["cache_slots"]:
                    raise AssertionError(f"mesh {tag}: a rank's cache holds {g['cache_slots']} "
                                         f"of one card's {w['cache_slots']} slots")
                row[f"{key}_prefill"] = sp_logit_gate(torch, f"{tag} {key} prefill",
                                                      g["prefill"], w["prefill"], tol)
                row[f"{key}_decode"] = sp_logit_gate(torch, f"{tag} {key} decode",
                                                     g["decode"], w["decode"], tol)
                if "cross" in w:
                    if g["cross_frames"] * 2 != w["cross_frames"] or \
                            not g["cross"]["bytes_unchanged"]:
                        raise AssertionError(f"mesh {tag}: cross caches {g['cross_frames']} of "
                                             f"{w['cross_frames']} frames, {g['cross']}")
                    row["cross_frames"] = [g["cross_frames"], w["cross_frames"]]
                if w["routing"]:  # MoE: alike on both ranks
                    first = res[tag][0][key]["routing"]
                    if not all(torch.equal(a, b) for a, b in zip(g["routing"], first)):
                        raise AssertionError(f"mesh {tag}: the ranks routed otherwise")
                    row["routing_vs_one_card"] = routing_share(g["routing"], w["routing"])
            if tag == "s1":
                if r["continuous_fp32"]["tokens"] != one["continuous_fp32"]["tokens"]:
                    raise AssertionError("mesh s1: fp32 tokens differ from one card's")
                firsts = list(zip(r["continuous_int8"]["first_logits"],
                                  one["continuous_int8"]["first_logits"]))
                if not firsts:
                    raise AssertionError("mesh s1: no int8 admission's logits")
                gaps = [logit_diff(torch, "mesh s1 int8", a, b) for a, b in firsts]
                if any(g["rms_err"] > LOGIT_RMS_TOL * g["logit_scale"] for g in gaps):
                    raise AssertionError(f"mesh s1: int8 first logits against one card {gaps}")
                row["int8_first_logits_worst"] = max(
                    gaps, key=lambda g: g["rms_err"] / g["logit_scale"])
                row["int8_k2_spec"] = r["continuous_int8_k2"]["spec"]
            rows.append(row)
            log(f"mesh {tag} rank {r['rank']}: " + json.dumps(row, default=float))
        out[f"serve_sp_{tag}"] = {"arch": run["arch"], "ranks": rows,
                                  "one_card_s": time.perf_counter() - t0}
        del one
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_phase(torch, serve_counts: dict, requests: dict, *, backend: str = "gloo",
               serve_shape=(1, 2), serve_depth: int | None = MESH_SERVE_DEPTH,
               train_shapes=MESH_TRAIN_SHAPES, fsdp_runs=FSDP_RUNS,
               family_runs=FAMILY_MESH_RUNS, family_sp_runs=FAMILY_SP_RUNS,
               serve_sp_runs=tuple(SERVE_SP_RUNS), quant_runs=QUANT_MESH_RUNS,
               control_runs=CONTROL_MESH_RUNS) -> dict:
    """Phase 12 (see the module docstring): the ranks' runs, then the
    one-card references they are held against, built here after the ranks
    have gone.  `backend`, `serve_shape`, `serve_depth` (the meshed yi-6b
    server's layers, None: all; `serve_counts`, step 5's one-card counts at
    full depth, are scaled to it), `train_shapes`, `fsdp_runs`,
    `family_runs`, `family_sp_runs`, `serve_sp_runs`, `quant_runs` and
    `control_runs`
    default to phase 12's two gloo ranks on one card (`tools/mesh_nccl.py`
    runs the same phase over NCCL, a card per rank)."""
    from functools import partial

    import numpy as np

    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.runtime.server import ServerConfig

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_on_mesh(partial(mesh_rank, requests["solo"], requests["batch"], serve_depth,
                              dict(train_shapes), dict(fsdp_runs), dict(family_runs),
                              dict(family_sp_runs), tuple(serve_sp_runs), tuple(quant_runs),
                              tuple(control_runs), time.time()),
                      serve_shape,
                      backend=backend, device="cuda", timeout_s=900)
    ranks_s = time.perf_counter() - t0
    log(f"mesh ranks: returned {ranks_s:.1f} s after the spawn")
    summary = {"ranks_wall_s": ranks_s, "backend": backend,
               "serve_mesh": list(serve_shape),
               "train_meshes": {k: list(v) for k, v in dict(train_shapes).items()}}

    serve = res["serve"]
    want_counts = depth_counts(serve_counts, 32, serve_depth)
    for r in serve["ranks"]:
        if r["layout"] != "megatron_tp":
            raise AssertionError(f"mesh serve: layout {r['layout']}")
        got = {**r["launches"], **r["routes"]}
        diff = {k: (got.get(k), v) for k, v in want_counts.items() if got.get(k) != v}
        if diff:
            raise AssertionError(f"mesh serve rank {r['rank']}: launches by route differ "
                                 f"from the one-card run's (mesh, one card): {diff}")
        if not r["collectives"].get("all_reduce", {}).get("model", {}).get("calls"):
            raise AssertionError(f"mesh serve rank {r['rank']}: no all-reduce over model")
    # agreement with step 5's tokens where the mesh serves its depth
    agree = {k: float(np.mean([np.mean(np.asarray(a) == np.asarray(b)) for a, b in
                               zip(serve["tokens"][k], requests[f"{k}_out"])]))
             for k in ("solo", "batch")} if serve_depth is None else None

    one = yi_server(torch, None, serve_depth,
                    ServerConfig(max_cache_len=4096, decode_tokens=32, seed=0))
    toks = torch.as_tensor(requests["solo"][0], device="cuda")
    want, cache = one.prefill_vc(None, one.params, {"tokens": toks})
    want = want.float().cpu()
    del cache, one
    gc.collect()
    torch.cuda.empty_cache()
    got = serve["logits"]
    if not torch.isfinite(got).all() or got.shape != want.shape:
        raise AssertionError(f"mesh serve: prefill logits {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    rms = (got - want).pow(2).mean().sqrt().item()
    logit_gate = {"max_abs_err": err, "rms_err": rms, "logit_scale": scale}
    log(f"mesh serve: prefill logits, {tuple(serve_shape)} mesh vs one card: {logit_gate}")
    if not (err <= LOGIT_MAX_TOL * scale and rms <= LOGIT_RMS_TOL * scale):
        raise AssertionError(f"mesh serve: prefill logits against one card {logit_gate}")
    summary["serve_yi6b"] = {"ranks": serve["ranks"], "layers": serve_depth or 32,
                             "prefill_logits_vs_one_card": logit_gate,
                             "token_agreement_vs_one_card": agree}
    if "q1" in quant_runs:
        # (q1)'s gates ran on the ranks; read, where the mesh serves step 5's
        # depth: agreement with one card's int8 run (c) and its self-drafted
        # int8 run (s3) on the same prompts
        summary["serve_yi6b"]["q1_token_agreement_vs_one_card"] = {
            tag: token_agreement(serve["tokens"][f"continuous_{tag}"], requests.get(key))
            for tag, key in (("int8", "one_card_int8"), ("int8_k2", "one_card_s3"))
        } if serve_depth is None else None
        log(f"mesh (q1): {json.dumps({r['rank']: r['quant'] for r in serve['ranks']})}, "
            f"agreement {summary['serve_yi6b']['q1_token_agreement_vs_one_card']}")

    for tag in train_shapes:
        run = res[tag]
        for r in run["ranks"]:
            before, after = r["first_batch_loss"]
            if not (np.isfinite(r["losses"]).all() and after < before):
                raise AssertionError(f"mesh train {tag} rank {r['rank']}: the first batch's "
                                     f"loss did not fall: {before} -> {after}")
            log(f"mesh train {tag} rank {r['rank']}: losses {r['losses']}, first batch "
                f"{before} -> {after}, {r['step_s']} s a step, peak {r['peak_memory_gb']} GB")
        summary[f"train_gemma2b_{tag}"] = {"ranks": run["ranks"]}
    one = mesh_trainer(torch, None)
    one.init_state()
    mb = first_batch(torch, one)
    loss, norm, attn = gradient_digest(torch, one.woven, one.params, mb, stack_names(one.woven))
    want = (loss, norm, {k: g.cpu() for k, g in attn.items()})  # the ranks' are on the host
    del attn
    # (q4)'s reference: the same gradient, compressed as one card compresses it
    compressed = compressed_digest(torch, one.woven, one.params, mb) \
        if "q4" in quant_runs else None
    step_s = []  # the same steps on one card, for the ranks' step times
    for _ in range(MESH_TRAIN["steps"]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one.run(1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    summary["train_gemma2b_one_card"] = {
        "step_s": step_s, "losses": [h["loss"] for h in one.history],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"mesh train one card: {step_s} s a step, losses "
        f"{summary['train_gemma2b_one_card']['losses']}")
    del one
    gc.collect()
    torch.cuda.empty_cache()
    for tag in train_shapes:
        summary[f"train_gemma2b_{tag}"]["gradient_vs_one_card"] = compare_gradients(
            f"mesh-train-{tag}", res[tag]["digest"], want, 4, labels=("mesh", "one_card"))
    summary["depth_gemma2b"] = MESH_TRAIN_DEPTH
    if "q4" in quant_runs:
        summary["quant_q4"] = quant_compress_check(torch, res["quant"]["q4"], compressed)
    summary.update(fsdp_checks(torch, fsdp_runs, res))
    for tag, run in dict(family_runs).items():
        summary[f"family_{tag}"] = family_mesh_check(torch, tag, run, res[tag])
    for tag, run in dict(family_sp_runs).items():
        summary[f"family_{tag}"] = family_sp_check(torch, tag, run, res[tag])
    if serve_sp_runs:
        summary.update(serve_sp_checks(torch, res["serve_sp"], serve_sp_runs))
    summary.update(quant_mesh_checks(torch, res.get("quant", {}), quant_runs))
    if control_runs:
        summary["control"] = control_checks(torch, res, requests, control_runs)
    summary["seconds"] = time.perf_counter() - t0
    log("mesh " + json.dumps(summary, default=float))
    return summary


def token_agreement(got, want) -> float | None:
    """The share of equal tokens, request by request, over `got`'s tokens
    (a longer `want` is cut to them; None without `want`)."""
    import numpy as np

    if want is None:
        return None
    return float(np.mean([np.mean(np.asarray(a) == np.asarray(b)[:len(a)])
                          for a, b in zip(got, want)]))


def quant_mesh_checks(torch, res: dict, runs) -> dict:
    """(q2) and (q3) against one card, built here after the ranks have gone:
    (q2) the fp32 first prefill's logits over the int8 pool within
    `FP32_POOL_LOGIT_TOL` of the scale; (q3) each rank's codes and scales
    bit for bit one card's rows, and the `fixed` prefill logits at the
    logit gate."""
    out = {}
    if "q2" in runs:
        out["quant_q2"] = quant_pool_check(torch, res["q2"])
    if "q3" in runs:
        q3 = res["q3"]
        one = family_mesh_server(torch, QUANT_MESH_SERVE, None, policy="fixed")
        one._begin()
        want_codes = row_parallel_codes(torch, one.params, tp=len(q3["ranks"]))
        toks = torch.as_tensor(fixed_prompt()[None], device="cuda")
        want, cache = one.prefill_vc(None, one.params, {"tokens": toks})
        want = want.float().cpu()
        del one, cache
        release(torch)
        for r in q3["ranks"]:
            mine = {k: v[0] for k, v in r["codes"].items()}
            theirs = {k: v[r["coord"]] for k, v in want_codes.items()}
            if not mine or mine != theirs:
                raise AssertionError(f"mesh (q3) rank {r['rank']}: the codes and scales of "
                                     f"{sorted(k for k in theirs if mine.get(k) != theirs[k])} "
                                     "differ from one card's rows")
        got = q3["logits"]
        scale = want.abs().max().item()
        gate = {"max_abs_err": (got - want).abs().max().item(),
                "rms_err": (got - want).pow(2).mean().sqrt().item(), "logit_scale": scale,
                "row_parallel_weights": len(want_codes)}
        log(f"mesh (q3): `fixed` prefill logits, (1, 2) vs one card: {gate}")
        if not (torch.isfinite(got).all() and gate["max_abs_err"] <= LOGIT_MAX_TOL * scale
                and gate["rms_err"] <= LOGIT_RMS_TOL * scale):
            raise AssertionError(f"mesh (q3): `fixed` prefill logits against one card {gate}")
        out["quant_q3"] = {"ranks": [{k: v for k, v in r.items() if k != "codes"}
                                     for r in q3["ranks"]],
                           "prefill_logits_vs_one_card": gate,
                           "codes_bit_for_bit": len(want_codes)}
    return out


def quant_pool_check(torch, q2: dict) -> dict:
    """(q2)'s first prefills against one card's over the same weights: over
    the fp32 pool (K1 on a rank's heads) the logits within
    `FP32_POOL_LOGIT_TOL` of the scale; over the int8 pool (K2d widened at
    index 0 on a rank's heads) each rank's codes one card's for its heads
    but where a K / V element that lies on a rounding boundary rounds the
    other way — a code one step off, never more — and the logits at the
    logit gate.  Those flipped codes (the ranks' fp32 activations add their
    partial products in another order) change the next layer's K / V, so
    the int8 pool's logits part from one card's by more than 1e-5 of the
    scale: that gap, the flips and the scales' largest relative difference
    are read and printed."""
    one = family_mesh_server(torch, QUANT_MESH_SERVE, None, policy="double")
    one._begin()
    prompt = quant_prompts()[0]
    want = {dt or "fp32": pool_first_logits(torch, one, prompt, dt) for dt in (None, "int8")}
    del one
    release(torch)
    report = []
    for r, got in enumerate(q2["first"]):
        gaps = {dt: logit_diff(torch, f"mesh (q2) rank {r} {dt} pool's first prefill",
                               got[dt][0], want[dt][0]) for dt in ("fp32", "int8")}
        fp, i8 = gaps["fp32"], gaps["int8"]
        if not fp["max_abs_err"] <= FP32_POOL_LOGIT_TOL * fp["logit_scale"]:
            raise AssertionError(f"mesh (q2) rank {r}: fp32 pool's first prefill logits {fp}")
        if not (i8["max_abs_err"] <= LOGIT_MAX_TOL * i8["logit_scale"]
                and i8["rms_err"] <= LOGIT_RMS_TOL * i8["logit_scale"]):
            raise AssertionError(f"mesh (q2) rank {r}: int8 pool's first prefill logits {i8}")
        heads = torch.as_tensor(got["heads"])
        codes, total, scale_rel = 0, 0, 0.0
        for key, mine in got["int8"][1].items():
            theirs = want["int8"][1][key].index_select(-1 if key.endswith("sc") else -2,
                                                       heads)
            if key.endswith(("ksc", "vsc")):
                rel = (mine - theirs).abs() / theirs.abs().clamp(min=1e-30)
                scale_rel = max(scale_rel, rel.max().item())
                continue
            step = (mine.view(torch.int8).to(torch.int16)
                    - theirs.view(torch.int8).to(torch.int16)).abs()
            if int(step.max()) > 1:
                raise AssertionError(f"mesh (q2) rank {r}: codes {key} {int(step.max())} "
                                     "steps from one card's")
            codes += int((step != 0).sum())
            total += step.numel()
        i8.update(flipped_codes=codes, codes=total, scale_max_rel_err=scale_rel)
        report.append({"rank": r, "fp32_pool": fp, "int8_pool": i8,
                       "int8_within_fp32_gate": i8["max_abs_err"]
                       <= FP32_POOL_LOGIT_TOL * i8["logit_scale"]})
    log(f"mesh (q2): first prefills against one card {json.dumps(report)}; runs "
        f"{json.dumps(q2['ranks'])}")
    return {"ranks": q2["ranks"], "first_prefill_vs_one_card": report,
            "speculative_bit_identical_to_plain": True}


def quant_compress_check(torch, q4: dict, want) -> dict:
    """(q4): the first batch's loss fell on every rank, and the compressed
    gradient at the training gates against one card's."""
    import numpy as np

    for r in q4["ranks"]:
        before, after = r["first_batch_loss"]
        if not (np.isfinite(r["losses"]).all() and after < before):
            raise AssertionError(f"mesh (q4) rank {r['rank']}: the first batch's loss did "
                                 f"not fall: {before} -> {after}")
    log(f"mesh (q4): {json.dumps(q4['ranks'])}")
    return {"ranks": q4["ranks"], "compressed_gradient_vs_one_card": compare_gradients(
        "mesh-train-q4-compressed", q4["digest"], want, 4, labels=("mesh", "one_card"))}


def control_checks(torch, res: dict, requests: dict, runs) -> dict:
    """(d1)-(d4) as the ranks gated them, and against one card, built here
    after the ranks have gone: (d1)'s `op_history`, switches and distinct
    operating points gated equal to one card's governed serve of the same
    traffic, policy and depth (the fp32 4-layer server over the same
    weights), and the share of its tokens one card gives, printed; (d3)'s
    clean tokens against `fleet_phase`'s one-card (f4) on the same prompts'
    first tokens, printed.  Returns the `mesh` line's `control` entry, with
    every counted run's launches by rank."""
    serve_ranks = res["serve"]["ranks"]
    fp = res.get("quant", {}).get("control", {})
    out = {"runs": list(runs), "launches": {}}
    for r, rank in enumerate(serve_ranks):
        for name, rep in rank.get("control", {}).items():
            if "launches" in rep:
                out["launches"][f"{name}_rank{r}"] = {**rep["launches"], **rep["routes"],
                                                      "verify_launches": rep["verify_launches"]}
    for r, counted in enumerate(fp.get("launches", [])):
        out["launches"].update({f"{name}_rank{r}": c for name, c in counted.items()})
    if "d2" in runs:
        out["d2"] = [rank["control"]["d2"] for rank in serve_ranks]
    if "d4" in runs:
        out["d4_refine"] = {k.removeprefix("d4_refine_"): v
                            for k, v in serve_ranks[0]["control"].items()
                            if k.startswith("d4_refine_")}
        out["d4_drain"] = fp["d4"]
    if "d1" in runs:
        d1 = fp["d1"]
        prompts, kw = control_traffic()
        one = family_mesh_server(torch, QUANT_MESH_SERVE, None, policy="double")
        toks = one.serve_continuous(prompts, **kw, qos={**QOS_BASE, **QOS_MODEL_SLO})
        want = one.last_qos_stats
        del one
        release(torch)
        gate = {k: {"mesh": d1["qos"][k], "one_card": want[k]}
                for k in ("op_history", "switches", "distinct_ops")}
        log(f"mesh (d1): the governor's choices, (1, 2) vs one card: {json.dumps(gate)}")
        if any(v["mesh"] != v["one_card"] for v in gate.values()):
            raise AssertionError(f"mesh (d1): operating points against one card's {gate}")
        out["d1"] = {"runs": d1["runs"], "qos": d1["qos"], "seconds": d1["seconds"],
                     "token_agreement_vs_one_card": token_agreement(
                         d1["tokens"], [t.tolist() for t in toks])}
    if "d3" in runs:
        d3 = fp["d3"]
        out["d3"] = {"runs": d3["runs"], "seconds": d3["seconds"],
                     "token_agreement_vs_one_card_f4": token_agreement(
                         d3["tokens"]["clean"], requests.get("one_card_f4"))}
    return out


class PhaseClock:
    """Logs each phase's seconds as it ends, and the time since the start."""

    def __init__(self, t_start: float):
        self.t_start = self.t_last = t_start

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        log(f"phase {name}: {now - self.t_last:.1f} s ({now - self.t_start:.1f} s in all)")
        self.t_last = now


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs one card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    # every phase weaves the kernel tuner's aspect over an empty cache of its
    # own (a miss changes nothing); `tuner_phase` tunes beside it
    tuner_home = tempfile.mkdtemp(prefix="repro_torch_tuner_")
    os.environ["REPRO_TORCH_TUNER_CACHE"] = os.path.join(tuner_home, "empty.json")
    try:
        return run(torch, build, t_start)
    finally:
        shutil.rmtree(tuner_home, ignore_errors=True)


def run(torch, build, t_start) -> int:
    card = nvidia_smi_line()
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-2]
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {nvcc.strip()}")
    log(f"env: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB, "
        f"{torch.cuda.device_count()} device(s)")

    clock = PhaseClock(t_start)
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
    wide = widened_decode_cases(torch, gen)
    quant = quantized_decode_cases(torch, gen)
    wcodes = widened_codes_cases(torch, gen)
    verify = verify_decode_cases(torch, gen)
    lru = rglru_cases(torch, gen)
    lru_serve = rglru_serve_times(torch, gen)
    wkv6 = wkv_cases(torch, gen)
    lse_c, dq_c, dkv_c = flash_bwd_cases(torch, gen)
    front_k1, front_k2 = frontend_kernel_cases(torch, gen)
    blk = block_decode_cases(torch, gen)
    clock("kernel cases")
    pre += front_k1
    dec += front_k2
    for c in (norm + pre + dec + wide + quant + wcodes + verify + lru + wkv6 + lse_c + dq_c
              + dkv_c + blk):
        log("kernel-case " + json.dumps({k: v for k, v in c.items() if k != "main"}))
    log("shared-prefill-identity " + json.dumps(shared_prefill_identity(torch, gen)))

    reduced_phase(torch)
    clock("reduced")
    serve_counts, server, requests = serve_phase(torch)
    clock("serve")
    roof_serve = roofline_serve_cells(torch, server, requests, serve_counts,
                                      next(c for c in pre if c["main"]))
    clock("roofline serve cells")
    cont = continuous_phase(torch, server)
    clock("continuous")
    spec = speculative_phase(torch, server)
    clock("speculative")
    shapes = DecodeShapes()
    fsrv = fp32_depth4_server(server)
    qos = qos_phase(torch, server, fsrv, shapes)
    clock("qos")
    fleet, requests["one_card_f4"] = fleet_phase(torch, server, fsrv, shapes)
    clock("fleet")
    tun = tuner_phase(torch, server)
    clock("tuner")
    del server, fsrv
    torch.cuda.empty_cache()
    governed_cases = governed_shape_cases(torch, gen, shapes.shapes)
    for c in governed_cases:
        log("governed-shape-case " + json.dumps(c))
    gc.collect()
    torch.cuda.empty_cache()
    fam = families_phase(torch)
    clock("families")
    fro = frontends_phase(torch)
    clock("frontends")
    torch.cuda.reset_peak_memory_stats()
    rec = recurrent_phase(torch)
    clock("recurrent")
    gc.collect()  # the serving phases' models may sit in reference cycles
    torch.cuda.empty_cache()
    train = train_phase(torch)
    clock("train")
    gc.collect()
    torch.cuda.empty_cache()
    tfam = train_families_phase(torch)
    clock("train families")
    gc.collect()
    torch.cuda.empty_cache()
    ex = examples_phase(torch)
    clock("examples")
    roofline_phase(torch, roof_serve, train)
    clock("roofline")
    gc.collect()
    torch.cuda.empty_cache()
    requests["one_card_int8"] = cont.pop("c_int8_tokens")[:MESH_CONTINUOUS]
    requests["one_card_s3"] = spec.pop("s3_int8_tokens")[:MESH_CONTINUOUS]
    mesh = mesh_phase(torch, serve_counts, requests)
    clock("mesh")
    q1runs = {r["rank"]: r["quant"] for r in mesh["serve_yi6b"]["ranks"]}

    # `launches`: the continuous main path, bf16 pool (run a); the quantized
    # mode over the int8 pool (run c): its single tokens on the split route,
    # its widened q (suffix and first prefills) on the tensor-core mode over
    # codes.  Every counted run is listed beside.
    a, c = cont["a_bf16_shared"], cont["c_int8_shared"]

    def by_run(key):
        return {"serve_and_serve_batch": serve_counts.get(key, 0),
                "continuous_a_bf16": a.get(key, 0), "continuous_c_int8": c.get(key, 0),
                "speculative_s1_bf16": spec["s1_bf16_k2"].get(key, 0),
                "speculative_s3_int8": spec["s3_int8_k2"].get(key, 0),
                **{f"qos_{run}": qos[run].get(key, 0) for run in qos},
                **{f"fleet_{run}": fleet[run].get(key, 0) for run in fleet},
                **{f"tuner_{run}": tun["counts"][run].get(key, 0) for run in tun["counts"]},
                **{f"families_{run}": fam[run].get(key, 0) for run in fam},
                **{f"frontends_{run}": fro[run].get(key, 0) for run in fro},
                "recurrentgemma_serve": rec["recurrentgemma-2b"].get(key, 0),
                "rwkv6_serve": rec["rwkv6-3b"].get(key, 0),
                "train_gemma_6_steps": train["launches_6_steps"].get(key, 0),
                **{f"train_gemma_remat_{p}": r["launches"].get(key, 0)
                   for p, r in train["remat_policies"].items()},
                **{f"train_families_{run}": tfam[run]["launches"].get(key, 0)
                   for run in tfam},
                **{f"examples_{run}": ex[run]["launches"].get(key, 0)
                   for run in ("quickstart", "train_100m", "navigation")},
                **{f"mesh_serve_yi6b_1x2_rank{r['rank']}":
                   {**r["launches"], **r["routes"]}.get(key, 0)
                   for r in mesh["serve_yi6b"]["ranks"]},
                **{f"mesh_continuous_yi6b_1x2_rank{r['rank']}":
                   {**r["continuous_launches"], **r["continuous_routes"]}.get(key, 0)
                   for r in mesh["serve_yi6b"]["ranks"]},
                **{f"mesh_train_gemma2b_{tag}_rank{r['rank']}_last_step":
                   {**r["launches_per_step"], **r["routes_per_step"]}.get(key, 0)
                   for tag in MESH_TRAIN_SHAPES
                   for r in mesh[f"train_gemma2b_{tag}"]["ranks"]},
                **{f"mesh_fsdp_{tag}_serve_rank{r['rank']}": r["launches"].get(key, 0)
                   for tag in FSDP_RUNS if "serve" in mesh[f"fsdp_{tag}"]
                   for r in mesh[f"fsdp_{tag}"]["serve"]["ranks"]},
                **{f"mesh_fsdp_{tag}_train_rank{r['rank']}_last_step":
                   {**r["launches_per_step"], **r["routes_per_step"]}.get(key, 0)
                   for tag in FSDP_RUNS for r in mesh[f"fsdp_{tag}"]["train"]["ranks"]},
                **{f"mesh_family_{tag}_serve_rank{r['rank']}": r["launches"].get(key, 0)
                   for tag in FAMILY_MESH_RUNS for r in mesh[f"family_{tag}"]["ranks"]},
                **{f"mesh_family_{tag}_train_rank{r['rank']}_last_step":
                   {**r["launches_per_step"], **r["routes_per_step"]}.get(key, 0)
                   for tag in FAMILY_MESH_RUNS
                   for r in mesh[f"family_{tag}"]["train"]["ranks"]},
                **{f"mesh_family_{tag}_fsdp_sp_logits_rank{r['rank']}":
                   r["dense_launches"].get(key, 0)
                   for tag in FAMILY_SP_RUNS for r in mesh[f"family_{tag}"]["ranks"]},
                **{f"mesh_family_{tag}_fsdp_sp_train_rank{r['rank']}_last_step":
                   {**r["train"]["launches_per_step"],
                    **r["train"]["routes_per_step"]}.get(key, 0)
                   for tag in FAMILY_SP_RUNS for r in mesh[f"family_{tag}"]["ranks"]},
                **{f"mesh_q1_yi6b_{tag}_rank{rank}":
                   {**q[tag]["launches"], **q[tag]["routes"]}.get(key, 0)
                   for rank, q in q1runs.items() for tag in q},
                **{f"mesh_q2_yi6b_4l_fp32_int8_{tag}_rank{rank}":
                   {**q["launches"], **q["routes"]}.get(key, 0)
                   for rank, runs in enumerate(mesh["quant_q2"]["ranks"])
                   for tag, q in runs.items()},
                **{f"mesh_q3_yi6b_4l_fixed_prefill_rank{r['rank']}":
                   {**r["launches"], **r["routes"]}.get(key, 0)
                   for r in mesh["quant_q3"]["ranks"]},
                **{f"mesh_q4_gemma2b_compressed_rank{r['rank']}_last_step":
                   {**r["launches_per_step"], **r["routes_per_step"]}.get(key, 0)
                   for r in mesh["quant_q4"]["ranks"]},
                **{f"mesh_control_{run}": c.get(key, 0)
                   for run, c in mesh["control"]["launches"].items()},
                **{f"mesh_serve_sp_{tag}_{run}_rank{r['rank']}": c.get(key, 0)
                   for tag in SERVE_SP_RUNS for r in mesh[f"serve_sp_{tag}"]["ranks"]
                   for run, c in r["launches"].items()}}

    # K2's single-token launches (all but widened q) and, of those, the split
    # route's (the rest run the FMA body)
    single = {run: n - by_run("flash_decode_tc")[run]
              for run, n in by_run("flash_decode").items()}
    split = by_run("flash_decode_split")

    kernels = [
        kernel_entry("flash_attention", "src/repro_torch/csrc/flash_prefill.cu",
                     "src/repro/kernels/flash_attention/kernel.py:490", pre,
                     a["flash_attention"], by_run("flash_attention"),
                     tensor_core_launches_by_run=by_run("flash_attention_tc"),
                     fma_launches_by_run=by_run("flash_attention_fma")),
        kernel_entry("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/decode.py:454", dec,
                     a["flash_decode"] - a["flash_decode_tc"], single,
                     tensor_core_launches_by_run=split,
                     fma_launches_by_run={run: n - split[run] for run, n in single.items()},
                     split_source="src/repro_torch/csrc/decode_split.cuh",
                     gb_s=next(x["gb_s"] for x in dec if x["main"])),
        kernel_entry("flash_decode_quantized", "src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/decode.py:454", quant,
                     c["flash_decode_quantized"] - c["flash_decode_tc"],
                     by_run("flash_decode_quantized"),
                     tensor_core_launches=c["flash_decode_split"],
                     fma_launches=c["flash_decode_fma"],
                     split_source="src/repro_torch/csrc/decode_split.cuh",
                     gb_s=next(x["gb_s"] for x in quant if x["main"])),
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
                     t["flash_attention_bwd"], by_run("flash_attention_bwd"),
                     tensor_core_launches_by_run=by_run("flash_attention_bwd_tc")),
        kernel_entry("flash_attention_bwd_dkv", "src/repro_torch/csrc/flash_bwd.cu",
                     "src/repro/kernels/flash_attention/kernel.py:809", dkv_c,
                     t["flash_attention_bwd"], by_run("flash_attention_bwd"),
                     tensor_core_launches_by_run=by_run("flash_attention_bwd_tc")),
    ]
    # K2's widened-q mode over bf16 values (K1's tensor-core body) runs on
    # the continuous path's suffix prefills
    kernels.append(kernel_entry(
        "flash_decode_widened_tc", "src/repro_torch/csrc/flash_decode.cu",
        "src/repro/kernels/flash_attention/decode.py:454", wide, a["flash_decode_tc"],
        by_run("flash_decode_tc")))
    # the same mode over int8 / fp8 codes: run (c)'s suffix prefills and the
    # int8 pool's first prefills
    kernels.append(kernel_entry(
        "flash_decode_widened_codes_tc", "src/repro_torch/csrc/flash_decode.cu",
        "src/repro/kernels/flash_attention/decode.py:454", wcodes, c["flash_decode_tc"],
        # the families serve bf16 pools: their quantized launches, all of K2d, are 0
        {"continuous_c_int8": c["flash_decode_tc"],
         **{f"families_{run}": fam[run]["flash_decode_quantized"] for run in fam},
         **{f"mesh_q1_yi6b_{tag}_rank{rank}": q[tag]["routes"]["flash_decode_tc"]
            for rank, q in q1runs.items() for tag in q}},
        fma_launches=c["flash_decode_fma"]))
    kernels[-1]["library_ms_note"] = "no single PyTorch call attends over an int8 paged pool"
    # the same mode at the speculative verify step's shape: `launches` are
    # (s1)'s verify steps x layers; the int8 pool's beside
    kernels.append(kernel_entry(
        "flash_decode_verify", "src/repro_torch/csrc/flash_decode.cu",
        "src/repro/kernels/flash_attention/decode.py:454", verify,
        spec["s1_bf16_k2"]["verify_launches"],
        {**{run: spec[run]["verify_launches"] for run in
            ("s1_bf16_k2", "s2_bf16_k4", "s3_int8_k2")},
         **{f"qos_{run}": qos[run]["verify_launches"] for run in qos},
         **{f"tuner_{run}": tun["counts"][run]["verify_launches"] for run in tun["counts"]},
         **{f"families_{run}": fam[run]["verify_launches"] for run in fam},
         **{f"mesh_q1_yi6b_int8_k2_rank{rank}": q["int8_k2"]["verify_launches"]
            for rank, q in q1runs.items()},
         **{f"mesh_q2_yi6b_4l_fp32_int8_k2_rank{rank}": runs["k2"]["verify_launches"]
            for rank, runs in enumerate(mesh["quant_q2"]["ranks"])},
         **{f"mesh_control_{run}": c["verify_launches"]
            for run, c in mesh["control"]["launches"].items()}}))
    # K2's block mode over a rank's share of a sequence-split cache: the
    # serving runs under fsdp_sp, (s1)'s chunked bf16 continuous run on
    # rank 0 the main path
    s1 = mesh["serve_sp_s1"]["ranks"][0]["launches"]["continuous_bf16"]
    kernels.append(kernel_entry(
        "flash_decode_block", "src/repro_torch/csrc/flash_decode.cu",
        "src/repro/kernels/flash_attention/decode.py:454", blk, s1["flash_decode_block"],
        by_run("flash_decode_block"), split_source="src/repro_torch/csrc/decode_split.cuh",
        gb_s=next(x["gb_s"] for x in blk if x["main"])))
    kernels[-1]["library_ms_note"] = ("SDPA over the same share with a prebuilt mask; "
                                      "it returns no lse")
    # every K2 shape the governed and fleet runs launched, held against the
    # plain version (`governed_shape_cases`)
    kernels[1]["qos_fleet_shape_cases"] = governed_cases
    # every value the kernel tuner's spaces hold, held against the plain
    # version (`tuned_value_cases`)
    entry = {e["name"]: e for e in kernels}
    entry["flash_decode"]["tuner_page_size_cases"] = tun["cases"]["page_size"]
    entry["flash_decode_quantized"]["tuner_cache_dtype_cases"] = tun["cases"]["cache_dtype"]
    entry["flash_attention_bwd_dkv"]["tuner_dkv_n_split_cases"] = tun["cases"]["dkv_n_split"]
    entry["flash_decode_verify"]["tuner_draft_len_cases"] = tun["cases"]["draft_len"]
    kernels[2]["library_ms_note"] = ("no single PyTorch call attends over an int8 "
                                     "paged pool")
    kernels[4]["library_ms_note"] = "no single PyTorch call computes a linear recurrence"
    kernels[4].update(rglru_serve_entry(lru, lru_serve, rec["recurrentgemma-2b"]["rglru"]))
    kernels[5]["library_ms_note"] = "no single PyTorch call computes the WKV recurrence"
    kernels[5]["cuda_launches_per_call"] = next(
        c["cuda_launches_per_call"] for c in wkv6 if c["main"])
    idle = [e["name"] for e in kernels if not e["launches"]]
    if idle:
        raise AssertionError(f"kernels not launched on their main path: {idle}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
