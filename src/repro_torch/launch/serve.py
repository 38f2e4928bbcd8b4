"""Serving launcher for the port.

    python -m repro_torch.launch.serve --arch yi-6b --full            # on the card
    python -m repro_torch.launch.serve --arch rwkv6-3b --full         # on the card
    python -m repro_torch.launch.serve --arch yi-6b --device cpu      # reduced config, host

Modes:
  (default)       solo `serve()` per request;
  --batch-serve   the same wave of requests through one `serve_batch`
                  (per-request prefill, one batched decode loop);
  --continuous    one `serve_continuous` wave over the whole request set
                  (paged pool, prefix sharing), printing each request's
                  structured outcome;
  --stream        drive the `serve_stream` event loop directly, printing
                  per-token events with TTFT / inter-token latency columns
                  (`--prefill-chunk` spreads long admissions over waves).

`--continuous` and `--stream` serve the attention families only: for the
recurrent ones (recurrentgemma-2b, rwkv6-3b) they exit with the server's
refusal.  `--reduced` (the default) serves the small smoke configuration,
`--full` the published one.  On the card the hand-written CUDA kernels are
woven onto the attention, RMSNorm, RG-LRU and WKV joinpoints.  `--fleet` belongs to the fleet slice, which is
not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import SHAPES
from repro_torch.core.program import Program
from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
from repro_torch.models.registry import ARCHS
from repro_torch.runtime.server import Server, ServerConfig

_FLEET = "the multi-replica fleet arrives with the fleet slice"


def _print_outcomes(outcomes) -> None:
    for o in outcomes:
        print(f"  rid {o['rid']}: {o['status']:<18} tokens={o['tokens']}"
              + (f"  ({o['reason']})" if o["reason"] else ""))


def _stream(server: Server, prompts, args) -> None:
    """Drive `serve_stream`, one line per event, then one per request."""
    gen = server.serve_stream(prompts, decode_tokens=args.decode_tokens,
                              prefill_chunk=args.prefill_chunk)
    t_start = time.perf_counter()
    last_tok: dict[int, float] = {}
    print(f"{'wave':>5} {'event':<14} {'rid':>4} {'ttft_ms':>8} {'gap_ms':>7}  detail")
    while True:
        try:
            ev = next(gen)
        except StopIteration:
            break
        kind, rid = ev["event"], ev.get("rid", -1)
        ttft = gap = ""
        if kind == "token":
            if ev["index"] == 0:
                ttft = f"{1e3 * (ev['t'] - t_start):.1f}"
            elif rid in last_tok:
                gap = f"{1e3 * (ev['t'] - last_tok[rid]):.1f}"
            last_tok[rid] = ev["t"]
            detail = f"token={ev['token']} index={ev['index']}"
        elif kind == "wave":
            detail = (f"batch={ev['batch']} emitted={ev['emitted']} "
                      f"prefill_tokens={ev['prefill_tokens']}")
        else:
            detail = " ".join(f"{k}={v}" for k, v in ev.items()
                              if k not in ("event", "wave", "t", "rid"))
        print(f"{ev['wave']:>5} {kind:<14} {rid if rid >= 0 else '':>4} "
              f"{ttft:>8} {gap:>7}  {detail}")
    for o in server.last_outcomes:
        ttft_ms = f"{1e3 * o['ttft_s']:.1f}ms" if o["ttft_s"] is not None else "-"
        gap_ms = (f"{1e3 * o['tok_gap_max_s']:.1f}ms"
                  if o["tok_gap_max_s"] is not None else "-")
        print(f"  rid {o['rid']}: {o['status']:<18} tokens={o['tokens']} "
              f"ttft={ttft_ms} max_gap={gap_ms}")


def build_server(arch: str, *, reduced: bool, device: str, cfg: ServerConfig) -> Server:
    """`Program.from_arch` -> `default_weave` (+ the CUDA kernel aspects on
    the card) -> `Server`: how every launcher of the port builds a server."""
    program = Program.from_arch(arch, kind="serve", reduced=reduced, device=device)
    extra = cuda_kernel_aspects() if program.device.type == "cuda" else None
    woven = default_weave(program, SHAPES["prefill_32k"], {}, extra_aspects=extra)
    return Server(woven, cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="yi-6b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-tokens", type=int, default=8)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--reduced", dest="reduced", action="store_true", default=True,
                      help="serve the reduced smoke configuration (default)")
    size.add_argument("--full", dest="reduced", action="store_false",
                      help="serve the published configuration")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--batch-serve", action="store_true",
                    help="serve all requests through one serve_batch wave")
    ap.add_argument("--continuous", action="store_true",
                    help="serve all requests through one continuous-batching "
                         "wave and print structured outcomes")
    ap.add_argument("--stream", action="store_true",
                    help="drive the serve_stream event loop: print per-token "
                         "events with TTFT / inter-token latency")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill tokens per wave (stream mode)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N", help=_FLEET)
    args = ap.parse_args(argv)
    if args.fleet:
        ap.exit(2, f"--fleet is not ported yet: {_FLEET}\n")

    cfg = ServerConfig(
        max_cache_len=args.prompt_len + args.decode_tokens + 1,
        decode_tokens=args.decode_tokens,
    )
    server = build_server(args.arch, reduced=args.reduced, device=args.device, cfg=cfg)
    vocab = server.woven.program.cfg.vocab
    rng = np.random.default_rng(0)

    if args.stream or args.continuous or args.batch_serve:
        prompts = [rng.integers(0, vocab, args.prompt_len).astype(np.int64)
                   for _ in range(args.requests)]
    if args.stream or args.continuous:
        try:
            if args.stream:
                _stream(server, prompts, args)
                return 0
            server.serve_continuous(prompts, decode_tokens=args.decode_tokens)
        except ValueError as err:  # e.g. recurrent state, which is not paged
            ap.exit(2, f"{err}\n")
        stats = server.last_pool_stats
        print(f"continuous wave: {len(prompts)} request(s), pool "
              f"{stats['peak_live_pages']} peak live pages, "
              f"{stats['prefix_hits']} prefix hits, on {server.device}")
        _print_outcomes(server.last_outcomes)
        return 0
    if args.batch_serve:
        outs = server.serve_batch(prompts, decode_tokens=args.decode_tokens)
        print(f"batched wave: {len(outs)} request(s), {len(outs[0])} tokens each, "
              f"{server.latencies[-1]*1e3:.0f}ms on {server.device}")
        return 0

    for i in range(args.requests):
        prompt = rng.integers(0, vocab, (args.batch, args.prompt_len), dtype=np.int32)
        out = server.serve(prompt)
        print(f"request {i}: generated {out.shape} in {server.latencies[-1]*1e3:.0f}ms")
    print(f"served {server.served} on {server.device}; p50 latency "
          f"{sorted(server.latencies)[len(server.latencies)//2]*1e3:.0f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
