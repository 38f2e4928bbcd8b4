"""Serving launcher for the port.

    python -m repro_torch.launch.serve --arch yi-6b --full            # on the card
    python -m repro_torch.launch.serve --arch yi-6b --device cpu      # reduced config, host

Two modes:
  (default)       solo `serve()` per request;
  --batch-serve   the same wave of requests through one `serve_batch`
                  (per-request prefill, one batched decode loop).

`--reduced` (the default) serves the small smoke configuration, `--full` the
published one.  On the card the hand-written CUDA kernels are woven onto the
attention and norm joinpoints.  `--continuous`, `--stream` and `--fleet` belong
to the paged-serving and fleet slices, which are not ported yet.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import SHAPES
from repro_torch.core.program import Program
from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
from repro_torch.models.registry import ARCHS
from repro_torch.runtime.server import Server, ServerConfig

_LATER = {
    "continuous": "serve_continuous (paged pool) arrives with the paged-serving slice",
    "stream": "serve_stream (QoS event loop) arrives with the paged-serving slice",
    "fleet": "the multi-replica fleet arrives with the fleet slice",
}


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
    ap.add_argument("--continuous", action="store_true", help=_LATER["continuous"])
    ap.add_argument("--stream", action="store_true", help=_LATER["stream"])
    ap.add_argument("--fleet", type=int, default=0, metavar="N", help=_LATER["fleet"])
    args = ap.parse_args(argv)
    for flag in ("continuous", "stream", "fleet"):
        if getattr(args, flag):
            ap.exit(2, f"--{flag} is not ported yet: {_LATER[flag]}\n")

    cfg = ServerConfig(
        max_cache_len=args.prompt_len + args.decode_tokens + 1,
        decode_tokens=args.decode_tokens,
    )
    server = build_server(args.arch, reduced=args.reduced, device=args.device, cfg=cfg)
    vocab = server.woven.program.cfg.vocab
    rng = np.random.default_rng(0)

    if args.batch_serve:
        prompts = [rng.integers(0, vocab, args.prompt_len).astype(np.int64)
                   for _ in range(args.requests)]
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
