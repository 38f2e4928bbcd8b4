"""UC2 (paper §5): self-adaptive navigation serving, on PyTorch.

The server answers routing-style requests with a (reduced) LM; memoization
caches repeated routes (paper §2.4) and mARGOt trades decode quality
(tokens generated = NQI analogue) against latency under load.  On the card
the attention and RMSNorm joinpoints are woven to the hand-written CUDA
kernels (flash prefill, flash decode, RMSNorm).

    python examples_torch/navigation_serve.py                 # on the card
    python examples_torch/navigation_serve.py --device cpu    # on the host
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.autotune.margot import LE, Goal, KnowledgeBase, Margot, OperatingPoint, State
from repro_torch.configs.base import SHAPES
from repro_torch.core.program import Program
from repro_torch.core.strategies.memoization import MemoizeStep
from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
from repro_torch.runtime.server import Server, ServerConfig

SERVES = 12  # over 6 routes: repeated routes -> memo hits


def make_margot() -> Margot:
    # knowledge: decode budget -> quality (NQI analogue) & latency
    kb = KnowledgeBase([
        OperatingPoint({"decode_tokens": n},
                       {"quality": (min(10.0, 4.0 + n), 0.2),
                        "latency": (0.02 * n + 0.05, 0.01)})
        for n in (1, 2, 4, 6)
    ])
    return Margot(kb, [State("qos", "quality", True, [
        Goal("lat", "latency", LE, 0.4)])])


def build_server(device: str = "cuda", margot: Margot | None = None) -> Server:
    program = Program.from_arch("gemma-2b", kind="serve", reduced=True, device=device)
    extra = [MemoizeStep(tsize=256)]
    if program.device.type == "cuda":
        extra += cuda_kernel_aspects()
    woven = default_weave(program, SHAPES["prefill_32k"], {}, extra_aspects=extra)
    return Server(woven, ServerConfig(max_cache_len=32, decode_tokens=4),
                  margot=margot)


def make_routes(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (1, 12), dtype=np.int32) for _ in range(6)]


def navigate(server: Server, margot: Margot,
             routes: list[np.ndarray]) -> list[tuple[int, np.ndarray]]:
    """Serve SERVES requests over `routes` in turn, each at the decode budget
    mARGOt picks; returns (decode_tokens, tokens) per request."""
    out = []
    for i in range(SERVES):
        op = margot.update()
        n = op.knobs["decode_tokens"]
        out.append((n, server.serve(routes[i % len(routes)], decode_tokens=n)))
        margot.observe("latency", server.latencies[-1])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    margot = make_margot()
    server = build_server(args.device, margot)
    navigate(server, margot, make_routes(server.woven.program.cfg.vocab))
    print(f"served {server.served}; memo hit rate "
          f"{server.memo.hit_rate:.0%}; knob={margot.current.knobs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
