"""Fleet launcher: N serving replicas + hot spares in one process, over one
woven program and one copy of the weights (`runtime/fleet.ServingFleet`).

    python -m repro_torch.launch.fleet --replicas 2 --spares 1 \
        --requests 8 --shared-prefix 8                          # on the card
    python -m repro_torch.launch.fleet --device cpu             # reduced, host

Scenario flags drive the resilience machinery end to end:
  --kill-at V    schedule a replica loss at the V-th wave dispatch (the
                 victim's incomplete requests re-dispatch to survivors);
  --drain HOST   SIGTERM-drain replica HOST mid-wave (in-flight work
                 finishes, the waiting queue hands off to peers);
  --deadline-s   per-request fleet deadline (overdue requests retire
                 with partial output as deadline_exceeded).

A real SIGTERM to this process drains replica 0 gracefully before the
wave (PreemptionHandler), mirroring the per-replica drain path.
`--reduced` (the default) serves the small smoke configuration, `--full`
the published one.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.strategies.resilience import FaultInjector
from repro_torch.distributed.fault import PreemptionHandler
from repro_torch.launch.serve import build_woven
from repro_torch.models.registry import ARCHS
from repro_torch.runtime.fleet import ServingFleet, replica_factory
from repro_torch.runtime.server import ServerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="yi-6b")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--spares", type=int, default=1)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--shared-prefix", type=int, default=8,
                    help="tokens of shared system prompt (prefix-affinity "
                         "routing keys on these)")
    ap.add_argument("--decode-tokens", type=int, default=5)
    ap.add_argument("--wave-size", type=int, default=3)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--kill-at", type=int, default=None, metavar="V",
                    help="inject a replica loss at wave-dispatch visit V")
    ap.add_argument("--drain", type=int, default=None, metavar="HOST",
                    help="SIGTERM-drain replica HOST mid-wave")
    ap.add_argument("--deadline-s", type=float, default=None)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--reduced", dest="reduced", action="store_true", default=True,
                      help="serve the reduced smoke configuration (default)")
    size.add_argument("--full", dest="reduced", action="store_false",
                      help="serve the published configuration")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    woven = build_woven(args.arch, reduced=args.reduced, device=args.device)
    cfg = ServerConfig(
        max_cache_len=args.prompt_len + args.decode_tokens + 1,
        decode_tokens=args.decode_tokens, max_batch=args.max_batch,
        page_size=8,
    )

    injector = None
    if args.kill_at is not None:
        injector = FaultInjector.single("replica_loss", "raise", at=args.kill_at)
    fleet = ServingFleet(replica_factory(woven, cfg),
                         replicas=args.replicas, spares=args.spares,
                         injector=injector, wave_size=args.wave_size,
                         deadline_s=args.deadline_s)
    if args.drain is not None:
        fleet.request_drain(args.drain)
    preempt = PreemptionHandler(install=True)

    vocab = woven.program.cfg.vocab
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, args.shared_prefix)
    tail = max(0, args.prompt_len - args.shared_prefix)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, tail)]).astype(np.int64)
               for _ in range(args.requests)]

    if preempt.pending and args.replicas:
        fleet.request_drain(fleet.replicas[0].host)
    outs = fleet.serve(prompts, decode_tokens=args.decode_tokens)
    stats = fleet.last_fleet_stats

    print(f"fleet: {args.replicas} replica(s) + {args.spares} spare(s), "
          f"{stats['rounds']} round(s), on {woven.program.device}")
    print(f"outcomes: {stats['outcomes']}  redispatched: {stats['redispatched']}  "
          f"affinity hits: {stats['affinity_hits']}  prefix-hit replicas: "
          f"{stats['replicas_with_prefix_hits']}")
    for ev in stats["events"]:
        print(f"  event: {ev}")
    for o in fleet.last_outcomes:
        print(f"  rid {o['rid']}: {o['status']:<18} replica={o['replica']} "
              f"attempts={o['attempts']} tokens={o['tokens']}"
              + (f"  ({o['reason']})" if o["reason"] else ""))
    print(f"emitted {sum(len(o) for o in outs)} tokens across {len(outs)} requests")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
