"""Training launcher with restart-on-failure (fault-tolerant outer loop).

    python -m repro_torch.launch.train --arch gemma-2b --steps 6 --batch 4 \
        --seq 1024 --set accum_steps=2                        # full width, the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \
        --steps 3                                             # reduced, the host

The reference's flags, plus `--device` (default `cuda`; without a card it
raises — pass `--device cpu` to run on the host).  On the card the attention
joinpoints are woven to the CUDA kernels (K1 forward with `lse`, the fused
backward K3); every other op runs its plain PyTorch implementation, since
the RMSNorm, RG-LRU and WKV kernels are forward-only, as in the reference.
The dense, MoE, VLM, hybrid (recurrentgemma-2b: each unrolled block
checkpointed whole) and ssm (rwkv6-3b) families train here, on either
device, under every woven remat policy (`none`, `full`, `dots`,
`dots_no_batch`).  Two limits: grok-1-314b's training state does not fit
one 80 GB card at full width even cut to one layer (4.83 B expert, 0.09 B
attention and 0.81 B embedding parameters at 16-18 bytes each: 92-103 GB),
so it trains reduced or on the host; and the encoder-decoder
(whisper-small) does not train through this launcher, because the token
pipeline makes no `frames` for its encoder — drive `runtime/steps.
build_train_step` with frames in the batch instead.  A step failure
restores the latest checkpoint and resumes (bounded retries).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import SHAPES
from repro_torch.core.program import Program
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.weave import default_weave, train_kernel_aspects
from repro_torch.models.registry import ARCHS, get_config
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def parse_overrides(sets: list[str]) -> dict:
    overrides = {}
    for kv in sets:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = json.loads(v)
        except json.JSONDecodeError:
            overrides[k] = v
    overrides.setdefault("accum_steps", 1)
    return overrides


def build_trainer(arch: str, *, reduced: bool, device: str, batch: int, seq: int,
                  mode: str = "lcg", overrides: dict | None = None,
                  tcfg: TrainerConfig | None = None, extra_aspects=None,
                  lr_fn=None, broker=None, mesh=None) -> Trainer:
    """The launcher's trainer for `arch` (`program_trainer`)."""
    if get_config(arch).family == "encdec":
        raise NotImplementedError(
            f"{arch} does not train through the launcher: the token pipeline "
            "makes no `frames` for its encoder (drive runtime/steps."
            "build_train_step with frames in the batch)")
    program = Program.from_arch(arch, kind="train", reduced=reduced, device=device)
    return program_trainer(program, batch=batch, seq=seq, mode=mode,
                           overrides=overrides, tcfg=tcfg,
                           extra_aspects=extra_aspects, lr_fn=lr_fn, broker=broker,
                           mesh=mesh)


def program_trainer(program: Program, *, batch: int, seq: int, mode: str = "lcg",
                    overrides: dict | None = None, tcfg: TrainerConfig | None = None,
                    extra_aspects=None, lr_fn=None, broker=None, mesh=None) -> Trainer:
    """A trainer over a built `program` (a published config, or one cut in
    depth): `default_weave` for the train shape, the attention kernels
    woven on the card, the token pipeline at (batch, seq) — on `mesh`, this
    rank's trainer of a live mesh, laid out as AutoShard picks or as
    `overrides` (`rules`) and `extra_aspects` (an `AutoShard(layout=...)`)
    say."""
    aspects = list(extra_aspects or [])
    if program.device.type == "cuda":
        aspects = train_kernel_aspects() + aspects
    woven = default_weave(program, SHAPES["train_4k"],
                          dict(mesh.shape) if mesh is not None else {},
                          overrides=dict(overrides or {"accum_steps": 1}),
                          extra_aspects=aspects)
    pipeline = TokenPipeline(PipelineConfig(
        vocab=program.cfg.vocab, seq_len=seq, global_batch=batch, mode=mode))
    return Trainer(woven, pipeline, tcfg or TrainerConfig(), lr_fn=lr_fn,
                   broker=broker, mesh=mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="yi-6b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mode", default="lcg", choices=("lcg", "uniform", "memmap"))
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--set", dest="sets", action="append", default=[])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.sets)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every)

    # fault-tolerant outer loop: any step-level failure restores the latest
    # checkpoint and resumes (bounded retries)
    attempts = 0
    while True:
        trainer = build_trainer(args.arch, reduced=args.reduced, device=args.device,
                                batch=args.batch, seq=args.seq, mode=args.mode,
                                overrides=overrides, tcfg=tcfg)
        try:
            history = trainer.run(args.steps - trainer.step
                                  if trainer.maybe_restore() else args.steps)
            break
        except Exception as e:  # noqa: BLE001 - launcher-level barrier
            attempts += 1
            print(f"step failure ({e!r}); restart {attempts}/{args.max_retries}")
            if attempts > args.max_retries:
                raise
    if history:
        first, last = history[0], history[-1]
        print(f"loss {first.get('loss'):.4f} -> {last.get('loss'):.4f} over "
              f"{len(history)} steps on {trainer.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
