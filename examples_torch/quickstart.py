"""Quickstart: the ANTAREX separation of concerns in ~40 lines, on PyTorch.

The domain expert picks a model (functional code, untouched); the HPC expert
weaves extra-functional aspects; the runtime trains with monitoring and
checkpointing.  On the card the attention joinpoints are woven to the
hand-written CUDA kernels: the flash forward with its `lse` and the fused
backward.

    python examples_torch/quickstart.py                 # on the card
    python examples_torch/quickstart.py --device cpu    # on the host
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.program import Program
from repro_torch.core.strategies.monitoring import ExamonMonitor
from repro_torch.core.strategies.parallelization import AccumAspect, RematAspect
from repro_torch.core.strategies.precision import ChangePrecision
from repro_torch.core.weaver import WovenProgram, weave
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.weave import train_kernel_aspects
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def build(device: str = "cuda") -> WovenProgram:
    # 1. functional code: a (reduced) yi-6b — never edited by what follows
    program = Program.from_arch("yi-6b", kind="train", reduced=True, device=device)

    # 2. extra-functional concerns, woven as aspects (paper §2)
    aspects = [
        ChangePrecision("*", "half"),       # §2.2 precision tuning
        RematAspect("none"),                # parallelization knobs
        AccumAspect(1),
        ExamonMonitor("quickstart"),        # §2.6 monitoring
    ]
    if program.device.type == "cuda":
        aspects += train_kernel_aspects()   # the hand-written attention kernels
    return weave(program, aspects)


def build_trainer(woven: WovenProgram) -> Trainer:
    # 3. run: monitored, checkpointed, fault-tolerant
    pipeline = TokenPipeline(PipelineConfig(
        vocab=woven.program.cfg.vocab, seq_len=32, global_batch=8))
    return Trainer(woven, pipeline, TrainerConfig(steps=30, log_every=10))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    woven = build(args.device)
    print(woven.report.table())             # paper Tables 1-2 metrics
    history = build_trainer(woven).run()
    print(f"loss: {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
