"""End-to-end driver: train a ~100M-parameter dense LM for a few hundred
steps with the full woven stack — monitoring, checkpointing, preemption
safety, libVC variants — on PyTorch.  On the card the attention joinpoints
are woven to the hand-written CUDA kernels (the flash forward with its
`lse`, the fused backward).

Default flags run a CPU-sized slice; the full run is
    python examples_torch/train_100m.py --steps 300 --batch 16 --seq 256
and `--device cpu` runs on the host.  Checkpoints go to `--ckpt-dir`
(default /tmp/antarex_100m_torch: the format is not the JAX package's).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.core.program import Program
from repro_torch.core.strategies.monitoring import ExamonMonitor
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.weave import default_weave, train_kernel_aspects
from repro_torch.models.registry import build_model
from repro_torch.runtime.trainer import Trainer, TrainerConfig

CFG_100M = ModelConfig(
    name="lm-100m", family="dense", num_layers=12, d_model=768, n_heads=12,
    kv_heads=4, head_dim=64, d_ff=2048, vocab=32768, tie_embeddings=True,
)


def build_trainer(cfg: ModelConfig, device: str, *, steps: int, batch: int, seq: int,
                  ckpt_dir: str | None) -> Trainer:
    program = Program(model=build_model(cfg), cfg=cfg, kind="train", device=device)
    extra = [ExamonMonitor("train100m")]
    if program.device.type == "cuda":
        extra = train_kernel_aspects() + extra
    woven = default_weave(program, SHAPES["train_4k"], {},
                          overrides={"accum_steps": 1, "remat": "none"},
                          extra_aspects=extra)
    pipeline = TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, noise=0.02))
    return Trainer(woven, pipeline, TrainerConfig(
        steps=steps, ckpt_dir=ckpt_dir, ckpt_every=100, log_every=10))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="/tmp/antarex_100m_torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = CFG_100M
    print(f"params: {cfg.param_count()/1e6:.0f}M")
    trainer = build_trainer(cfg, args.device, steps=args.steps, batch=args.batch,
                            seq=args.seq, ckpt_dir=args.ckpt_dir)
    history = trainer.run()
    print(f"loss {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f} "
          f"({len(history)} steps, ~{history[-1]['step_time']*1e3:.0f} ms/step)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
