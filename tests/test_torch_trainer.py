"""PyTorch port, the training runtime: the reference's end-to-end training
behaviour (`tests/test_system.py::TestTraining`, `TestMonitoringIntegration`)
on the port's `Trainer` — the loss falls, a checkpoint restart resumes
exactly, preemption checkpoints and stops, the ExaMon sensors publish — and
the checkpointer's own contract: bf16 leaves round-trip bit for bit, `keep`
is honoured, a failed write leaves no manifest, one writer at a time."""

import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import SHAPES
from repro_torch.core.program import Program
from repro_torch.core.strategies.monitoring import ExamonMonitor
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.weave import default_weave
from repro_torch.monitor.examon import ExamonBroker, ExamonCollector
from repro_torch.optim.tree import leaves
from repro_torch.runtime.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


def _trainer(tmp_path=None, steps=30, arch="yi-6b", margot=None, broker=None):
    program = Program.from_arch(arch, kind="train", reduced=True, device="cpu")
    woven = default_weave(program, SHAPES["train_4k"], {},
                          overrides={"accum_steps": 1},
                          extra_aspects=[ExamonMonitor("train", broker=broker)])
    pipeline = TokenPipeline(PipelineConfig(
        vocab=program.cfg.vocab, seq_len=32, global_batch=8, noise=0.02))
    cfg = TrainerConfig(steps=steps, log_every=0,
                        ckpt_dir=str(tmp_path) if tmp_path else None,
                        ckpt_every=10)
    return Trainer(woven, pipeline, cfg, margot=margot, broker=broker)


class TestTraining:
    def test_loss_decreases(self):
        trainer = _trainer(steps=40)
        history = trainer.run()
        first = np.mean([h["loss"] for h in history[:5]])
        last = np.mean([h["loss"] for h in history[-5:]])
        assert last < first - 0.2, (first, last)

    def test_checkpoint_restart_exact_resume(self, tmp_path):
        t1 = _trainer(tmp_path, steps=20)
        t1.run()
        t1.save(blocking=True)
        # a fresh trainer restores and continues identically to a straight run
        t2 = _trainer(tmp_path, steps=0)
        assert t2.maybe_restore()
        assert t2.step == 20
        assert t2.pipeline.step == t1.pipeline.step
        h2 = t2.run(10)
        t3 = _trainer(steps=30)
        h3 = t3.run()
        assert h2[-1]["loss"] == pytest.approx(h3[-1]["loss"], rel=0.02)
        # the same arithmetic on the same restored state: the same losses
        np.testing.assert_allclose([h["loss"] for h in h2],
                                   [h["loss"] for h in h3[20:]], rtol=1e-6)

    def test_preemption_checkpoints_and_stops(self, tmp_path):
        t = _trainer(tmp_path, steps=1000)
        t.preemption.request()
        t.run()
        assert t.step <= 1
        assert t.watchdog_timeouts == 0
        assert Checkpointer(str(tmp_path)).latest_step() == t.step

    def test_margot_hooks_pick_variants_and_observe(self):
        class Op:
            knobs = {"variant": None}

        class Margot:  # duck-typed, as the reference's trainer takes it
            def __init__(self):
                self.observed = []

            def update(self):
                return Op()

            def observe(self, metric, value):
                self.observed.append((metric, value))

        margot = Margot()
        t = _trainer(steps=3, margot=margot, broker=ExamonBroker())
        t.run()
        assert [m for m, _ in margot.observed] == ["step_time"] * 3
        assert all(v > 0 for _, v in margot.observed)
        assert t.libvc.dispatch_counts == {"__default__": 3}


class TestMonitoringIntegration:
    def test_sensors_publish_during_training(self):
        broker = ExamonBroker()
        coll = ExamonCollector("c", "train/step_time/*").init(broker)
        coll.start()
        beats = ExamonCollector("h", "fleet/heartbeat/*").init(broker)
        beats.start()
        trainer = _trainer(steps=5, broker=broker)
        trainer.run()
        assert coll.count() == 5
        assert coll.get_mean() > 0
        assert beats.count() == 5


class TestCheckpointer:
    def _tree(self):
        g = torch.Generator().manual_seed(0)
        return {"params": {"w": torch.randn((5, 7), generator=g).to(torch.bfloat16),
                           "norm": torch.randn((7,), generator=g)},
                "opt": {"count": torch.tensor(3, dtype=torch.int32)},
                "data": {"step": np.asarray(11)}}

    def test_round_trip_is_bit_for_bit(self, tmp_path):
        tree = self._tree()
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(4, tree, meta={"arch": "x"})  # async
        ckpt.wait()
        template = {"params": {"w": torch.zeros((5, 7), dtype=torch.bfloat16),
                               "norm": torch.zeros(7)},
                    "opt": {"count": torch.tensor(0, dtype=torch.int32)},
                    "data": {"step": np.asarray(0)}}
        got, manifest = ckpt.restore(template)
        assert manifest["step"] == 4 and manifest["meta"] == {"arch": "x"}
        assert manifest["dtypes"]["params::w"] == "bfloat16"
        for a, b in zip(leaves(got["params"]) + leaves(got["opt"]),
                        leaves(tree["params"]) + leaves(tree["opt"])):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert isinstance(got["data"]["step"], np.ndarray) and got["data"]["step"] == 11
        saved = np.load(os.path.join(tmp_path, "ckpt_4", "arrays", "params::w.npy"))
        assert saved.dtype == np.uint16  # raw bf16 bits, as the reference stores them

    def test_keep_newest(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), keep=2)
        for step in range(5):
            ckpt.save(step, self._tree(), blocking=step % 2 == 0)
        ckpt.wait()
        assert ckpt.all_steps() == [3, 4]
        assert sorted(os.listdir(tmp_path)) == ["ckpt_3", "ckpt_4"]

    def test_failed_write_leaves_no_manifest(self, tmp_path, monkeypatch):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, self._tree(), blocking=True)

        def broken(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(ckpt_mod.np, "save", broken)
        ckpt.save(2, self._tree())  # async: the error surfaces at wait()
        with pytest.raises(OSError, match="disk full"):
            ckpt.wait()
        assert ckpt.latest_step() == 1
        assert sorted(os.listdir(tmp_path)) == ["ckpt_1"]  # no tmp dir left
        with pytest.raises(FileNotFoundError):
            Checkpointer(str(tmp_path / "empty")).restore(self._tree())
