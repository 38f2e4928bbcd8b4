"""Deterministic, shardable, checkpointable token pipeline (numpy only: a
copy of the reference's, batch for batch).

Batches are a pure function of (seed, step, host slice), so
 - any host computes exactly its slice (no coordination),
 - resume-from-checkpoint replays identically (the cursor is one integer),
 - elastic restarts with a different host count re-slice the same stream.

Two sources: "uniform" (throughput testing) and "lcg" (learnable structure:
an affine next-token rule with noise — loss measurably decreases within a
few hundred steps, used by convergence tests and the train_100m example).
A memmap-backed corpus reader covers the real-data path.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mode: str = "lcg"  # lcg | uniform | memmap
    noise: float = 0.05
    memmap_path: str | None = None


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig, *, host_id: int = 0, num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0, (cfg.global_batch, num_hosts)
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self.step = 0
        self._mm = None
        if cfg.mode == "memmap":
            assert cfg.memmap_path, "memmap mode needs a path"
            self._mm = np.memmap(cfg.memmap_path, dtype=np.int32, mode="r")

    # -- deterministic batch synthesis ---------------------------------------------

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.host_id])
        )

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        B, S, V = self.local_batch, cfg.seq_len, cfg.vocab
        if cfg.mode == "uniform":
            tokens = rng.integers(0, V, size=(B, S + 1), dtype=np.int32)
        elif cfg.mode == "memmap":
            n = len(self._mm) - (S + 1)
            starts = (
                rng.integers(0, max(n, 1), size=(B,))
                if n > 0
                else np.zeros((B,), np.int64)
            )
            tokens = np.stack([np.asarray(self._mm[s : s + S + 1]) for s in starts])
            tokens = tokens.astype(np.int32) % V
        else:  # lcg: x_{t+1} = (a x_t + c) mod V with noise
            a, c = 31, 17
            x0 = rng.integers(0, V, size=(B, 1), dtype=np.int64)
            toks = [x0]
            for _ in range(S):
                toks.append((a * toks[-1] + c) % V)
            tokens = np.concatenate(toks, axis=1).astype(np.int32)
            flip = rng.random((B, S + 1)) < cfg.noise
            noise_tok = rng.integers(0, V, size=(B, S + 1), dtype=np.int32)
            tokens = np.where(flip, noise_tok, tokens)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    # -- iteration / checkpointing --------------------------------------------------

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        assert state["seed"] == self.cfg.seed, "pipeline seed mismatch on restore"
        self.step = int(state["step"])
