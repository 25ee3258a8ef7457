"""Data pipeline: deterministic, shardable, resumable token streams.

Two sources:
  * ``SyntheticLM`` — Philox-keyed synthetic token streams.  Fully
    deterministic in (seed, step, sample-index), so a restart from a
    checkpointed ``step`` reproduces the exact batch sequence regardless
    of world size or interruption point (the fault-tolerance contract).
  * ``MemmapCorpus`` — fixed-window sampling from a flat token file
    (np.memmap), deterministic in the same way.

Batches are host-built numpy, bit-identical to the reference's
``repro.data.pipeline`` (this module is its copy); the trainer moves them
to its device.  For the
embedding-input (vlm/audio stub) architectures, the pipeline synthesizes
frame/patch embeddings from the token stream (the frontend stub).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "MemmapCorpus", "make_pipeline"]


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embedding_input: bool = False
    d_model: int = 0              # needed when embedding_input
    path: Optional[str] = None    # memmap corpus path


class SyntheticLM:
    """Deterministic synthetic LM stream with a causal-learnable structure
    (next token depends on previous ones mod vocab), so optimizers show a
    real loss decrease in the examples."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.step = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        assert state["seed"] == self.cfg.seed, "data seed mismatch on restore"
        self.step = int(state["step"])

    def _batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=step))
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        # structured stream: x_{t} = (x_{t-1} * 31 + x_{t-7} + noise) % V
        x = rng.integers(0, v, size=(b, s + 8), dtype=np.int64)
        for t in range(8, s + 8):
            x[:, t] = (x[:, t - 1] * 31 + x[:, t - 7] +
                       (rng.integers(0, 4, size=b))) % v
        tokens = x[:, 7 : 7 + s].astype(np.int32)
        labels = x[:, 8 : 8 + s].astype(np.int32)
        out = {"tokens": tokens, "labels": labels}
        if cfg.embedding_input:
            emb_rng = np.random.Generator(
                np.random.Philox(key=cfg.seed + 1, counter=step))
            proj = emb_rng.standard_normal((64, cfg.d_model)).astype(np.float32)
            feats = (tokens[..., None] % 64 == np.arange(64)).astype(np.float32)
            out["embeds"] = (feats @ proj * 0.1).astype(np.float32)
            del out["tokens"]
        return out

    def __iter__(self) -> Iterator[dict]:
        # increment BEFORE yield: generator suspension must not leave the
        # checkpointable cursor stale by one (a consumed batch would be
        # replayed after restore).
        while True:
            b = self._batch_at(self.step)
            self.step += 1
            yield b

    def peek(self, step: int) -> dict:
        return self._batch_at(step)


class MemmapCorpus:
    """Deterministic window sampler over a flat int32 token file."""

    def __init__(self, cfg: DataConfig):
        if cfg.path is None:
            raise ValueError("MemmapCorpus needs cfg.path")
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.step = 0
        if len(self.tokens) < cfg.seq_len + 1:
            raise ValueError("corpus shorter than seq_len")

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])

    def _batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=step))
        starts = rng.integers(0, len(self.tokens) - cfg.seq_len - 1,
                              size=cfg.global_batch)
        rows = np.stack([self.tokens[s : s + cfg.seq_len + 1] for s in starts])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self._batch_at(self.step)
            self.step += 1
            yield b


def make_pipeline(cfg: DataConfig):
    return MemmapCorpus(cfg) if cfg.path else SyntheticLM(cfg)
