"""Trainer: the orchestration loop on one device.

Counterpart of the reference's ``repro.training.trainer``: pipeline ->
device placement -> train step -> watchdog.  Runs on ``"cuda"`` unless
``device="cpu"`` (raises without a card).  Meshes, sharding rules and
checkpointing (``mesh``, ``rules``, ``RunConfig.checkpoint_dir``) wait for
the distributed layer and ``checkpoint/manager.py`` (ROADMAP A14) and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_device
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.distributed import StepWatchdog
from repro_torch.models import ParamTree, init_params, params_from_numpy
from repro_torch.optim import warmup_cosine
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             make_train_step)

__all__ = ["Trainer", "RunConfig"]


@dataclasses.dataclass
class RunConfig:
    total_steps: int = 100
    warmup_steps: int = 10
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    seed: int = 0


class Trainer:
    """``params``: starting weights — a :class:`ParamTree`, or the
    reference's parameter tree as numpy arrays (carried by
    :func:`repro_torch.models.params_from_numpy`); None draws fresh ones
    from ``torch.Generator(device).manual_seed(run_cfg.seed)``."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 run_cfg: RunConfig, data_cfg: DataConfig, *,
                 device=None, mesh=None, rules=None,
                 watchdog: Optional[StepWatchdog] = None,
                 log_fn: Callable[[str], None] = print,
                 params=None):
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "meshes and sharding rules need the distributed layer "
                "(ROADMAP A14)")
        if run_cfg.checkpoint_dir:
            raise NotImplementedError(
                "checkpointing needs checkpoint/manager.py (ROADMAP A14)")
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.run_cfg = run_cfg
        self.device = resolve_device(device)
        self.pipeline = make_pipeline(data_cfg)
        self.log = log_fn
        self.watchdog = watchdog if watchdog is not None else StepWatchdog(
            on_straggler=lambda s, dt, med: log_fn(
                f"[watchdog] straggler step {s}: {dt:.2f}s vs median {med:.2f}s"))
        self.metrics_history: list = []
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(run_cfg.seed)
            params = init_params(gen, model_cfg)
        elif not isinstance(params, ParamTree):
            params = params_from_numpy(params, self.device)
        self.state = init_train_state(params.to(self.device), train_cfg)
        self._step = make_train_step(model_cfg, train_cfg, device=self.device)
        self.step_idx = 0

    def _place_batch(self, batch) -> dict:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def run(self, *, stop_at: Optional[int] = None) -> dict:
        """Train from the current step; ``stop_at`` ends the loop early
        without changing the LR schedule's horizon.  (No checkpoint to
        resume from until ROADMAP A14.)"""
        rc = self.run_cfg
        it = iter(self.pipeline)
        limit = rc.total_steps if stop_at is None else min(stop_at, rc.total_steps)
        while self.step_idx < limit:
            batch = self._place_batch(next(it))
            lr = warmup_cosine(self.step_idx, peak_lr=self.train_cfg.lr,
                               warmup_steps=rc.warmup_steps,
                               total_steps=rc.total_steps)
            self.watchdog.start()
            self.state, metrics = self._step(self.state, batch, lr)
            m = {k: float(v) for k, v in metrics.items()}   # waits for the card
            dt = self.watchdog.stop(self.step_idx)
            self.step_idx += 1
            if self.step_idx % rc.log_every == 0 or self.step_idx == 1:
                m["step"] = self.step_idx
                m["step_time_s"] = round(dt, 4)
                self.metrics_history.append(m)
                self.log(f"[trainer] step {self.step_idx} "
                         f"loss={m['loss']:.4f} acc={m['accuracy']:.3f} "
                         f"gnorm={m['grad_norm']:.2f} ({dt:.2f}s)")
        return {"final_step": self.step_idx,
                "history": self.metrics_history,
                "stragglers": self.watchdog.straggler_steps}
