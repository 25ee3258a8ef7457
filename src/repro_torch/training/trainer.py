"""Trainer: the fault-tolerant orchestration loop.

Counterpart of the reference's ``repro.training.trainer``: pipeline ->
device placement (mesh placements) -> train step -> watchdog ->
asynchronous checkpoints.  Restart-safe: :meth:`Trainer.run` resumes
from the latest committed checkpoint (parameters, optimizer state,
error-feedback residuals, the data cursor and the step index) and
replays the same batches.  Runs on ``"cuda"`` unless ``device="cpu"``
(raises without a card).

With ``mesh`` (a ``DeviceMesh`` with named dims over the process group;
every rank builds the same trainer) the parameters and optimizer state
are placed by :func:`repro_torch.distributed.sharding.param_specs` and
``state_specs`` as DTensors, each rank slicing its shard out of the same
starting weights, and each batch by ``batch_specs``.  Steps run under
the rules' activation policy; checkpoints hold whole tensors, so a run
restores onto any mesh (resharding) or onto one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_device
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.distributed import StepWatchdog
from repro_torch.distributed import sharding
from repro_torch.models import ParamTree, init_params, params_from_numpy
from repro_torch.observability import trace as _trace
from repro_torch.optim import warmup_cosine
from repro_torch.training.train_step import (TrainConfig, TrainState,
                                             init_train_state,
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
    from ``torch.Generator(device).manual_seed(run_cfg.seed)``.
    ``mesh`` / ``rules``: a ``DeviceMesh`` of the device's type and its
    :class:`~repro_torch.distributed.sharding.MeshRules` (either one
    implies the other with the default rules)."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 run_cfg: RunConfig, data_cfg: DataConfig, *,
                 device=None, mesh=None, rules=None,
                 watchdog: Optional[StepWatchdog] = None,
                 log_fn: Callable[[str], None] = print,
                 params=None):
        if rules is not None and mesh is None:
            mesh = rules.mesh
        if mesh is not None and rules is None:
            rules = sharding.MeshRules(mesh)
        self.mesh, self.rules = mesh, rules
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.run_cfg = run_cfg
        self.device = resolve_device(device)
        self.pipeline = make_pipeline(data_cfg)
        self.log = log_fn
        self.watchdog = watchdog if watchdog is not None else StepWatchdog(
            on_straggler=lambda s, dt, med: log_fn(
                f"[watchdog] straggler step {s}: {dt:.2f}s vs median {med:.2f}s"))
        self.ckpt = (CheckpointManager(run_cfg.checkpoint_dir)
                     if run_cfg.checkpoint_dir else None)
        self.metrics_history: list = []
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(run_cfg.seed)
            params = init_params(gen, model_cfg)
        elif not isinstance(params, ParamTree):
            params = params_from_numpy(params, self.device)
        state = init_train_state(params.to(self.device), train_cfg)
        if mesh is not None:
            state = self._place_state(state)
        self.state = state
        self._step = make_train_step(model_cfg, train_cfg, device=self.device,
                                     rules=self.rules)
        self.step_idx = 0

    def _place_state(self, state: TrainState) -> TrainState:
        """The state as DTensors on the mesh (the reference's
        ``param_specs`` / ``state_specs`` placement)."""
        if self.mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {self.mesh.device_type!r}, the "
                             f"trainer on {self.device.type!r}")
        tree = state.params.tree()
        pspecs = sharding.param_specs(tree, self.rules)
        params = ParamTree(sharding.distribute_tree(tree, pspecs, self.mesh))

        def place(sub):
            return sharding.distribute_tree(
                sub, sharding.state_specs(tree, pspecs, sub, self.rules),
                self.mesh)

        return TrainState(params=params, opt=place(state.opt),
                          ef_error=place(state.ef_error))

    # -------------------------------------------------------------- ckpt

    def checkpoint_tree(self) -> TrainState:
        """What a checkpoint holds: the state with the parameters as the
        reference's tree (``.params[...]``, ``.opt``, ``.ef_error``)."""
        s = self.state
        return TrainState(params=s.params.tree(), opt=s.opt,
                          ef_error=s.ef_error)

    def _save(self, blocking=False) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self.step_idx, self.checkpoint_tree(),
                       metadata={"data": self.pipeline.state_dict(),
                                 "step": self.step_idx},
                       blocking=blocking)

    def maybe_restore(self) -> bool:
        """Load the latest committed checkpoint, if any: parameters (in
        place), optimizer state, residuals, data cursor, step index."""
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        meta = self.ckpt.metadata(latest)
        got = self.ckpt.restore(latest, self.checkpoint_tree())
        with torch.no_grad():
            _copy_into(self.state.params.tree(), got.params)
        self.state = TrainState(params=self.state.params, opt=got.opt,
                                ef_error=got.ef_error)
        self.pipeline.load_state_dict(meta["data"])
        self.step_idx = int(meta["step"])
        self.log(f"[trainer] restored step {self.step_idx}")
        return True

    # --------------------------------------------------------------- run

    def _place_batch(self, batch) -> dict:
        out = {k: torch.from_numpy(np.asarray(v)).to(self.device)
               for k, v in batch.items()}
        if self.mesh is not None:
            out = sharding.distribute_tree(
                out, sharding.batch_specs(out, self.rules), self.mesh)
        return out

    def run(self, *, resume: bool = True,
            stop_at: Optional[int] = None) -> dict:
        """Train from the latest checkpoint (``resume``) or the current
        step; ``stop_at`` ends the loop early (a crash, a partial run)
        without changing the LR schedule's horizon.  Saves every
        ``checkpoint_every`` steps without blocking, and at the end."""
        with (sharding.activation_policy(self.rules) if self.rules
              is not None else contextlib.nullcontext()):
            return self._run(resume, stop_at)

    def _run(self, resume: bool, stop_at: Optional[int]) -> dict:
        if resume:
            self.maybe_restore()
        rc = self.run_cfg
        it = iter(self.pipeline)
        limit = rc.total_steps if stop_at is None else min(stop_at, rc.total_steps)
        while self.step_idx < limit:
            with _trace.span("train.data"):
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
            if self.ckpt and self.step_idx % rc.checkpoint_every == 0:
                self._save(blocking=False)
        if self.ckpt:
            self._save(blocking=True)
            self.ckpt.wait_until_finished()
        return {"final_step": self.step_idx,
                "history": self.metrics_history,
                "stragglers": self.watchdog.straggler_steps}


def _copy_into(dst, src) -> None:
    """Copy the tensors of tree ``src`` into those of ``dst``, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        dst.copy_(src)
