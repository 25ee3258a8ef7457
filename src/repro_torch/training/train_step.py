"""Training step: fused chunked LM loss, microbatch gradient accumulation,
global-norm clipping, optional int8 error-feedback gradient compression,
the QR-Muon / AdamW update.

Counterpart of the reference's ``repro.training.train_step``.  Gradients
come from autograd through plain torch ops (the reference has no custom
backward).  Memory: the (B, S, V) logits are never formed — the LM head
and softmax cross-entropy run chunk by chunk over the sequence, each
chunk recomputed in the backward pass; microbatches accumulate their
gradients, so live activations are one microbatch deep.

The step runs on ``"cuda"`` unless ``device="cpu"``.  With
``grad_compression`` the clipped gradients pass through
:func:`repro_torch.distributed.compression.ef_compress_tree` and the
residual rides in ``TrainState.ef_error``, as the reference's step does.

**On a mesh** (parameters, optimizer state and batch as DTensors, placed
by :class:`repro_torch.training.Trainer` from the sharding rules) the step
computes what the reference's GSPMD program computes, data-parallel:

  * each parameter is all-gathered whole (one redistribute a leaf, once a
    step: the reference gathers FSDP shards just in time, layer by
    layer);
  * each rank runs the model as plain tensors on its own batch shard
    (the batch's dim 0 split over the batch axes; a batch whose spec
    shards another dim, the batch-1 sequence fallback, is gathered and
    run whole on every rank: the port's attention has no sequence
    parallelism), so no DTensor op runs inside the model and no
    sharding rule of an op is needed;
  * each rank's gradients, divided by the number of batch shards, are a
    ``Partial`` sum over the batch axes (``Replicate`` over the other
    axes, whose ranks ran the same shard) and are reduce-scattered into
    the parameters' placements; the metrics are all-reduced the same way;
  * the global norm is one all-reduce of the shards' sums of squares
    (each counted once); clipping scales the local shards; the gradient
    codec runs on the whole gradients (its 256-element blocks are the
    reference's) and keeps each rank's shard of the result and of the
    residual;
  * microbatches split each rank's shard: the global microbatch must
    divide over the batch shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import QRConfig, resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.compression import (ef_compress_tree,
                                                 init_error_state)
from repro_torch.distributed.sharding import constrain_logits
from repro_torch.models.layers import softcap as apply_softcap
from repro_torch.models.transformer import (ParamTree, as_tree,
                                            forward_hidden, lm_head_weight)
from repro_torch.observability import trace as _trace
from repro_torch.optim import adamw_init, adamw_update, muon_init, muon_update

Tensor = torch.Tensor

__all__ = ["TrainConfig", "TrainState", "make_train_step", "init_train_state",
           "fused_lm_loss"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's fields, plus ``qr_config``: the QR realization of
    the Muon orthogonalization (None: the optimizer's default; e.g.
    ``QRConfig(use_kernel=False)`` runs the plain lowering)."""

    optimizer: str = "muon-qr"      # "muon-qr" | "muon-ns" | "adamw"
    lr: float = 0.02
    weight_decay: float = 0.0
    momentum: float = 0.95
    grad_clip: float = 1.0
    microbatch: int = 0             # per-call microbatch size; 0 = whole batch
    grad_compression: bool = False
    loss_chunk: int = 512           # fused-CE sequence chunk
    qr_q_method: str = "formq"      # "formq" (paper) | "solve"
    qr_shard_leaves: bool = False
    batched_ortho: bool = False     # one QR dispatch per shape class
    cast_params_once: bool = False  # bf16-cast matrix weights before the loss
    qr_config: Optional[QRConfig] = None


class TrainState(NamedTuple):
    params: ParamTree               # updated in place by the step
    opt: Any
    ef_error: Any                   # error-feedback residuals (name ->
                                    # tensor), or a 0-d zero without
                                    # compression


def _chunk_loss(xi: Tensor, head_w: Tensor, li: Tensor,
                cap: Optional[float]) -> Tuple[Tensor, Tensor]:
    logits = (xi @ head_w.to(xi.dtype)).to(torch.float32)
    logits = constrain_logits(logits)
    logits = apply_softcap(logits, cap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, li[..., None].long())[..., 0]
    correct = (logits.argmax(dim=-1) == li).to(torch.float32).sum()
    return (lse - ll).sum(), correct.detach()


def fused_lm_loss(x: Tensor, head_w: Tensor, labels: Tensor, *,
                  logit_softcap: Optional[float], chunk: int = 512
                  ) -> Tuple[Tensor, Tensor]:
    """Mean CE over (B, S) without forming (B, S, V): ``(mean_nll,
    mean_accuracy)``.  x: (B, S, d) hidden states; head_w: (d, V);
    labels: (B, S)."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    nll = x.new_zeros((), dtype=torch.float32)
    acc = x.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk):
        args = (x[:, c0:c0 + chunk], head_w, labels[:, c0:c0 + chunk],
                logit_softcap)
        if torch.is_grad_enabled():
            n, a = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            n, a = _chunk_loss(*args)
        nll = nll + n
        acc = acc + a
    n = b * s
    return nll / n, acc / n


def _cast_params_tree(tree):
    """bf16-cast the >= 2-D fp32 leaves once per step (the reference's
    ``cast_params_once``); gradients flow through the cast."""
    if isinstance(tree, dict):
        return {k: _cast_params_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_cast_params_tree(v) for v in tree)
    if tree.dtype == torch.float32 and tree.ndim >= 2:
        return tree.to(torch.bfloat16)
    return tree


def _loss_fn(params, batch, model_cfg: ModelConfig, train_cfg: TrainConfig):
    tree = as_tree(params)
    if train_cfg.cast_params_once:
        tree = _cast_params_tree(tree)
    x, aux = forward_hidden(tree, batch, model_cfg)
    head = lm_head_weight(tree, model_cfg)
    nll, acc = fused_lm_loss(x, head, batch["labels"],
                             logit_softcap=model_cfg.logit_softcap,
                             chunk=train_cfg.loss_chunk)
    loss = nll + aux
    return loss, {"nll": nll.detach(), "aux": aux.detach(),
                  "accuracy": acc.detach()}


def _sum_squares(grads: Dict[str, Tensor]) -> Tensor:
    """The sum of every gradient entry's square; on DTensors one
    all-reduce of the shards' sums, a shard replicated over r ranks
    counted 1/r on each."""
    g0 = next(iter(grads.values()))
    if not isinstance(g0, DTensor):
        return sum(torch.sum(torch.square(g.to(torch.float32)))
                   for g in grads.values())
    mesh = g0.device_mesh
    local = sum(torch.sum(torch.square(g.to_local().to(torch.float32)))
                / math.prod(mesh.size(i) for i, p in enumerate(g.placements)
                            if not isinstance(p, Shard))
                for g in grads.values())
    return sharding.mesh_sum(local, mesh)


def _clip_by_global_norm(grads: Dict[str, Tensor], max_norm: float):
    if max_norm <= 0:
        g0 = next(iter(grads.values()))
        return grads, torch.zeros((), dtype=torch.float32, device=g0.device)
    norm = torch.sqrt(_sum_squares(grads))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: sharding.map_local(lambda x: x * scale, g)
            for k, g in grads.items()}, norm


def _compress(grads: Dict[str, Tensor], ef):
    """The error-feedback codec; DTensor gradients and residuals go
    through it whole and come back as their shards."""
    g0 = next(iter(grads.values()))
    if not isinstance(g0, DTensor):
        return ef_compress_tree(grads, ef)
    dec, res = ef_compress_tree(
        {k: sharding.full_tensor(g) for k, g in grads.items()},
        {k: sharding.full_tensor(e) for k, e in ef.items()})
    return ({k: sharding.shard_like(dec[k], g) for k, g in grads.items()},
            {k: sharding.shard_like(res[k], e) for k, e in ef.items()})


def init_train_state(params: ParamTree, train_cfg: TrainConfig) -> TrainState:
    named = {k: p.detach() for k, p in params.named_parameters()}
    if train_cfg.optimizer.startswith("muon"):
        opt = muon_init(named)
    elif train_cfg.optimizer == "adamw":
        opt = adamw_init(named)
    else:
        raise ValueError(f"unknown optimizer {train_cfg.optimizer!r}")
    leaf = next(iter(named.values()))
    ef = (init_error_state(named) if train_cfg.grad_compression else
          torch.zeros((), dtype=torch.float32, device=leaf.device))
    return TrainState(params=params, opt=opt, ef_error=ef)


def _autograd(loss, leaves):
    """Gradients of every leaf; zeros for a leaf the loss does not use
    (an embedding-input model's token table), as the reference's."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def _accumulate(params, leaves, batch, n_micro: int, model_cfg, train_cfg):
    """``(loss, metrics, grads)`` of ``params`` (a tree whose tensors are
    ``leaves``) on ``batch``: whole, or in ``n_micro`` microbatches whose
    gradients and metrics average."""
    if n_micro == 1:
        loss, metrics = _loss_fn(params, batch, model_cfg, train_cfg)
        return loss.detach(), metrics, list(_autograd(loss, leaves))
    mb = batch["labels"].shape[0] // n_micro
    grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    loss_a = leaves[0].new_zeros((), dtype=torch.float32)
    metrics_a = {"nll": 0.0, "aux": 0.0, "accuracy": 0.0}
    for i in range(n_micro):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, metrics = _loss_fn(params, part, model_cfg, train_cfg)
        for acc, g in zip(grads, _autograd(loss, leaves)):
            acc += g.to(torch.float32) / n_micro
        metrics_a = {k: metrics_a[k] + metrics[k] / n_micro
                     for k in metrics_a}
        loss_a = loss_a + loss.detach() / n_micro
    return loss_a, metrics_a, grads


def _n_micro(b: int, mb: int) -> int:
    if mb <= 0 or mb >= b:
        return 1
    if b % mb != 0:
        raise ValueError(f"batch {b} not divisible by microbatch {mb}")
    return b // mb


def _grads(params: ParamTree, batch, model_cfg, train_cfg):
    """``(loss, metrics, grads)``: the whole batch, or microbatches whose
    gradients and metrics average."""
    names, leaves = zip(*params.named_parameters())
    if isinstance(leaves[0], DTensor):
        return _mesh_grads(params, names, leaves, batch, model_cfg, train_cfg)
    n_micro = _n_micro(batch["labels"].shape[0], train_cfg.microbatch)
    loss, metrics, grads = _accumulate(params, leaves, batch, n_micro,
                                       model_cfg, train_cfg)
    return loss, metrics, dict(zip(names, grads))


def _local_batch(batch):
    """``(local batch, batch mesh dims)``: each rank's shard when the
    batch is split along dim 0 only, else the whole batch (and no batch
    dims)."""
    places = {tuple(v.placements) for v in batch.values()}
    (first, *rest) = places
    if not rest and all(p == Shard(0) or isinstance(p, Replicate)
                        for p in first):
        return ({k: v.to_local() for k, v in batch.items()},
                [i for i, p in enumerate(first) if p == Shard(0)])
    return {k: sharding.full_tensor(v) for k, v in batch.items()}, []


def _mesh_grads(params: ParamTree, names, leaves, batch, model_cfg,
                train_cfg):
    """The data-parallel step's gradients on a mesh (module docstring):
    whole parameters, the rank's batch shard, gradients reduce-scattered
    into the parameters' placements, metrics all-reduced."""
    from repro_torch.models.transformer import map_tree

    mesh = leaves[0].device_mesh
    local, dims = _local_batch(batch)
    shards = math.prod(mesh.size(i) for i in dims)
    n_micro = _n_micro(batch["labels"].shape[0], train_cfg.microbatch)
    if local["labels"].shape[0] % n_micro:
        raise ValueError(
            f"microbatch {train_cfg.microbatch} does not divide over the "
            f"{shards} batch shards")
    whole = [sharding.full_tensor(p.detach()).requires_grad_(True)
             for p in leaves]
    by_id = {id(p): w for p, w in zip(leaves, whole)}
    tree = map_tree(lambda t: by_id[id(t)], params.tree())
    loss, metrics, grads = _accumulate(tree, whole, local, n_micro,
                                       model_cfg, train_cfg)
    partial = [Partial() if i in dims else Replicate()
               for i in range(mesh.ndim)]
    out = {k: sharding.redistribute(DTensor.from_local(
               g / shards, mesh, partial, run_check=False), p.placements)
           for k, p, g in zip(names, leaves, grads)}
    keys = ("nll", "aux", "accuracy")
    vals = sharding.mesh_sum(torch.stack(
        [loss] + [metrics[k] for k in keys]).to(torch.float32) / shards,
        mesh, dims)
    return vals[0], dict(zip(keys, vals[1:])), out


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, *,
                    device=None, rules=None):
    """``train_step(state, batch, lr) -> (state, metrics)`` on ``device``
    ("cuda" unless the caller asks for the CPU; raises without a card).
    ``rules``: the mesh's sharding rules when the state is placed on one
    (QR-Muon's ``qr_shard_leaves`` shards its stacks by them).
    ``batch`` holds tensors on that device; the parameters update in
    place, the optimizer state is replaced."""
    dev = resolve_device(device)

    def train_step(state: TrainState, batch, lr):
        with _trace.span("train.fwd_bwd") as sp:
            loss, metrics, grads = sp.sync(_grads(state.params, batch,
                                                  model_cfg, train_cfg))
        ef = state.ef_error
        with _trace.span("train.optimizer", optimizer=train_cfg.optimizer,
                         batched_ortho=train_cfg.batched_ortho) as sp:
            grads, gnorm = _clip_by_global_norm(grads, train_cfg.grad_clip)
            if train_cfg.grad_compression:
                with _trace.span("train.grad_compression"):
                    grads, ef = _compress(grads, ef)
            new, opt = sp.sync(_update(state, grads, lr))
        with torch.no_grad():
            for k, p in state.params.named_parameters():
                p.copy_(new[k])
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(params=state.params, opt=opt, ef_error=ef), metrics

    def _update(state: TrainState, grads, lr):
        params = {k: p.detach() for k, p in state.params.named_parameters()}
        if train_cfg.optimizer == "adamw":
            new, opt = adamw_update(grads, state.opt, params, lr=lr,
                                    weight_decay=train_cfg.weight_decay)
        else:
            method = "qr" if train_cfg.optimizer.endswith("qr") else "ns"
            new, opt = muon_update(grads, state.opt, params, lr=lr,
                                   momentum=train_cfg.momentum,
                                   weight_decay=train_cfg.weight_decay,
                                   method=method,
                                   qr_q_method=train_cfg.qr_q_method,
                                   qr_shard_leaves=train_cfg.qr_shard_leaves,
                                   qr_config=train_cfg.qr_config,
                                   batched_ortho=train_cfg.batched_ortho,
                                   rules=rules, device=dev)
        return new, opt

    return train_step
