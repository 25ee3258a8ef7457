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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import QRConfig, resolve_device
from repro_torch.distributed.compression import (ef_compress_tree,
                                                 init_error_state)
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


def _clip_by_global_norm(grads: Dict[str, Tensor], max_norm: float):
    if max_norm <= 0:
        g0 = next(iter(grads.values()))
        return grads, torch.zeros((), dtype=torch.float32, device=g0.device)
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


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


def _grads(params: ParamTree, batch, model_cfg, train_cfg):
    """``(loss, metrics, grads)``: the whole batch, or microbatches whose
    gradients and metrics average."""
    names, leaves = zip(*params.named_parameters())
    mb = train_cfg.microbatch
    b = batch["labels"].shape[0]
    if mb <= 0 or mb >= b:
        loss, metrics = _loss_fn(params, batch, model_cfg, train_cfg)
        grads = _autograd(loss, leaves)
        return loss.detach(), metrics, dict(zip(names, grads))
    if b % mb != 0:
        raise ValueError(f"batch {b} not divisible by microbatch {mb}")
    n_micro = b // mb
    grads = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in zip(names, leaves)}
    loss_a = leaves[0].new_zeros((), dtype=torch.float32)
    metrics_a = {"nll": 0.0, "aux": 0.0, "accuracy": 0.0}
    for i in range(n_micro):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, metrics = _loss_fn(params, part, model_cfg, train_cfg)
        for k, g in zip(names, _autograd(loss, leaves)):
            grads[k] += g.to(torch.float32) / n_micro
        metrics_a = {k: metrics_a[k] + metrics[k] / n_micro
                     for k in metrics_a}
        loss_a = loss_a + loss.detach() / n_micro
    return loss_a, metrics_a, grads


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, *,
                    device=None):
    """``train_step(state, batch, lr) -> (state, metrics)`` on ``device``
    ("cuda" unless the caller asks for the CPU; raises without a card).
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
                with _trace.span("train.grad_compression") as codec:
                    grads, ef = codec.sync(ef_compress_tree(grads, ef))
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
                                   device=dev)
        return new, opt

    return train_step
