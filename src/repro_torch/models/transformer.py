"""Decoder stack of the port: the ``attn`` / ``attn_local`` mixers with
``dense`` / ``none`` FFNs, in any period pattern.

Counterpart of the reference's ``repro.models.transformer`` for training:
``init_params``, ``forward_hidden``, ``lm_head_weight``,
``forward_train`` and ``param_count``.  Parameters keep the reference's
tree — one leaf per period position, stacked over ``n_periods`` — inside
a :class:`ParamTree` module, whose ``named_parameters()`` are the
reference's paths (``embed.table``, ``layers.0.mixer.wq.w``, ...), so the
optimizer routes the same names and shapes.  The stack is a loop over
periods; each stacked leaf is unbound once a forward pass, so its
gradient is stacked once.  ``cfg.remat`` is not applied (ROADMAP C).
Hidden states pass :func:`repro_torch.distributed.sharding.
constrain_hidden` after the embedding and at each period, the
reference's sites (its third, in prefill, comes with prefill).

The ``mamba``, ``mlstm`` and ``slstm`` mixers, the ``moe`` FFN, prefill
and decode wait for ROADMAP A16 and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed.sharding import constrain_hidden
from repro_torch.models import attention
from repro_torch.models.layers import (
    apply_norm, dense, dense_init, embed, embedding_init, ffn, ffn_init,
    model_dtype, norm_init, softcap,
)

Tensor = torch.Tensor

__all__ = ["ParamTree", "init_params", "forward_hidden", "lm_head_weight",
           "forward_train", "forward_prefill", "forward_decode",
           "param_count", "as_tree"]

_MIXERS = ("attn", "attn_local")
_FFNS = ("dense", "none")


def _a16(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP A16: the other mixers, MoE, "
        f"prefill and decode)")


class ParamTree(nn.Module):
    """A nested dict / tuple of fp32 tensors as a module: each tensor a
    parameter, each subtree a child module, named by its key (tuple
    positions by index)."""

    def __init__(self, tree):
        super().__init__()
        self._seq = isinstance(tree, (tuple, list))
        self._keys = []
        for k, v in (enumerate(tree) if self._seq else tree.items()):
            k = str(k)
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v))
            else:
                self.add_module(k, ParamTree(v))
            self._keys.append(k)

    def tree(self):
        """The nested dict / tuple of parameters, the reference's tree."""
        out = []
        for k in self._keys:
            v = getattr(self, k)
            out.append(v.tree() if isinstance(v, ParamTree) else v)
        return tuple(out) if self._seq else dict(zip(self._keys, out))


def as_tree(params):
    """The parameter tree of a :class:`ParamTree`, or ``params`` itself."""
    return params.tree() if isinstance(params, ParamTree) else params


def map_tree(fn, tree):
    """``tree`` (nested dicts and tuples) with ``fn`` applied to each
    leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(map_tree(fn, v) for v in tree)
    return fn(tree)


def _unstack(tree, n: int):
    """``n`` trees, the slices of a period-stacked tree (each leaf
    unbound once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ------------------------------------------------------------------ init

def _layer_init(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec) -> dict:
    dev = gen.device
    if spec.mixer not in _MIXERS:
        raise _a16(f"the {spec.mixer!r} mixer")
    if spec.ffn not in _FFNS:
        raise _a16(f"the {spec.ffn!r} FFN")
    p: dict = {"norm1": norm_init(cfg.d_model, cfg.norm, dev),
               "mixer": attention.attn_init(gen, cfg)}
    if cfg.post_norm:
        p["norm1_post"] = norm_init(cfg.d_model, cfg.norm, dev)
    if spec.ffn == "dense":
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dev)
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_act)
        if cfg.post_norm:
            p["norm2_post"] = norm_init(cfg.d_model, cfg.norm, dev)
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device=None) -> ParamTree:
    """Fresh fp32 parameters drawn from ``generator`` (on its device),
    moved to ``device`` (default: the generator's), with the reference's
    scales and tree."""
    gen = generator
    params: dict = {"embed": embedding_init(gen, cfg.vocab_size, cfg.d_model)}
    if cfg.embedding_input:
        params["adapter"] = dense_init(gen, cfg.d_model, cfg.d_model)
    params["layers"] = tuple(
        _stack_trees([_layer_init(gen, cfg, spec)
                      for _ in range(cfg.n_periods)])
        for spec in cfg.period)
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size)
    if device is not None:
        params = map_tree(lambda t: t.to(device), params)
    return ParamTree(params)


def param_count(params) -> int:
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    leaves = []
    map_tree(leaves.append, params)
    return sum(t.numel() for t in leaves)


# ------------------------------------------------------------------ blocks

def _apply_layer(p, x, cfg, spec):
    h = apply_norm(p["norm1"], x, cfg.norm)
    y = attention.attn_forward(p["mixer"], h, cfg,
                               local=spec.mixer == "attn_local")
    if cfg.post_norm:
        y = apply_norm(p["norm1_post"], y, cfg.norm)
    x = x + y
    if spec.ffn == "dense":
        h = apply_norm(p["norm2"], x, cfg.norm)
        y = ffn(p["ffn"], h, cfg.ffn_act)
        if cfg.post_norm:
            y = apply_norm(p["norm2_post"], y, cfg.norm)
        x = x + y
    return x


def _stack(layers, x, cfg: ModelConfig):
    """The period body over ``n_periods``: each stacked leaf unbound once."""
    for spec in cfg.period:
        if spec.mixer not in _MIXERS:
            raise _a16(f"the {spec.mixer!r} mixer")
        if spec.ffn not in _FFNS:
            raise _a16(f"the {spec.ffn!r} FFN")
    per_period = [_unstack(lp, cfg.n_periods) for lp in layers]
    for i in range(cfg.n_periods):
        x = constrain_hidden(x)
        for pi, spec in enumerate(cfg.period):
            x = _apply_layer(per_period[pi][i], x, cfg, spec)
    return x


# ------------------------------------------------------------------ heads

def _lm_logits(params, x, cfg):
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T.to(x.dtype)
    else:
        logits = dense(params["lm_head"], x)
    return softcap(logits.to(torch.float32), cfg.logit_softcap)


def _embed_input(params, batch, cfg):
    dtype = model_dtype(cfg.dtype)
    if cfg.embedding_input and "embeds" in batch:
        return dense(params["adapter"], batch["embeds"].to(dtype))
    x = embed(params["embed"], batch["tokens"], dtype=dtype)
    if cfg.norm == "rmsnorm" and cfg.post_norm:  # gemma-style embed scaling
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


# ------------------------------------------------------------------ API

def forward_hidden(params: Union[ParamTree, dict], batch,
                   cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Backbone only: final normed hidden states (B, S, d) and the
    auxiliary loss (zero: no MoE).  The training loss projects to the
    vocabulary chunk by chunk instead of forming (B, S, V) logits."""
    params = as_tree(params)
    x = constrain_hidden(_embed_input(params, batch, cfg))
    x = _stack(params["layers"], x, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_head_weight(params: Union[ParamTree, dict], cfg: ModelConfig) -> Tensor:
    """(d, V) projection — the embedding transpose when tied."""
    params = as_tree(params)
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def forward_train(params: Union[ParamTree, dict], batch,
                  cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """``(logits (B, S, V) float32, aux)``."""
    x, aux = forward_hidden(params, batch, cfg)
    return _lm_logits(as_tree(params), x, cfg), aux


def forward_prefill(params, batch, cfg: ModelConfig):
    raise _a16("prefill")


def forward_decode(params, tokens, cfg: ModelConfig, caches, pos):
    raise _a16("decode")
