"""Decoder stack of the port: any period pattern of {attn, attn_local,
mamba, mlstm, slstm} x {dense, moe, none} blocks.

Counterpart of the reference's ``repro.models.transformer``:
``init_params``, ``forward_hidden``, ``lm_head_weight``,
``forward_train``, ``forward_prefill``, ``forward_decode``,
``init_caches``, ``param_count`` and ``active_param_count``.  Parameters
keep the reference's tree — one leaf per period position, stacked over
``n_periods`` — inside a :class:`ParamTree` module, whose
``named_parameters()`` are the reference's paths (``embed.table``,
``layers.0.mixer.wq.w``, ...), so the optimizer routes the same names
and shapes.  The stack is a loop over periods; each stacked leaf is
unbound once a forward pass, so its gradient is stacked once.
``cfg.remat`` is not applied (ROADMAP C).  Hidden states pass
:func:`repro_torch.distributed.sharding.constrain_hidden` after the
embedding (training and prefill) and at each period, the reference's
sites.

Caches are the reference's tree: a tuple over period positions of dicts
stacked over ``n_periods`` — attention holds ``k`` / ``v``
(n_periods, B, S_max, n_kv, D), the recurrent mixers their state.
:func:`forward_decode` writes each step's K/V into the attention caches
it is given, in place, and returns them; every recurrent state it
returns is a new tensor.  The caller owns the caches.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed.sharding import constrain_hidden
from repro_torch.models import attention, moe as moe_mod, ssm, xlstm
from repro_torch.models.layers import (
    apply_norm, dense, dense_init, embed, embedding_init, ffn, ffn_init,
    model_dtype, norm_init, softcap,
)

Tensor = torch.Tensor

__all__ = ["ParamTree", "init_params", "forward_hidden", "lm_head_weight",
           "forward_train", "forward_prefill", "forward_decode",
           "init_caches", "param_count", "active_param_count", "as_tree",
           "named_leaves"]

_MIXER_INIT = {"attn": attention.attn_init, "attn_local": attention.attn_init,
               "mamba": ssm.mamba_init, "mlstm": xlstm.mlstm_init,
               "slstm": xlstm.slstm_init}
# The recurrent mixers' (forward, decode, initial state).
_RECURRENT = {
    "mamba": (ssm.mamba_forward, ssm.mamba_decode, ssm.mamba_init_state),
    "mlstm": (xlstm.mlstm_forward, xlstm.mlstm_decode, xlstm.mlstm_init_state),
    "slstm": (xlstm.slstm_forward, xlstm.slstm_decode, xlstm.slstm_init_state),
}


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
    if spec.mixer not in _MIXER_INIT:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.ffn not in ("dense", "moe", "none"):
        raise ValueError(f"unknown ffn {spec.ffn!r}")
    p: dict = {"norm1": norm_init(cfg.d_model, cfg.norm, dev),
               "mixer": _MIXER_INIT[spec.mixer](gen, cfg)}
    if cfg.post_norm:
        p["norm1_post"] = norm_init(cfg.d_model, cfg.norm, dev)
    if spec.ffn != "none":
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dev)
        if spec.ffn == "dense":
            p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_act)
        else:
            p["moe"] = moe_mod.moe_init(gen, cfg)
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


def named_leaves(params):
    """``(dotted name, tensor)`` of every leaf."""
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    out = []

    def walk(tree, prefix):
        items = (enumerate(tree) if isinstance(tree, (tuple, list))
                 else tree.items() if isinstance(tree, dict) else None)
        if items is None:
            out.append((prefix, tree))
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(params, "")
    return out


def param_count(params) -> int:
    return sum(t.numel() for _, t in named_leaves(params))


def active_param_count(params, cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE counts top_k of the routed
    experts; shared experts count whole)."""
    total = 0
    for name, leaf in named_leaves(params):
        if cfg.moe is not None and any(
                k in ("gate_w", "up_w", "down_w") for k in name.split(".")):
            total += leaf.numel() * cfg.moe.top_k // cfg.moe.num_experts
        else:
            total += leaf.numel()
    return total


# ------------------------------------------------------------------ blocks

def _apply_mixer(p, x, cfg, spec, *, mode, cache, pos):
    """Returns (y, new_cache); new_cache is None in training."""
    mixer = p["mixer"]
    if spec.mixer in ("attn", "attn_local"):
        local = spec.mixer == "attn_local"
        if mode == "decode":
            y, (ck, cv) = attention.attn_decode(
                mixer, x, cfg, local=local, cache_k=cache["k"],
                cache_v=cache["v"], cur_len=pos)
            return y, {"k": ck, "v": cv}
        if mode == "prefill":
            y, (k, v) = attention.attn_forward(mixer, x, cfg, local=local,
                                               return_kv=True)
            return y, {"k": k, "v": v}
        return attention.attn_forward(mixer, x, cfg, local=local), None
    forward, decode, _ = _RECURRENT[spec.mixer]
    if mode == "decode":
        return decode(mixer, x, cfg, cache)
    if mode == "prefill":
        return forward(mixer, x, cfg, return_state=True)
    return forward(mixer, x, cfg), None


def _apply_layer(p, x, cfg, spec, *, mode="train", cache=None, pos=None):
    """Returns (x, new_cache, aux)."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    y, new_cache = _apply_mixer(p, h, cfg, spec, mode=mode, cache=cache,
                                pos=pos)
    if cfg.post_norm:
        y = apply_norm(p["norm1_post"], y, cfg.norm)
    x = x + y
    aux = None
    if spec.ffn != "none":
        h = apply_norm(p["norm2"], x, cfg.norm)
        if spec.ffn == "dense":
            y = ffn(p["ffn"], h, cfg.ffn_act)
        else:
            y, aux = moe_mod.moe_forward(p["moe"], h, cfg)
        if cfg.post_norm:
            y = apply_norm(p["norm2_post"], y, cfg.norm)
        x = x + y
    return x, new_cache, aux


def _stack(layers, x, cfg: ModelConfig, *, mode="train", caches=None,
           pos=None):
    """The period body over ``n_periods``: each stacked leaf unbound
    once.  Returns (x, caches stacked over periods or None, aux)."""
    n = cfg.n_periods
    per_period = [_unstack(lp, n) for lp in layers]
    per_cache = (None if caches is None
                 else [_unstack(c, n) for c in caches])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new = [[] for _ in cfg.period]
    for i in range(n):
        x = constrain_hidden(x)
        for pi, spec in enumerate(cfg.period):
            cache = None if per_cache is None else per_cache[pi][i]
            x, nc, a = _apply_layer(per_period[pi][i], x, cfg, spec,
                                    mode=mode, cache=cache, pos=pos)
            if a is not None:
                aux = aux + a
            new[pi].append(nc)
    if mode == "train":
        return x, None, aux
    if mode == "decode":
        # attention K/V were written in place: keep the caller's stacks
        stacked = tuple(
            caches[pi] if spec.mixer in ("attn", "attn_local")
            else _stack_trees(new[pi]) for pi, spec in enumerate(cfg.period))
    else:
        stacked = tuple(_stack_trees(c) for c in new)
    return x, stacked, aux


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
    """Backbone only: final normed hidden states (B, S, d) and the MoE
    auxiliary loss (zero without MoE).  The training loss projects to
    the vocabulary chunk by chunk instead of forming (B, S, V) logits."""
    params = as_tree(params)
    x = constrain_hidden(_embed_input(params, batch, cfg))
    x, _, aux = _stack(params["layers"], x, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, aux


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


def forward_prefill(params: Union[ParamTree, dict], batch, cfg: ModelConfig):
    """``(logits (B, 1, V) float32 of the LAST position, caches)``: the
    attention caches hold the prompt's K/V (B, S, n_kv, D) per layer,
    the recurrent mixers their state after the prompt."""
    params = as_tree(params)
    x = constrain_hidden(_embed_input(params, batch, cfg))
    x, caches, _ = _stack(params["layers"], x, cfg, mode="prefill")
    x = apply_norm(params["final_norm"], x[:, -1:], cfg.norm)
    return _lm_logits(params, x, cfg), caches


def forward_decode(params: Union[ParamTree, dict], tokens: Tensor,
                   cfg: ModelConfig, caches, pos):
    """One token a request.  tokens: (B, 1) ids; ``pos`` (an int): the
    current length, the new token's position.  Returns ``(logits (B, 1,
    V) float32, caches)``: the attention caches given, with this step's
    K/V written in at ``pos`` (in place), and new recurrent states."""
    params = as_tree(params)
    x = embed(params["embed"], tokens, dtype=model_dtype(cfg.dtype))
    if cfg.embedding_input:
        # early-fusion archs run the frontend adapter on token embeddings
        # too, so decode is consistent with embedding-fed prefill
        x = dense(params["adapter"], x)
    if cfg.norm == "rmsnorm" and cfg.post_norm:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    x, new_caches, _ = _stack(params["layers"], x, cfg, mode="decode",
                              caches=caches, pos=int(pos))
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _lm_logits(params, x, cfg), new_caches


# ------------------------------------------------------------------ caches

def init_caches(cfg: ModelConfig, batch: int, s_max: int,
                dtype=torch.bfloat16, device=None):
    """Decode caches, one entry per period position, stacked over
    periods: zero K/V of ``dtype`` and the recurrent mixers' initial
    states (fp32), on ``device`` ("cuda" unless the caller asks for the
    CPU)."""
    from repro_torch.core.plan import resolve_device

    dev = resolve_device(device)
    n = cfg.n_periods
    caches = []
    for spec in cfg.period:
        if spec.mixer in ("attn", "attn_local"):
            shape = (n, batch, s_max, cfg.n_kv_heads, cfg.d_head)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                           "v": torch.zeros(shape, dtype=dtype, device=dev)})
        elif spec.mixer in _RECURRENT:
            state = _RECURRENT[spec.mixer][2](cfg, batch, device=dev)
            caches.append({k: v.expand(n, *v.shape).clone()
                           for k, v in state.items()})
        else:
            raise ValueError(spec.mixer)
    return tuple(caches)
