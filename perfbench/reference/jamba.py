"""Plain PyTorch reference of the Jamba block (AI21-Jamba2-Mini, HF
model_type ``jamba``): the parameter tree with its initial scales, and
the forward pass and logits.

Written from the published layer equations, independently of the
program: it imports nothing of the program and reads its sizes from the
benchmark's configuration file.  Everything runs in float32 (the caller
turns TF32 off); a matrix product's operands pass through ``rnd``, the
identity in the reference and a rounding to a lower precision in the
control.  Leaf names are the program's, so one seeded draw
(:func:`perfbench.reference.inputs.weights`) feeds both sides.

  * layer: ``x += mixer(RMSNorm(x))``, then ``x += ffn(RMSNorm(x))``; a
    final RMSNorm, then the untied head;
  * Mamba: ``[u, z] = x W_in``; ``u = SiLU(conv4(u) + b_conv)``, conv4
    depthwise and causal; ``[d, B, C] = u W_x``, each through its own
    RMSNorm; ``D = softplus(d W_dt + b_dt)``; ``h_t = exp(D_t A) h_{t-1} +
    (D_t u_t) B_t`` with ``A = -exp(A_log)``; ``y_t = h_t C_t + D_skip u_t``;
    ``out = (y * SiLU(z)) W_out``;
  * attention: causal GQA, no bias, no positional encoding;
  * MoE: ``p = softmax(x W_router)``, the top 2 of ``p`` weighted by
    their probabilities as they are (not renormalized), no token dropped.

Departures from the published model, none of which changes the
mathematics:
  * RMSNorm gains are ``1 + g`` with ``g`` starting at 0 (the published
    norm's weight starts at 1);
  * dt's projection bias is its own leaf, ``dt_bias``;
  * the weights are random draws from the seed, not the checkpoint:
    ``dt_bias`` is constant in four segments whose softplus is 1e-3 to
    1e-1, ``a_log`` is log(1..d_state) in every row (S4D-real), the conv
    bias starts at 0, ``d_skip`` at 1;
  * attention forms its scores a block of query rows at a time, each
    against the keys up to the block's end, so 8 rows of 5,120 positions
    fit; the Mamba recurrence runs one position at a time;
  * each expert is computed over the (token, choice) pairs routed to it.
The configuration's switches (``rope_theta``, ``mamba_inner_norm``,
``moe.normalize_topk``) are honoured, so the CPU tests can show that the
program with any one of them turned off fails the comparison.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .model import (Round, _attn, _const, _dense, _ffn, _moe, _norm, _normal,
                    causal_conv, dense, ffn, ident, make_config, map_tree, norm,
                    rope)

Tensor = torch.Tensor

__all__ = ["make_config", "param_spec", "hidden", "logits", "head_weight"]

# softplus(dt_bias) over four segments of d_inner, 1e-3 to 1e-1 (log-spaced)
_DT = tuple(10 ** (-3 + 2 * i / 3) for i in range(4))


def _inv_softplus(y: float) -> float:
    return math.log(math.expm1(y))


def _mamba(cfg):
    d, di, ds, dtr, k = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.conv_kernel
    seg = di // len(_DT)
    p = {"in_proj": _dense(d, 2 * di),
         "conv_w": _normal((k, di), k ** -0.5), "conv_b": _const((di,)),
         "x_proj": _dense(di, dtr + 2 * ds),
         "dt_proj": _dense(dtr, di),
         "dt_bias": _const((di,), *[(seg if i < len(_DT) - 1 else di - seg * i,
                                     _inv_softplus(v)) for i, v in enumerate(_DT)]),
         "a_log": _const((di, ds), *[(1, math.log(n)) for n in range(1, ds + 1)]),
         "d_skip": _const((di,), (di, 1.0)),
         "out_proj": _dense(di, d)}
    if cfg.mamba_inner_norm:
        p.update(dt_norm=_norm(dtr, "rmsnorm"), b_norm=_norm(ds, "rmsnorm"),
                 c_norm=_norm(ds, "rmsnorm"))
    return p


def _layer(cfg, mixer, kind):
    p = {"norm1": _norm(cfg.d_model, cfg.norm),
         "mixer": _attn(cfg) if mixer == "attn" else _mamba(cfg),
         "norm2": _norm(cfg.d_model, cfg.norm)}
    if kind == "moe":
        p["moe"] = _moe(cfg)
    else:
        p["ffn"] = _ffn(cfg.d_model, cfg.d_ff)
    return p


def param_spec(cfg):
    """The tree of ``Init`` leaves: the program's tree and order, each
    layer leaf stacked over ``n_periods``."""
    spec = {"embed": {"table": _normal((cfg.vocab_size, cfg.d_model), 1.0)}}
    spec["layers"] = tuple(
        map_tree(lambda leaf: leaf.stacked(cfg.n_periods), _layer(cfg, mixer, kind))
        for mixer, kind in cfg.period)
    spec["final_norm"] = _norm(cfg.d_model, cfg.norm)
    spec["lm_head"] = _dense(cfg.d_model, cfg.vocab_size)
    return spec


# ------------------------------------------------------------ layers

def attention(p, x, cfg, rnd: Round = ident, block: int = 128):
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = dense(p["wq"], x, rnd).reshape(b, s, h, dh)
    k = dense(p["wk"], x, rnd).reshape(b, s, kvh, dh)
    v = dense(p["wv"], x, rnd).reshape(b, s, kvh, dh)
    if cfg.rope_theta is not None:
        q, k = rope(q, cfg.rope_theta), rope(k, cfg.rope_theta)
    k = rnd(k.repeat_interleave(h // kvh, dim=2))
    v = rnd(v.repeat_interleave(h // kvh, dim=2))
    outs = []
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        sc = torch.einsum("bqhd,bkhd->bhqk", rnd(q[:, q0:q1]), k[:, :q1]) * dh ** -0.5
        pos = torch.arange(q1, device=x.device)
        w = torch.softmax(sc.masked_fill(pos[None, :] > pos[q0:q1, None], -torch.inf), -1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", rnd(w), v[:, :q1]))
    return dense(p["wo"], torch.cat(outs, 1).reshape(b, s, h * dh), rnd)


def mamba(p, x, cfg, rnd: Round = ident):
    b, s, _ = x.shape
    ds, dtr = cfg.d_state, cfg.dt_rank
    u, z = torch.chunk(dense(p["in_proj"], x, rnd), 2, -1)
    u = F.silu(causal_conv(u, p["conv_w"], p["conv_b"]))
    delta, bm, cm = torch.split(dense(p["x_proj"], u, rnd), [dtr, ds, ds], -1)
    if cfg.mamba_inner_norm:
        delta = norm(p["dt_norm"], delta, "rmsnorm")
        bm, cm = norm(p["b_norm"], bm, "rmsnorm"), norm(p["c_norm"], cm, "rmsnorm")
    dt = F.softplus(dense(p["dt_proj"], delta, rnd) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    h = x.new_zeros(b, cfg.d_inner, ds)
    ys = []
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * u[:, t])[..., None] * bm[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, cm[:, t]))
    y = torch.stack(ys, 1) + p["d_skip"] * u
    return dense(p["out_proj"], y * F.silu(z), rnd)


def moe(p, x, cfg, rnd: Round = ident):
    """Top-k of a softmax router; every (token, choice) pair computed by
    its expert, weighted by its probability (renormalized over the k only
    where ``normalize_topk`` says so)."""
    m = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs = torch.softmax(xt @ p["router"]["w"], -1)
    gates, idx = torch.topk(probs, m["top_k"], -1)
    if m.get("normalize_topk", True):
        gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(xt)
    for ex in range(m["num_experts"]):
        tok, choice = torch.nonzero(idx == ex, as_tuple=True)
        if tok.numel() == 0:
            continue
        xi = rnd(xt[tok])
        hi = F.silu(xi @ rnd(p["gate_w"][ex])) * (xi @ rnd(p["up_w"][ex]))
        y = y.index_add(0, tok, (rnd(hi) @ rnd(p["down_w"][ex])) * gates[tok, choice, None])
    return y.reshape(b, s, d)


_APPLY = {"attn": attention, "mamba": mamba}


def hidden(params, tokens, cfg, rnd: Round = ident, residual: Round = ident):
    """Final normed hidden states (B, S, d) of every position; the
    residual stream passes through ``residual`` after the embedding and
    each add (the identity but in a calibration witness)."""
    x = residual(params["embed"]["table"][tokens.long()])
    for i in range(cfg.n_periods):
        for (mixer, kind), lp in zip(cfg.period, params["layers"]):
            p = map_tree(lambda t: t[i], lp)
            x = residual(x + _APPLY[mixer](p["mixer"], norm(p["norm1"], x, cfg.norm), cfg, rnd))
            hn = norm(p["norm2"], x, cfg.norm)
            x = residual(x + (moe(p["moe"], hn, cfg, rnd) if kind == "moe"
                              else ffn(p["ffn"], hn, cfg.ffn_act, rnd)))
    return norm(params["final_norm"], x, cfg.norm)


def head_weight(params, cfg):
    return params["lm_head"]["w"]


def logits(params, tokens, cfg, rnd: Round = ident):
    """(B, S, V) float32 logits of every position."""
    return rnd(hidden(params, tokens, cfg, rnd)) @ rnd(head_weight(params, cfg))
