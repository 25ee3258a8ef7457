"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, shared
experts.

Counterpart of the reference's ``repro.models.moe``.  Dispatch is
scatter-based (GShard-style capacity buffers, no (T, E, C) one-hot): the
slot of a (token, choice) pair in its expert's (E, C, d) buffer is a
running count over the token-major flat (T k,) choices, with each
token's choices in descending gate order, so the port drops exactly the
reference's tokens at capacity.  Kept slots are unique and dropped
choices scatter zeros, so the accumulating scatter gives the same bits
in any order.  Expert compute runs over all E x C slots.

qwen2-moe extras: ``num_shared`` always-on experts fused into one dense
FFN of width num_shared * d_expert, sigmoid-gated.

Returns (y, aux_loss) with the switch-style load-balance loss.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (constrain_expert_stack,
                                              constrain_token_stack)
from repro_torch.models.layers import (dense, dense_init, ffn, ffn_init,
                                       gelu_tanh, silu)

Tensor = torch.Tensor

__all__ = ["moe_init", "moe_forward"]

_MOE_CHUNK_TOKENS = 131_072


def _expert_stack_init(gen: torch.Generator, e: int, d_in: int,
                       d_out: int) -> Tensor:
    return torch.randn((e, d_in, d_out), generator=gen,
                       device=gen.device) / math.sqrt(d_in)


def moe_init(gen: torch.Generator, cfg) -> dict:
    moe = cfg.moe
    p = {
        "router": dense_init(gen, cfg.d_model, moe.num_experts, scale=0.02),
        "gate_w": _expert_stack_init(gen, moe.num_experts, cfg.d_model,
                                     moe.d_expert),
        "up_w": _expert_stack_init(gen, moe.num_experts, cfg.d_model,
                                   moe.d_expert),
        "down_w": _expert_stack_init(gen, moe.num_experts, moe.d_expert,
                                     cfg.d_model),
    }
    if moe.num_shared > 0:
        p["shared"] = ffn_init(gen, cfg.d_model,
                               moe.num_shared * moe.d_expert, cfg.ffn_act)
        p["shared_gate"] = dense_init(gen, cfg.d_model, 1, scale=0.02)
    return p


def _capacity(tokens: int, moe) -> int:
    c = math.ceil(tokens * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(8, min(tokens, (c + 7) // 8 * 8))


def moe_forward(p: dict, x: Tensor, cfg) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (y, aux_loss).

    More than ``_MOE_CHUNK_TOKENS`` tokens, in a whole number of such
    chunks, dispatch chunk by chunk, each with its own capacity (the
    reference's ``lax.scan``); the aux loss is the mean over chunks."""
    bb, ss, dd = x.shape
    t_total = bb * ss
    chunk = _MOE_CHUNK_TOKENS
    if t_total > chunk and t_total % chunk == 0:
        n = t_total // chunk
        xc = x.reshape(n, chunk, dd)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ys = []
        for i in range(n):
            yi, a = _moe_tokens(p, xc[i][None], cfg)
            aux = aux + a / n
            ys.append(yi[0])
        return torch.stack(ys).reshape(bb, ss, dd), aux
    y, aux = _moe_tokens(p, x.reshape(1, t_total, dd), cfg)
    return y.reshape(bb, ss, dd), aux


def _moe_tokens(p: dict, x: Tensor, cfg) -> Tuple[Tensor, Tensor]:
    """Core capacity dispatch on a (1, T, d) token block."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.top_k
    cap = _capacity(t, moe)
    xt = x.reshape(t, d)

    logits = xt.to(torch.float32) @ p["router"]["w"]              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)          # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # slot of each (token, choice) in its expert's capacity buffer
    flat_idx = expert_idx.reshape(-1)                             # (T*k,)
    onehot = F.one_hot(flat_idx, e)                               # (T*k, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1  # (T*k,)
    keep = (pos >= 0) & (pos < cap)
    pos_c = torch.clamp(pos, 0, cap - 1)

    # dispatch: (E, C, d)
    x_rep = torch.repeat_interleave(xt, k, dim=0)                 # (T*k, d)
    x_rep = constrain_token_stack(torch.where(keep[:, None], x_rep, 0))
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put_((flat_idx, pos_c), x_rep, accumulate=True)
    buf = constrain_expert_stack(buf)

    # batched expert FFN over all E x C slots
    bw = x.dtype
    up = torch.bmm(buf, p["up_w"].to(bw))
    if cfg.ffn_act in ("swiglu", "geglu"):
        act = silu if cfg.ffn_act == "swiglu" else gelu_tanh
        h = act(torch.bmm(buf, p["gate_w"].to(bw))) * up
    else:
        h = gelu_tanh(up)
    h = constrain_expert_stack(h)
    out_buf = constrain_expert_stack(torch.bmm(h, p["down_w"].to(bw)))

    # combine
    gathered = constrain_token_stack(out_buf[flat_idx, pos_c])    # (T*k, d)
    w = (gate_vals.reshape(-1) * keep).to(gathered.dtype)
    y = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)

    if moe.num_shared > 0:
        sg = torch.sigmoid(dense(p["shared_gate"], x, dtype=torch.float32))
        y = y.reshape(b, s, d) + (sg * ffn(p["shared"], x, cfg.ffn_act
                                           ).to(torch.float32)).to(y.dtype)
        y = y.reshape(t, d)

    # switch-style load balance: E * sum_e f_e * P_e
    f_e = F.one_hot(expert_idx, e).to(torch.float32).mean(dim=(0, 1)) * k
    p_e = probs.mean(dim=0)
    aux = moe.router_aux_weight * e * torch.sum(f_e * p_e)

    return y.reshape(b, s, d).to(x.dtype), aux
