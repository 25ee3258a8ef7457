"""AdamW — baseline optimizer and the fallback for non-matrix params.

Counterpart of the reference's ``repro.optim.adamw``, on name -> tensor
dicts: ``adamw_init(params) -> state``, ``adamw_update(grads, state,
params, lr=...) -> (new_params, new_state)``.  State is fp32, shaped like
the params and on their device (DTensors of the params' placements on a
mesh: every update is elementwise, so it runs on the local shards).
Pure: no tensor passed in is written.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.distributed.sharding import map_local

__all__ = ["AdamWState", "adamw_init", "adamw_update"]

Params = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: int
    m: Params
    v: Params


def adamw_init(params: Params) -> AdamWState:
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    return AdamWState(step=0, m=zeros,
                      v={k: torch.zeros_like(z) for k, z in zeros.items()})


def bias_corrections(step: int, b1: float, b2: float):
    """``1 - b**t`` for both moments, in float32 as the reference's."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return (1.0 - torch.tensor(b1, dtype=torch.float32) ** t,
            1.0 - torch.tensor(b2, dtype=torch.float32) ** t)


def adam_leaf(p, g, m, v, *, lr, b1, b2, eps, weight_decay, bc1, bc2):
    """One AdamW leaf update: ``(new_p, m, v)``.  DTensor leaves (one
    placement for all four) update shard by shard."""

    def leaf(p, g, m, v):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * (g * g)
        mh = m / bc1.to(m.device)
        vh = v / bc2.to(v.device)
        new_p = p - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p)
        return new_p.to(p.dtype), m, v

    return map_local(leaf, p, g, m, v)


def adamw_update(grads: Params, state: AdamWState, params: Params, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    step = state.step + 1
    bc1, bc2 = bias_corrections(step, b1, b2)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        new_p[k], new_m[k], new_v[k] = adam_leaf(
            p, grads[k], state.m[k], state.v[k], lr=lr, b1=b1, b2=b2,
            eps=eps, weight_decay=weight_decay, bc1=bc1, bc2=bc2)
    return new_p, AdamWState(step=step, m=new_m, v=new_v)
