"""Plain reference of one training step's update: global-norm clipping,
QR-Muon on the matrix leaves and AdamW on the rest, with the program's
learning-rate schedule.

The orthogonal factor of each momentum matrix comes from an independent
float64 ``torch.linalg.qr`` with the sign convention diag(R) >= 0 (the
columns of Q turned so that the diagonal of QᵀA is non-negative), wide
matrices through their transpose.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

Tensor = torch.Tensor

_EXCLUDE = ("embed", "lm_head", "table", "router", "shared_gate")

# QR-Muon's and AdamW's settings in the program's trainer.
MOMENTUM, ADAM_LR_RATIO, B1, B2, EPS = 0.95, 0.3, 0.9, 0.95, 1e-8


def is_muon(name: str, shape) -> bool:
    """Matrix leaves outside the embedding, heads, router and gates; a
    leaf under ``layers`` is a stack whose first axis is not a matrix
    axis."""
    parts = name.split(".")
    if any(p in _EXCLUDE for p in parts):
        return False
    rank = len(shape) - (1 if parts[0] == "layers" else 0)
    return rank >= 2 and min(shape[-2], shape[-1]) >= 8


def lr_at(step: int, *, peak: float, warmup: int, total: int, final=0.1) -> float:
    """Linear warm-up then cosine decay, in float32 arithmetic."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = peak * torch.clamp(s / max(warmup, 1), max=1.0)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final + (1 - final) * 0.5 * (1 + torch.cos(math.pi * frac))
    return float(torch.where(s < warmup, warm, peak * cos))


def orthogonalize(m: Tensor, chunk: int = 8) -> Tensor:
    """Sign-fixed thin Q of every trailing matrix of ``m``, in float64,
    returned in m's dtype."""
    wide = m.shape[-2] < m.shape[-1]
    tall = m.mT if wide else m
    a = tall.reshape((-1,) + tall.shape[-2:])
    out = torch.empty_like(a)
    for c0 in range(0, a.shape[0], chunk):
        q, r = torch.linalg.qr(a[c0:c0 + chunk].double())
        sign = torch.where(torch.diagonal(r, dim1=-2, dim2=-1) >= 0, 1.0, -1.0)
        out[c0:c0 + chunk] = (q * sign[..., None, :]).to(m.dtype)
    out = out.reshape(tall.shape)
    return out.mT if wide else out


def clip(grads: Dict[str, Tensor], max_norm: float = 1.0) -> Dict[str, Tensor]:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def init_state(params: Dict[str, Tensor]) -> dict:
    return {"step": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()
                   if not is_muon(k, p.shape)}}


def update(params: Dict[str, Tensor], grads: Dict[str, Tensor], state: dict,
           lr: float, weight_decay: float = 0.0) -> None:
    """One step in place on ``params`` and ``state``; ``grads`` already
    clipped."""
    state["step"] += 1
    t = torch.tensor(float(state["step"]), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(B1, dtype=torch.float32) ** t)
    bc2 = float(1.0 - torch.tensor(B2, dtype=torch.float32) ** t)
    for k, p in params.items():
        g, mu = grads[k], state["mu"][k]
        if is_muon(k, p.shape):
            mu.mul_(MOMENTUM).add_(g)
            o = orthogonalize(g + MOMENTUM * mu)
            scale = math.sqrt(max(1.0, p.shape[-2] / p.shape[-1]))
            p.sub_(lr * (scale * o + weight_decay * p))
        else:
            nu = state["nu"][k]
            mu.mul_(B1).add_((1 - B1) * g)
            nu.mul_(B2).add_((1 - B2) * g * g)
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            p.sub_(lr * ADAM_LR_RATIO * (step + weight_decay * p))
