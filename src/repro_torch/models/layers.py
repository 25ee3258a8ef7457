"""Shared layer primitives: norms, FFNs, embeddings, RoPE, soft-capping.

Counterpart of the reference's ``repro.models.layers``.  Each layer is a
pair of functions: ``*_init(gen, ...) -> dict`` of fp32 tensors, drawn
from a ``torch.Generator`` on its device, and an apply function taking
``(params, x)``.  Compute runs in the model dtype (bf16); params stay
fp32 and are cast at use (mixed precision, fp32 master).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.observability import trace as _trace

Tensor = torch.Tensor

__all__ = [
    "dense_init", "dense", "norm_init", "apply_norm", "ffn_init", "ffn",
    "embedding_init", "embed", "rope", "softcap", "model_dtype", "silu",
    "gelu_tanh", "chunk_size", "scan_chunks",
]


def model_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    return getattr(torch, name)


def _normal(gen: torch.Generator, shape, scale: float) -> Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def chunk_size(size: int, total: int) -> int:
    """The reference's sequence chunk: ``min(size, total)`` halved until
    it divides ``total``."""
    size = min(size, total)
    while total % size:
        size //= 2
    return size


def scan_chunks(body, carry, xs, chunk: int):
    """The reference's chunked scan (``lax.scan`` over ``jax.checkpoint``
    chunks): ``body(carry, *xs_chunk) -> (carry, y)`` over the chunks of
    ``xs`` along axis 1 (:func:`chunk_size`), the ``y``s concatenated
    along axis 1.  When autograd records, each chunk runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass, so
    the saved activations are one chunk deep plus a carry a chunk; the
    values are the same bits either way.  While tracing, each run of a
    chunk's body is a ``models.scan_chunk`` span, the backward's
    recompute too (on the autograd engine's thread)."""
    from torch.utils.checkpoint import checkpoint

    chunk = chunk_size(chunk, xs[0].shape[1])

    def run(carry, *part):
        with _trace.span("models.scan_chunk", chunk=chunk):
            return body(carry, *part)

    remat = torch.is_grad_enabled()
    ys = []
    for c0 in range(0, xs[0].shape[1], chunk):
        part = tuple(x[:, c0:c0 + chunk] for x in xs)
        if remat:
            carry, y = checkpoint(run, carry, *part, use_reentrant=False)
        else:
            carry, y = run(carry, *part)
        ys.append(y)
    return carry, torch.cat(ys, dim=1)


def silu(x: Tensor) -> Tensor:
    """``x * sigmoid(x)`` with the sigmoid spelled ``1 / (1 + exp(-x))``
    op by op in x's dtype, as the reference's ``jax.nn.silu`` lowers:
    in bf16 every op rounds (``F.silu`` rounds once).  ``-x`` is capped
    at 88 so that exp stays finite and the gradient has no inf * 0."""
    return x * (1.0 / (1.0 + torch.exp(torch.clamp(-x, max=88.0))))


def gelu_tanh(x: Tensor) -> Tensor:
    """The tanh approximation of GELU, op by op in x's dtype as the
    reference's ``jax.nn.gelu(approximate=True)`` lowers: its constants
    rounded to that dtype, every op rounding."""
    c0, c1 = (torch.tensor(c, dtype=x.dtype).item()
              for c in (0.044715, math.sqrt(2.0 / math.pi)))
    return x * (0.5 * (1.0 + torch.tanh(c1 * (x + c0 * (x * x * x)))))


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None) -> dict:
    scale = d_in ** -0.5 if scale is None else scale
    p = {"w": _normal(gen, (d_in, d_out), scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=gen.device)
    return p


def dense(p: dict, x: Tensor, *, dtype=None) -> Tensor:
    dtype = x.dtype if dtype is None else dtype
    y = x.to(dtype) @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def norm_init(d: int, kind: str, device=None) -> dict:
    if kind == "nonparam_ln":          # olmo: no gain/bias
        return {}
    if kind == "rmsnorm":
        return {"g": torch.zeros((d,), device=device)}   # (1+g) parametrization
    if kind == "layernorm":
        return {"g": torch.ones((d,), device=device),
                "b": torch.zeros((d,), device=device)}
    raise ValueError(f"unknown norm {kind!r}")


def apply_norm(p: dict, x: Tensor, kind: str, *, eps: float = 1e-6) -> Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        xf = xf * (1.0 + p["g"])
    else:  # layernorm / nonparam_ln
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            xf = xf * p["g"] + p["b"]
    return xf.to(x.dtype)


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, act: str) -> dict:
    p = {"down": dense_init(gen, d_ff, d_model)}
    if act in ("swiglu", "geglu"):
        p["gate"] = dense_init(gen, d_model, d_ff)
        p["up"] = dense_init(gen, d_model, d_ff)
    else:  # gelu
        p["up"] = dense_init(gen, d_model, d_ff)
    return p


def ffn(p: dict, x: Tensor, act: str, *, dtype=None) -> Tensor:
    dtype = x.dtype if dtype is None else dtype
    if act == "swiglu":
        h = silu(dense(p["gate"], x, dtype=dtype)) * dense(p["up"], x,
                                                           dtype=dtype)
    elif act == "geglu":
        h = gelu_tanh(dense(p["gate"], x, dtype=dtype)) * dense(
            p["up"], x, dtype=dtype)
    elif act == "gelu":
        h = gelu_tanh(dense(p["up"], x, dtype=dtype))
    else:
        raise ValueError(f"unknown ffn act {act!r}")
    return dense(p["down"], h, dtype=dtype)


def embedding_init(gen: torch.Generator, vocab: int, d: int) -> dict:
    return {"table": _normal(gen, (vocab, d), 1.0)}


def embed(p: dict, tokens: Tensor, *, dtype=torch.bfloat16) -> Tensor:
    return F.embedding(tokens.long(), p["table"]).to(dtype)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding; x is (..., S, H, D), positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: Tensor, cap: Optional[float]) -> Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    xf = x.to(torch.float32)
    return (cap * torch.tanh(xf / cap)).to(x.dtype)
