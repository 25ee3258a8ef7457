"""Mamba (selective SSM) mixer — jamba's sequence backbone.

Counterpart of the reference's ``repro.models.ssm`` (``mamba_init``,
``mamba_forward``, ``mamba_init_state``, ``mamba_decode``).

Training / prefill run the selective scan chunk by chunk: a loop over
sequence chunks carries the (B, d_inner, d_state) state, and inside a
chunk the linear recurrence ``h_t = a_t h_{t-1} + b_t`` is an inclusive
scan of the ``(a, b)`` pairs.  The reference scans a chunk with
``lax.associative_scan``; the port runs a Hillis–Steele scan in plain
torch ops: log2(chunk) doubling steps, each a few elementwise ops over
the whole chunk, so a 256-token chunk takes 8 steps of full-width work
where a sequential loop would take 256 launch-bound ones.  The
(B, chunk, d_inner, d_state) discretisation is built per chunk, never
for the whole sequence.  The reference recomputes each chunk in the
backward pass (``jax.checkpoint``); the port keeps autograd's saved
tensors (ROADMAP C).

Decode is one state update a token.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import chunk_size, dense, dense_init, silu

Tensor = torch.Tensor

__all__ = ["mamba_init", "mamba_forward", "mamba_decode", "mamba_init_state",
           "causal_conv"]


def _d_inner(cfg) -> int:
    return cfg.d_inner if cfg.d_inner is not None else 2 * cfg.d_model


def _dt_rank(cfg) -> int:
    return cfg.dt_rank if cfg.dt_rank is not None else math.ceil(cfg.d_model / 16)


def mamba_init(gen: torch.Generator, cfg) -> dict:
    di, ds, dtr, k = _d_inner(cfg), cfg.d_state, _dt_rank(cfg), cfg.conv_kernel
    dev = gen.device
    in_proj = dense_init(gen, cfg.d_model, 2 * di)
    conv_w = torch.randn((k, di), generator=gen, device=dev) / math.sqrt(k)
    x_proj = dense_init(gen, di, dtr + 2 * ds)
    dt_proj = dense_init(gen, dtr, di)
    # dt bias: softplus(dt_bias) spans [1e-3, 1e-1] (mamba paper)
    u = torch.rand((di,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), device=dev),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt_bias,
        "a_log": torch.log(a).expand(di, ds).clone(),
        "d_skip": torch.ones((di,), device=dev),
        "out_proj": dense_init(gen, di, cfg.d_model),
    }


def causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv along S (the reference's
    ``conv_general_dilated`` cross-correlation with k - 1 zeros on the
    left), as k shifted products.  x: (B, S, C); w: (k, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x.to(torch.float32), (0, 0, k - 1, 0))
    w = w.to(torch.float32)
    out = xp[:, 0:s] * w[0]
    for j in range(1, k):
        out = out + xp[:, j:j + s] * w[j]
    return (out + b).to(x.dtype)


def _ssm_params(p, xc, cfg):
    """Input-dependent dt / B / C from the conv'd activations (B, S, di)."""
    ds, dtr = cfg.d_state, _dt_rank(cfg)
    xdb = dense(p["x_proj"], xc, dtype=torch.float32)
    dt_r, b_mat, c_mat = torch.split(xdb, [dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"]["w"] + p["dt_bias"])    # (B,S,di)
    a = -torch.exp(p["a_log"])                                  # (di,ds)
    return dt, a, b_mat, c_mat


def _scan_pairs(a: Tensor, b: Tensor) -> Tensor:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along axis 1
    (h_{-1} = 0): Hillis–Steele doubling over the pairs, combining
    ``(a_l, b_l), (a_r, b_r) -> (a_l a_r, a_r b_l + b_r)``."""
    n, d = a.shape[1], 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _scan_chunked(dt, a, xf, b_mat, c_mat, h0, chunk: int):
    """y_t = C_t . h_t with h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t.

    dt, xf: (B, S, di); a: (di, ds); b_mat, c_mat: (B, S, ds);
    h0: (B, di, ds).  Returns y (B, S, di) and the last state."""
    s = dt.shape[1]
    chunk = chunk_size(chunk, s)
    h, ys = h0, []
    for c0 in range(0, s, chunk):
        dt_i, xf_i = dt[:, c0:c0 + chunk], xf[:, c0:c0 + chunk]
        bm_i, cm_i = b_mat[:, c0:c0 + chunk], c_mat[:, c0:c0 + chunk]
        da_i = torch.exp(dt_i[..., None] * a)           # (B, chunk, di, ds)
        dbx_i = (dt_i * xf_i)[..., None] * bm_i[:, :, None, :]
        # fold the carry into the first element
        dbx_i = torch.cat([dbx_i[:, :1] + da_i[:, :1] * h[:, None],
                           dbx_i[:, 1:]], dim=1)
        h_all = _scan_pairs(da_i, dbx_i)
        ys.append(torch.einsum("bcds,bcs->bcd", h_all, cm_i))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_forward(p: dict, x: Tensor, cfg, *, return_state: bool = False):
    """x: (B, S, d_model) -> (B, S, d_model) [, final states for
    prefill]."""
    b, s, _ = x.shape
    di = _d_inner(cfg)
    xz = dense(p["in_proj"], x)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    xc = silu(causal_conv(x_in, p["conv_w"], p["conv_b"]))

    dt, a, b_mat, c_mat = _ssm_params(p, xc, cfg)
    xf = xc.to(torch.float32)
    h0 = torch.zeros((b, di, cfg.d_state), dtype=torch.float32,
                     device=x.device)
    y, h_last = _scan_chunked(dt, a, xf, b_mat, c_mat, h0, cfg.seq_chunk)
    y = y + p["d_skip"] * xf
    y = (y * silu(z.to(torch.float32))).to(x.dtype)
    out = dense(p["out_proj"], y)
    if return_state:
        k = cfg.conv_kernel
        conv_state = (x_in[:, -(k - 1):].to(torch.float32) if k > 1 else
                      torch.zeros((b, 0, di), device=x.device))
        return out, {"ssm": h_last, "conv": conv_state}
    return out


def mamba_init_state(cfg, batch: int, device=None) -> dict:
    di, k = _d_inner(cfg), cfg.conv_kernel
    return {
        "ssm": torch.zeros((batch, di, cfg.d_state), device=device),
        "conv": torch.zeros((batch, k - 1, di), device=device),
    }


def mamba_decode(p: dict, x: Tensor, cfg, state: dict) -> Tuple[Tensor, dict]:
    """One token.  x: (B, 1, d_model); state: {"ssm", "conv"}.  Returns
    the output and new state tensors (``state`` is not written)."""
    k = cfg.conv_kernel
    xz = dense(p["in_proj"], x)
    x_in, z = torch.chunk(xz, 2, dim=-1)          # (B, 1, di)
    x_f = x_in[:, 0].to(torch.float32)

    conv_state = state["conv"]                    # (B, k-1, di)
    window = torch.cat([conv_state, x_f[:, None]], dim=1)   # (B, k, di)
    xc = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = silu(xc)[:, None]                        # (B, 1, di)

    dt, a, b_mat, c_mat = _ssm_params(p, xc.to(x.dtype), cfg)
    dt, b_mat, c_mat = dt[:, 0], b_mat[:, 0], c_mat[:, 0]
    xc0 = xc[:, 0].to(torch.float32)
    da = torch.exp(dt[..., None] * a)             # (B, di, ds)
    dbx = (dt * xc0)[..., None] * b_mat[:, None, :]
    h = da * state["ssm"] + dbx
    y = torch.einsum("bds,bs->bd", h, c_mat) + p["d_skip"] * xc0
    y = y * silu(z[:, 0].to(torch.float32))
    out = dense(p["out_proj"], y[:, None].to(x.dtype))
    new_state = {"ssm": h, "conv": window[:, 1:] if k > 1 else conv_state}
    return out, new_state
