"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Counterpart of the reference's ``repro.models.xlstm``, with its cell
equations and stabilized exponential gating (the m-state trick):

  * mLSTM: up-projection (factor 2), causal conv + SiLU feeding q/k (v
    from the unconv'd branch), block-diagonal per-head q/k/v, matrix
    memory C_t = f C_{t-1} + i k v^T, head-wise norm, output gated by
    SiLU(z), down-projection.
  * sLSTM: scalar memory with recurrent (h_{t-1}) gate contributions,
    block-diagonal recurrent matrices per head, then a gated FFN
    (factor 4/3).

Both recurrences run as a sequential loop over the tokens, in the
reference's chunks (``min(cfg.seq_chunk, S)``, halved until it divides
S; :func:`repro_torch.models.layers.scan_chunks`): when autograd records,
each chunk is recomputed in the backward pass, as the reference's
``jax.checkpoint`` chunks are, so training keeps one chunk's per-token
states (two (B, H, dh, dh) fp32 memories a token for the mLSTM) and a
state a chunk, not every token's.  Prefill and decode run the same loop
without it.  The stabilizer ``m`` starts at -1e30 and stays fp32.

The sLSTM gate layout is the reference's, kept on purpose
(``_slstm_step``): the (B, H, 4 dh) recurrent product is reshaped to
(B, 4 H dh) and split into four equal chunks, so each gate's recurrent
input for every unit comes from a quarter of the heads, not from the
unit's own head (ROADMAP C, "Recorded").

Decode steps take and return explicit state; they do not write the
state they are given.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (apply_norm, dense, dense_init, ffn,
                                       ffn_init, scan_chunks, silu)
from repro_torch.models.ssm import causal_conv

Tensor = torch.Tensor

__all__ = [
    "mlstm_init", "mlstm_forward", "mlstm_decode", "mlstm_init_state",
    "slstm_init", "slstm_forward", "slstm_decode", "slstm_init_state",
]

_M0 = -1e30


# --------------------------------------------------------------------- mLSTM

def _mlstm_dims(cfg) -> Tuple[int, int, int]:
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    h = cfg.n_heads
    return di, h, di // h


def mlstm_init(gen: torch.Generator, cfg) -> dict:
    di, h, dh = _mlstm_dims(cfg)
    dev = gen.device

    def blk():
        return torch.randn((h, dh, dh), generator=gen,
                           device=dev) / math.sqrt(dh)

    up = dense_init(gen, cfg.d_model, 2 * di)
    conv_w = torch.randn((cfg.conv_kernel, di), generator=gen,
                         device=dev) / math.sqrt(cfg.conv_kernel)
    wq, wk, wv = blk(), blk(), blk()
    return {
        "up": up,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), device=dev),
        "wq": wq,
        "wk": wk,
        "wv": wv,
        "w_if": dense_init(gen, di, 2 * h),
        "if_bias": torch.cat([torch.zeros((h,), device=dev),
                              torch.full((h,), 3.0, device=dev)]),
        "head_norm": {"g": torch.zeros((di,), device=dev)},
        "down": dense_init(gen, di, cfg.d_model),
    }


def _heads(x, w):
    """Block-diagonal per-head product: (..., H, dh) x (H, dh, e)."""
    return torch.einsum("...hd,hde->...he", x, w)


def _mlstm_qkvif(p, x_m, cfg):
    """q, k, v (B, S, H, dh) and i, f (B, S, H) from the up-projection's
    first half x_m (B, S, di)."""
    di, h, dh = _mlstm_dims(cfg)
    xc = silu(causal_conv(x_m, p["conv_w"], p["conv_b"]))
    xch = xc.reshape(*xc.shape[:-1], h, dh).to(torch.float32)
    xmh = x_m.reshape(*x_m.shape[:-1], h, dh).to(torch.float32)
    q, k, v = _heads(xch, p["wq"]), _heads(xch, p["wk"]), _heads(xmh, p["wv"])
    gates = xc.to(torch.float32) @ p["w_if"]["w"] + p["if_bias"]
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)
    return q, k / math.sqrt(dh), v, i_pre, f_pre


def _mlstm_step(state, q, k, v, i_pre, f_pre):
    """One recurrence step.  state: (C, n, m); q, k, v (B, H, dh);
    i, f (B, H)."""
    c, n, m = state
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    # f C + i (k v^T), the outer product scaled through k
    c = torch.addcmul(f_g[..., None, None] * c,
                      (i_g[..., None] * k)[..., :, None], v[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    h_num = torch.einsum("bhd,bhde->bhe", q, c)
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                          torch.exp(-m_new))
    return (c, n, m_new), h_num / denom[..., None]


def _mlstm_chunk(state, q, k, v, i_pre, f_pre):
    """The steps of one chunk: ``(state, h (B, chunk, H, dh))``."""
    hs = []
    for t in range(q.shape[1]):
        state, ht = _mlstm_step(state, q[:, t], k[:, t], v[:, t],
                                i_pre[:, t], f_pre[:, t])
        hs.append(ht)
    return state, torch.stack(hs, dim=1)


def mlstm_init_state(cfg, batch: int, device=None) -> dict:
    di, h, dh = _mlstm_dims(cfg)
    return {
        "c": torch.zeros((batch, h, dh, dh), device=device),
        "n": torch.zeros((batch, h, dh), device=device),
        "m": torch.full((batch, h), _M0, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, di), device=device),
    }


def _mlstm_out(p, hflat, z, x):
    """Head norm, SiLU(z) gate and down-projection of the cell outputs
    (B, S, di)."""
    hflat = apply_norm(p["head_norm"], hflat.to(x.dtype), "rmsnorm")
    out = hflat.to(torch.float32) * silu(z.to(torch.float32))
    return dense(p["down"], out.to(x.dtype))


def mlstm_forward(p: dict, x: Tensor, cfg, *, return_state: bool = False):
    b, s, _ = x.shape
    di, h, dh = _mlstm_dims(cfg)
    x_m, z = torch.chunk(dense(p["up"], x), 2, dim=-1)         # (B,S,di)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(p, x_m, cfg)
    dev = x.device
    state = (torch.zeros((b, h, dh, dh), device=dev),
             torch.zeros((b, h, dh), device=dev),
             torch.full((b, h), _M0, device=dev))
    state, hs = scan_chunks(_mlstm_chunk, state, (q, k, v, i_pre, f_pre),
                            cfg.seq_chunk)
    y = _mlstm_out(p, hs.reshape(b, s, di), z, x)
    if return_state:
        kk = cfg.conv_kernel
        return y, {"c": state[0], "n": state[1], "m": state[2],
                   "conv": x_m[:, -(kk - 1):].to(torch.float32)}
    return y


def mlstm_decode(p: dict, x: Tensor, cfg, state: dict) -> Tuple[Tensor, dict]:
    """One token.  x: (B, 1, d)."""
    di, h, dh = _mlstm_dims(cfg)
    x_m, z = torch.chunk(dense(p["up"], x), 2, dim=-1)          # (B,1,di)
    window = torch.cat([state["conv"], x_m[:, 0].to(torch.float32)[:, None]],
                       dim=1)
    xc = silu(torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"])
    xch = xc.reshape(-1, h, dh)
    xmh = x_m[:, 0].reshape(-1, h, dh).to(torch.float32)
    q = _heads(xch, p["wq"])
    k = _heads(xch, p["wk"]) / math.sqrt(dh)
    v = _heads(xmh, p["wv"])
    gates = xc @ p["w_if"]["w"] + p["if_bias"]
    i_pre, f_pre = torch.chunk(gates, 2, dim=-1)
    (c, n, m), hvec = _mlstm_step((state["c"], state["n"], state["m"]),
                                  q, k, v, i_pre, f_pre)
    y = _mlstm_out(p, hvec.reshape(-1, 1, di), z, x)
    return y, {"c": c, "n": n, "m": m, "conv": window[:, 1:]}


# --------------------------------------------------------------------- sLSTM

def _slstm_dims(cfg) -> Tuple[int, int]:
    h = cfg.n_heads
    return h, cfg.d_model // h


def slstm_init(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    h, dh = _slstm_dims(cfg)
    dev = gen.device
    ffn_dim = int(round(cfg.slstm_ffn_factor * d / 64) * 64)
    conv_w = torch.randn((cfg.conv_kernel, d), generator=gen,
                         device=dev) / math.sqrt(cfg.conv_kernel)
    w_if = dense_init(gen, d, 2 * d)     # i, f from the conv'd input
    w_zo = dense_init(gen, d, 2 * d)     # z, o from the raw input
    r = torch.randn((h, dh, 4 * dh), generator=gen,
                    device=dev) / math.sqrt(dh)
    return {
        "conv_w": conv_w,
        "conv_b": torch.zeros((d,), device=dev),
        "w_if": w_if,
        "w_zo": w_zo,
        "r": r,
        "gate_bias": torch.cat([torch.zeros((d,), device=dev),
                                torch.full((d,), 3.0, device=dev),
                                torch.zeros((2 * d,), device=dev)]),
        "group_norm": {"g": torch.zeros((d,), device=dev)},
        "out": dense_init(gen, d, d),
        "ffn": ffn_init(gen, d, ffn_dim, "geglu"),
    }


def _slstm_step(state, wx_if, wx_zo, r, h_heads: int, dh: int):
    """One step.  state: (c, n, m, h), each (B, d); wx_if, wx_zo (B, 2d).
    The recurrent product's gate split is the reference's: (B, H, 4 dh)
    flattened to (B, 4 d), then four equal chunks."""
    c, n, m, h_prev = state
    rh = torch.einsum("bhd,hde->bhe", h_prev.reshape(-1, h_heads, dh), r)
    rh = rh.reshape(h_prev.shape[0], 4 * h_heads * dh)        # (B, 4d)
    r_i, r_f, r_z, r_o = torch.chunk(rh, 4, dim=-1)
    d = wx_if.shape[1] // 2
    i_pre = wx_if[:, :d] + r_i
    f_pre = wx_if[:, d:] + r_f
    z_pre = wx_zo[:, :d] + r_z
    o_pre = wx_zo[:, d:] + r_o
    m_new = torch.maximum(f_pre + m, i_pre)                   # exp f gating
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_pre + m - m_new)
    c = f_g * c + i_g * torch.tanh(z_pre)
    n = f_g * n + i_g
    h = torch.sigmoid(o_pre) * (c / torch.clamp(n, min=1e-6))
    return (c, n, m_new, h), h


def _slstm_chunk(r, h_heads: int, dh: int):
    """The steps of one chunk as a :func:`scan_chunks` body."""
    def body(state, wx_if, wx_zo):
        hs = []
        for t in range(wx_if.shape[1]):
            state, ht = _slstm_step(state, wx_if[:, t], wx_zo[:, t], r,
                                    h_heads, dh)
            hs.append(ht)
        return state, torch.stack(hs, dim=1)
    return body


def slstm_init_state(cfg, batch: int, device=None) -> dict:
    d = cfg.d_model
    return {
        "c": torch.zeros((batch, d), device=device),
        "n": torch.zeros((batch, d), device=device),
        "m": torch.full((batch, d), _M0, device=device),
        "h": torch.zeros((batch, d), device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, d), device=device),
    }


def _slstm_out(p, hseq, x):
    hseq = apply_norm(p["group_norm"], hseq.to(x.dtype), "rmsnorm")
    y = dense(p["out"], hseq)
    return y + ffn(p["ffn"], y, "geglu")


def slstm_forward(p: dict, x: Tensor, cfg, *, return_state: bool = False):
    b, s, d = x.shape
    h_heads, dh = _slstm_dims(cfg)
    xc = silu(causal_conv(x, p["conv_w"], p["conv_b"]))
    bias_if, bias_zo = torch.chunk(p["gate_bias"], 2)
    wx_if = xc.to(torch.float32) @ p["w_if"]["w"] + bias_if
    wx_zo = x.to(torch.float32) @ p["w_zo"]["w"] + bias_zo
    dev = x.device
    state = (torch.zeros((b, d), device=dev), torch.zeros((b, d), device=dev),
             torch.full((b, d), _M0, device=dev),
             torch.zeros((b, d), device=dev))
    state, hs = scan_chunks(_slstm_chunk(p["r"], h_heads, dh), state,
                            (wx_if, wx_zo), cfg.seq_chunk)
    y = _slstm_out(p, hs, x)
    if return_state:
        kk = cfg.conv_kernel
        return y, {"c": state[0], "n": state[1], "m": state[2],
                   "h": state[3], "conv": x[:, -(kk - 1):].to(torch.float32)}
    return y


def slstm_decode(p: dict, x: Tensor, cfg, state: dict) -> Tuple[Tensor, dict]:
    h_heads, dh = _slstm_dims(cfg)
    window = torch.cat([state["conv"], x[:, 0].to(torch.float32)[:, None]],
                       dim=1)
    xc = silu(torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"])
    bias_if, bias_zo = torch.chunk(p["gate_bias"], 2)
    wx_if = xc @ p["w_if"]["w"] + bias_if
    wx_zo = x[:, 0].to(torch.float32) @ p["w_zo"]["w"] + bias_zo
    (c, n, m, h), hvec = _slstm_step(
        (state["c"], state["n"], state["m"], state["h"]), wx_if, wx_zo,
        p["r"], h_heads, dh)
    y = _slstm_out(p, hvec[:, None], x)
    return y, {"c": c, "n": n, "m": m, "h": h, "conv": window[:, 1:]}
