"""GQA attention: chunked online softmax for training and prefill, and
cached decode.

Counterpart of the reference's ``repro.models.attention`` (``attn_init``,
``attn_forward``, ``attn_decode``, ``chunked_attention``), in plain
torch ops that follow its chunked online softmax: a loop over query
chunks and, inside it, over key/value chunks carries the running max,
denominator and accumulator, so no (S x S) score matrix is formed.
Local (windowed) attention and gemma2 score soft-capping fold into the
same masks.  GQA is computed grouped: q heads reshape to (n_kv, group),
so k/v are never repeated in memory.  The reference recomputes each
query chunk in the backward pass (``jax.checkpoint``); the port keeps
autograd's saved tensors (ROADMAP C).

Decode attends one query against the whole (B, S_max, n_kv, D) cache
with a length mask.  It writes the new K/V into the cache **in place**
(the reference's ``lax.dynamic_update_slice`` returns a new array) and
raises on a ``cur_len`` outside the cache, where the reference's update
clamps the index and silently overwrites the last slot.

``cfg.rope_theta=None`` (Jamba) leaves q and k without positional
encoding, in training, prefill and decode alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import constrain_decode_scores
from repro_torch.models.layers import (apply_norm, chunk_size, dense,
                                       dense_init, rope)

Tensor = torch.Tensor

__all__ = ["attn_init", "attn_forward", "attn_decode", "chunked_attention"]

_NEG = -1e30


def attn_init(gen: torch.Generator, cfg) -> dict:
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.d_q, bias=cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.d_kv, bias=cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.d_kv, bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.d_q, cfg.d_model),
    }
    if cfg.qk_norm:
        p["qnorm"] = {"g": torch.zeros((cfg.d_head,), device=gen.device)}
        p["knorm"] = {"g": torch.zeros((cfg.d_head,), device=gen.device)}
    return p


def _project_qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    q = dense(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = apply_norm(p["qnorm"], q, "rmsnorm")
        k = apply_norm(p["knorm"], k, "rmsnorm")
    if cfg.rope_theta is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_scores(q, k, *, scale, softcap):
    """q (b, qc, kvh, g, d), k (b, kc, kvh, d) -> (b, kvh, g, qc, kc)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def chunked_attention(
    q: Tensor, k: Tensor, v: Tensor, *,
    q_pos: Tensor, k_pos0: int = 0,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_chunk: int = 512, kv_chunk: int = 1024,
    causal_skip: bool = False,
) -> Tensor:
    """Causal online-softmax attention.

    q: (B, Sq, H, D); k, v: (B, Sk, n_kv, D); q_pos: (Sq,) absolute
    positions of the queries (k positions are k_pos0 + arange(Sk)).
    ``causal_skip`` skips the key/value blocks a query chunk cannot see
    (above the causal diagonal, outside the window)."""
    b, sq, h, d = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    scale = d ** -0.5
    q_chunk, kv_chunk = chunk_size(q_chunk, sq), chunk_size(kv_chunk, sk)
    qg = q.reshape(b, sq, n_kv, g, d)
    k_pos = k_pos0 + torch.arange(sk, device=q.device)
    outs = []
    for q0 in range(0, sq, q_chunk):
        qi = qg[:, q0:q0 + q_chunk]
        qpos = q_pos[q0:q0 + q_chunk]
        m = torch.full((b, n_kv, g, q_chunk), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n_kv, g, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, sk, kv_chunk):
            kpos = k_pos[k0:k0 + kv_chunk]
            if causal_skip:
                needed = int(kpos[0]) <= int(qpos[-1])
                if window is not None:
                    needed &= int(kpos[-1]) > int(qpos[0]) - window
                if not needed:
                    continue
            s = _block_scores(qi, k[:, k0:k0 + kv_chunk], scale=scale,
                              softcap=softcap)
            mask = qpos[:, None] >= kpos[None, :]           # causal
            if window is not None:
                mask &= (qpos[:, None] - kpos[None, :]) < window
            s = s.masked_fill(~mask, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p,
                v[:, k0:k0 + kv_chunk].to(torch.float32))
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]    # (b,h',g,qc,d)
        outs.append(out.permute(0, 3, 1, 2, 4))              # (b,qc,n_kv,g,d)
    out = torch.cat(outs, dim=1).reshape(b, sq, h, d)
    return out.to(q.dtype)


def attn_forward(
    p: dict, x: Tensor, cfg, *, local: bool, pos0: int = 0,
    return_kv: bool = False,
):
    """Training / prefill attention over a full sequence; with
    ``return_kv`` also the (roped) K and V, (B, S, n_kv, D) each."""
    b, s, _ = x.shape
    positions = pos0 + torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    window = cfg.window if local else None
    out = chunked_attention(
        q, k, v, q_pos=positions, k_pos0=pos0, window=window,
        softcap=cfg.attn_softcap, q_chunk=cfg.seq_chunk,
        kv_chunk=max(cfg.seq_chunk, 1024 if s >= 1024 else s),
        causal_skip=getattr(cfg, "attn_causal_skip", False),
    )
    y = dense(p["wo"], out.reshape(b, s, cfg.d_q))
    if return_kv:
        return y, (k, v)
    return y


def attn_decode(p: dict, x: Tensor, cfg, *, local: bool, cache_k: Tensor,
                cache_v: Tensor, cur_len) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """One decode step.  x: (B, 1, d); caches (B, S_max, n_kv, D);
    ``cur_len`` (an int) is the number of valid cache entries, the new
    token's position.  The new K/V are written into ``cache_k`` /
    ``cache_v`` at ``cur_len``, which are returned."""
    b = x.shape[0]
    s_max = cache_k.shape[1]
    cur_len = int(cur_len)
    if not 0 <= cur_len < s_max:
        raise IndexError(f"decode position {cur_len} is outside the cache "
                         f"of {s_max} entries")
    positions = torch.full((1,), cur_len, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    cache_k[:, cur_len] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, cur_len] = v_new[:, 0].to(cache_v.dtype)

    n_kv, d = cfg.n_kv_heads, cfg.d_head
    g = cfg.n_heads // n_kv
    qg = q.reshape(b, 1, n_kv, g, d)
    s = _block_scores(qg, cache_k, scale=d ** -0.5, softcap=cfg.attn_softcap)
    s = constrain_decode_scores(s)
    kpos = torch.arange(s_max, device=x.device)
    mask = kpos <= cur_len
    if local and cfg.window is not None:
        mask &= (cur_len - kpos) < cfg.window
    s = s.masked_fill(~mask, _NEG)
    w = constrain_decode_scores(torch.softmax(s, dim=-1))
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, cache_v.to(torch.float32))
    out = out.reshape(b, 1, cfg.d_q).to(x.dtype)
    y = dense(p["wo"], out)
    return y, (cache_k, cache_v)
