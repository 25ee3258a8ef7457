"""Plain PyTorch reference of the benchmarked decoders: the parameter
tree with its initial scales, and the forward pass and training loss.

A frozen copy of the layer equations of the program's model code
(attention with RoPE and a causal softmax, top-k capacity-dispatch MoE
with fused shared experts, mLSTM and sLSTM with stabilized exponential
gating), written independently of it: it imports nothing of the program
and reads its sizes from the benchmark's configuration file.  Everything
runs in float32; a matrix product's operands pass through ``rnd``, the
identity in the reference and a rounding to a lower precision in the
control.

Departures from the program, none of which changes the mathematics:
attention forms the whole (S x S) score matrix instead of the online
softmax over chunks; the MoE computes each expert on the tokens it kept
instead of over padded capacity buffers; the recurrent scans recompute
each chunk in the backward pass as the program does, since a step's
per-token memories would not fit otherwise.
"""

from __future__ import annotations

import math
import types
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor
Round = Callable[[Tensor], Tensor]

_M0 = -1e30


def ident(x: Tensor) -> Tensor:
    return x


def make_config(model: dict) -> types.SimpleNamespace:
    """The configuration file's ``model`` object as attributes; ``period``
    as a tuple of (mixer, ffn) pairs."""
    cfg = types.SimpleNamespace(**model)
    cfg.period = tuple(tuple(p) for p in model["period"])
    cfg.n_periods = cfg.n_layers // len(cfg.period)
    return cfg


# ------------------------------------------------------------ the tree

class Init:
    """One leaf: its shape and how it starts (``normal`` times ``scale``,
    or ``const``: segments of (count, value) along the last axis)."""

    __slots__ = ("shape", "scale", "segments")

    def __init__(self, shape, scale=None, segments=None):
        self.shape = tuple(int(s) for s in shape)
        self.scale = scale
        self.segments = segments

    def stacked(self, n: int) -> "Init":
        return Init((n,) + self.shape, self.scale, self.segments)


def _normal(shape, scale):
    return Init(shape, scale=float(scale))


def _const(shape, *segments):
    return Init(shape, segments=segments or ((shape[-1], 0.0),))


def _dense(d_in, d_out, *, bias=False, scale=None):
    p = {"w": _normal((d_in, d_out), d_in ** -0.5 if scale is None else scale)}
    if bias:
        p["b"] = _const((d_out,))
    return p


def _norm(d, kind):
    if kind == "rmsnorm":
        return {"g": _const((d,))}
    return {"g": _const((d,), (d, 1.0)), "b": _const((d,))}


def _ffn(d, d_ff):
    return {"down": _dense(d_ff, d), "gate": _dense(d, d_ff),
            "up": _dense(d, d_ff)}


def _attn(cfg):
    d, dq, dkv = cfg.d_model, cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    b = cfg.qkv_bias
    return {"wq": _dense(d, dq, bias=b), "wk": _dense(d, dkv, bias=b),
            "wv": _dense(d, dkv, bias=b), "wo": _dense(dq, d)}


def _moe(cfg):
    m, d = cfg.moe, cfg.d_model
    e, de = m["num_experts"], m["d_expert"]
    p = {"router": _dense(d, e, scale=0.02),
         "gate_w": _normal((e, d, de), d ** -0.5),
         "up_w": _normal((e, d, de), d ** -0.5),
         "down_w": _normal((e, de, d), de ** -0.5)}
    if m["num_shared"] > 0:
        p["shared"] = _ffn(d, m["num_shared"] * de)
        p["shared_gate"] = _dense(d, 1, scale=0.02)
    return p


def mlstm_dims(cfg):
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    return di, cfg.n_heads, di // cfg.n_heads


def _mlstm(cfg):
    di, h, dh = mlstm_dims(cfg)
    k = cfg.conv_kernel
    return {"up": _dense(cfg.d_model, 2 * di),
            "conv_w": _normal((k, di), k ** -0.5), "conv_b": _const((di,)),
            "wq": _normal((h, dh, dh), dh ** -0.5),
            "wk": _normal((h, dh, dh), dh ** -0.5),
            "wv": _normal((h, dh, dh), dh ** -0.5),
            "w_if": _dense(di, 2 * h),
            "if_bias": _const((2 * h,), (h, 0.0), (h, 3.0)),
            "head_norm": {"g": _const((di,))},
            "down": _dense(di, cfg.d_model)}


def slstm_ffn_dim(cfg):
    return int(round(cfg.slstm_ffn_factor * cfg.d_model / 64) * 64)


def _slstm(cfg):
    d, h, k = cfg.d_model, cfg.n_heads, cfg.conv_kernel
    dh = d // h
    return {"conv_w": _normal((k, d), k ** -0.5), "conv_b": _const((d,)),
            "w_if": _dense(d, 2 * d), "w_zo": _dense(d, 2 * d),
            "r": _normal((h, dh, 4 * dh), dh ** -0.5),
            "gate_bias": _const((4 * d,), (d, 0.0), (d, 3.0), (2 * d, 0.0)),
            "group_norm": {"g": _const((d,))},
            "out": _dense(d, d),
            "ffn": _ffn(d, slstm_ffn_dim(cfg))}


_MIXERS = {"attn": _attn, "mlstm": _mlstm, "slstm": _slstm}


def _layer(cfg, mixer, ffn):
    p = {"norm1": _norm(cfg.d_model, cfg.norm), "mixer": _MIXERS[mixer](cfg)}
    if ffn != "none":
        p["norm2"] = _norm(cfg.d_model, cfg.norm)
        if ffn == "moe":
            p["moe"] = _moe(cfg)
        else:
            p["ffn"] = _ffn(cfg.d_model, cfg.d_ff)
    return p


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(map_tree(fn, v) for v in tree)
    return fn(tree)


def param_spec(cfg):
    """The tree of :class:`Init` leaves: the program's tree and order,
    each layer leaf stacked over ``n_periods``."""
    spec = {"embed": {"table": _normal((cfg.vocab_size, cfg.d_model), 1.0)}}
    spec["layers"] = tuple(
        map_tree(lambda leaf: leaf.stacked(cfg.n_periods),
                 _layer(cfg, mixer, ffn)) for mixer, ffn in cfg.period)
    spec["final_norm"] = _norm(cfg.d_model, cfg.norm)
    if not cfg.tie_embeddings:
        spec["lm_head"] = _dense(cfg.d_model, cfg.vocab_size)
    return spec


def leaves(tree, prefix=""):
    """``(dotted name, leaf)`` in tree order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaves(v, f"{prefix}.{k}" if prefix else str(k))
    return out


# ------------------------------------------------------------ layers

def dense(p, x, rnd: Round = ident):
    y = rnd(x) @ rnd(p["w"])
    return y + p["b"] if "b" in p else y


def norm(p, x, kind, eps=1e-6):
    if kind == "rmsnorm":
        return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * (1.0 + p["g"])
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean((x - mu) ** 2, -1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def ffn(p, x, act, rnd: Round = ident):
    a = F.silu if act == "swiglu" else gelu_tanh
    return dense(p["down"], a(dense(p["gate"], x, rnd)) * dense(p["up"], x, rnd), rnd)


def rope(x, theta):
    """x: (B, S, H, D), positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(p, x, cfg, rnd: Round = ident):
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = rope(dense(p["wq"], x, rnd).reshape(b, s, h, dh), cfg.rope_theta)
    k = rope(dense(p["wk"], x, rnd).reshape(b, s, kvh, dh), cfg.rope_theta)
    v = dense(p["wv"], x, rnd).reshape(b, s, kvh, dh)
    k = k.repeat_interleave(h // kvh, dim=2)
    v = v.repeat_interleave(h // kvh, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", rnd(q), rnd(k)) * dh ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(sc.masked_fill(~causal, -torch.inf), -1)
    out = torch.einsum("bhqk,bkhd->bqhd", rnd(w), rnd(v)).reshape(b, s, h * dh)
    return dense(p["wo"], out, rnd)


def moe(p, x, cfg, rnd: Round = ident):
    """(y, aux): top-k of a softmax router, each token's choices in
    descending gate order; an expert keeps the first ``capacity`` of its
    (token, choice) pairs in token-major order and drops the rest."""
    m = cfg.moe
    b, s, d = x.shape
    t, e, k = b * s, m["num_experts"], m["top_k"]
    c = math.ceil(t * k / e * m["capacity_factor"])
    cap = max(8, min(t, (c + 7) // 8 * 8))
    xt = x.reshape(t, d)
    probs = torch.softmax(xt @ p["router"]["w"], -1)
    gates, idx = torch.topk(probs, k, -1)
    gates = gates / gates.sum(-1, keepdim=True)
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, e)
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    keep = pos < cap
    token = torch.arange(t, device=x.device).repeat_interleave(k)
    y = torch.zeros_like(xt)
    for ex in range(e):
        sel = torch.nonzero((flat == ex) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        xi = rnd(xt[token[sel]])
        hi = F.silu(xi @ rnd(p["gate_w"][ex])) * (xi @ rnd(p["up_w"][ex]))
        y = y.index_add(0, token[sel], (rnd(hi) @ rnd(p["down_w"][ex])) * gates.reshape(-1)[sel, None])
    if m["num_shared"] > 0:
        sg = torch.sigmoid(xt @ p["shared_gate"]["w"])
        y = y + sg * ffn(p["shared"], xt, cfg.ffn_act, rnd)
    f_e = F.one_hot(idx, e).to(torch.float32).mean((0, 1)) * k
    aux = m["router_aux_weight"] * e * torch.sum(f_e * probs.mean(0))
    return y.reshape(b, s, d), aux


def causal_conv(x, w, b):
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, j:j + s] * w[j] for j in range(k)) + b


def chunk_size(size, total):
    size = min(size, total)
    while total % size:
        size //= 2
    return size


def scan(body, state, xs, chunk):
    """``body`` over the chunks of ``xs`` (axis 1), each chunk recomputed
    in the backward pass when autograd records."""
    chunk = chunk_size(chunk, xs[0].shape[1])
    ys = []
    for c0 in range(0, xs[0].shape[1], chunk):
        part = tuple(x[:, c0:c0 + chunk] for x in xs)
        if torch.is_grad_enabled():
            state, y = checkpoint(body, state, *part, use_reentrant=False)
        else:
            state, y = body(state, *part)
        ys.append(y)
    return state, torch.cat(ys, 1)


def _mlstm_chunk(state, q, k, v, i_pre, f_pre):
    c, n, m = state
    hs = []
    for t in range(q.shape[1]):
        log_f = F.logsigmoid(f_pre[:, t])
        m_new = torch.maximum(log_f + m, i_pre[:, t])
        ig = torch.exp(i_pre[:, t] - m_new)
        fg = torch.exp(log_f + m - m_new)
        kt = ig[..., None] * k[:, t]
        c = fg[..., None, None] * c + kt[..., :, None] * v[:, t, ..., None, :]
        n = fg[..., None] * n + kt
        num = torch.einsum("bhd,bhde->bhe", q[:, t], c)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q[:, t], n)), torch.exp(-m_new))
        m = m_new
        hs.append(num / den[..., None])
    return (c, n, m), torch.stack(hs, 1)


def mlstm(p, x, cfg, rnd: Round = ident):
    b, s, _ = x.shape
    di, h, dh = mlstm_dims(cfg)
    xm, z = torch.chunk(dense(p["up"], x, rnd), 2, -1)
    xc = F.silu(causal_conv(xm, p["conv_w"], p["conv_b"]))
    xch, xmh = xc.reshape(b, s, h, dh), xm.reshape(b, s, h, dh)
    q = torch.einsum("bshd,hde->bshe", rnd(xch), rnd(p["wq"]))
    k = torch.einsum("bshd,hde->bshe", rnd(xch), rnd(p["wk"])) / math.sqrt(dh)
    v = torch.einsum("bshd,hde->bshe", rnd(xmh), rnd(p["wv"]))
    i_pre, f_pre = torch.chunk(dense(p["w_if"], xc, rnd) + p["if_bias"], 2, -1)
    state = (x.new_zeros(b, h, dh, dh), x.new_zeros(b, h, dh), x.new_full((b, h), _M0))
    _, hs = scan(_mlstm_chunk, state, (q, k, v, i_pre, f_pre), cfg.seq_chunk)
    out = norm(p["head_norm"], hs.reshape(b, s, di), "rmsnorm") * F.silu(z)
    return dense(p["down"], out, rnd)


def _slstm_body(r, h, dh, rnd):
    def body(state, wx_if, wx_zo):
        c, n, m, hp = state
        d = h * dh
        hs = []
        for t in range(wx_if.shape[1]):
            rh = torch.einsum("bhd,hde->bhe", rnd(hp.reshape(-1, h, dh)), rnd(r)).reshape(-1, 4 * d)
            r_i, r_f, r_z, r_o = torch.chunk(rh, 4, -1)
            i_pre = wx_if[:, t, :d] + r_i
            f_pre = wx_if[:, t, d:] + r_f
            m_new = torch.maximum(f_pre + m, i_pre)
            ig, fg = torch.exp(i_pre - m_new), torch.exp(f_pre + m - m_new)
            c = fg * c + ig * torch.tanh(wx_zo[:, t, :d] + r_z)
            n = fg * n + ig
            hp = torch.sigmoid(wx_zo[:, t, d:] + r_o) * (c / torch.clamp(n, min=1e-6))
            m = m_new
            hs.append(hp)
        return (c, n, m, hp), torch.stack(hs, 1)
    return body


def slstm(p, x, cfg, rnd: Round = ident):
    b, s, d = x.shape
    h = cfg.n_heads
    xc = F.silu(causal_conv(x, p["conv_w"], p["conv_b"]))
    bias_if, bias_zo = torch.chunk(p["gate_bias"], 2)
    wx_if = dense(p["w_if"], xc, rnd) + bias_if
    wx_zo = dense(p["w_zo"], x, rnd) + bias_zo
    z = x.new_zeros(b, d)
    state = (z, z, x.new_full((b, d), _M0), z)
    _, hs = scan(_slstm_body(p["r"], h, d // h, rnd), state, (wx_if, wx_zo), cfg.seq_chunk)
    y = dense(p["out"], norm(p["group_norm"], hs, "rmsnorm"), rnd)
    return y + ffn(p["ffn"], y, "geglu", rnd)


_APPLY = {"attn": attention, "mlstm": mlstm, "slstm": slstm}


def hidden(params, tokens, cfg, rnd: Round = ident):
    """Final normed hidden states (B, S, d) and the MoE auxiliary loss."""
    x = params["embed"]["table"][tokens.long()]
    aux = x.new_zeros(())
    for i in range(cfg.n_periods):
        for (mixer, kind), lp in zip(cfg.period, params["layers"]):
            p = map_tree(lambda t: t[i], lp)
            x = x + _APPLY[mixer](p["mixer"], norm(p["norm1"], x, cfg.norm), cfg, rnd)
            if kind != "none":
                hn = norm(p["norm2"], x, cfg.norm)
                if kind == "moe":
                    y, a = moe(p["moe"], hn, cfg, rnd)
                    aux = aux + a
                else:
                    y = ffn(p["ffn"], hn, cfg.ffn_act, rnd)
                x = x + y
    return norm(params["final_norm"], x, cfg.norm), aux


def head_weight(params, cfg):
    return params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]


def logits(params, tokens, cfg, rnd: Round = ident):
    """(B, S, V) float32 logits of every position."""
    x, _ = hidden(params, tokens, cfg, rnd)
    return rnd(x) @ rnd(head_weight(params, cfg))


def loss(params, batch, cfg, rnd: Round = ident, chunk: int = 512):
    """Mean next-token cross-entropy plus the MoE auxiliary loss, the
    logits formed a sequence chunk at a time."""
    x, aux = hidden(params, batch["tokens"], cfg, rnd)
    w = head_weight(params, cfg)
    labels = batch["labels"].long()
    b, s, _ = x.shape
    chunk = chunk_size(chunk, s)
    nll = x.new_zeros(())
    for c0 in range(0, s, chunk):
        lg = rnd(x[:, c0:c0 + chunk]) @ rnd(w)
        ll = torch.gather(lg, -1, labels[:, c0:c0 + chunk, None])[..., 0]
        nll = nll + (torch.logsumexp(lg, -1) - ll).sum()
    return nll / (b * s) + aux


class _Round(torch.autograd.Function):
    """``fwd(x)`` forward; the gradient that reaches x rounded by ``bwd``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _scaled(dtype, top):
    """Rounding to a float8 format with one scale for the tensor (its
    largest magnitude at the format's ``top``)."""
    def rnd(x):
        s = top / x.abs().amax().clamp(min=1e-30)
        return (x * s).to(dtype).to(x.dtype) / s
    return rnd


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


_E4M3 = _scaled(torch.float8_e4m3fn, 448.0)
_E5M2 = _scaled(torch.float8_e5m2, 57344.0)


def round_fp8(x: Tensor) -> Tensor:
    """A product's operand as float8 training has it: e4m3 forward, the
    gradient that reaches it e5m2."""
    return _Round.apply(x, _E4M3, _E5M2)


def round_bf16(x: Tensor) -> Tensor:
    """The same in bfloat16, forward and backward."""
    return _Round.apply(x, _bf16, _bf16)


PRECISIONS = {"float32": ident, "float8": round_fp8, "bfloat16": round_bf16}


def rounding(name: Optional[str]) -> Round:
    return PRECISIONS[name or "float32"]
