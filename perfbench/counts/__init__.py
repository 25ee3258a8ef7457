"""The work the benchmark divides by: FLOPs and bytes from shapes alone,
the same whatever implements them, and the H100's published peaks.

* :func:`qr_flops` / :func:`qr_bytes`: one tall m x n member's
  orthogonalization (Householder factorization plus forming the thin Q;
  the member read once, its Q written once, float32).
* :func:`muon_members`: the tall-oriented matrices a QR-Muon step
  orthogonalizes, from the parameter shapes.
* :func:`train_flops`: model FLOPs of one training step, 6 a token for
  each active parameter in a matrix product (experts at top-k plus the
  shared ones, the output head counted, the embedding lookup not), plus
  attention's causal score and value products and the mLSTM's memory
  products, forward and backward; recompute not counted.
* :func:`decode_flops` / :func:`decode_bytes`: one decode step of a
  batch: the same products forward only; the weights read once in bf16
  and the recurrent states read and written once at their stored dtype.
"""

from __future__ import annotations

import math

from perfbench.reference import model as ref_model
from perfbench.reference import muon as ref_muon

# One NVIDIA H100 SXM, NVIDIA's data sheet (dense rates).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def qr_flops(m: int, n: int) -> float:
    """Factor (2 m n^2 - 2/3 n^3) plus form the thin Q (the same again)
    of a tall m x n matrix (m >= n)."""
    m, n = max(m, n), min(m, n)
    return 2 * (2.0 * m * n * n - 2.0 / 3.0 * n ** 3)


def qr_bytes(m: int, n: int, itemsize: int = 4) -> float:
    return 2.0 * m * n * itemsize


def muon_members(cfg) -> list:
    """(m, n), m >= n, of every matrix a QR-Muon step orthogonalizes."""
    out = []
    for name, init in ref_model.leaves(ref_model.param_spec(cfg)):
        if ref_muon.is_muon(name, init.shape):
            m, n = init.shape[-2:]
            out += [(max(m, n), min(m, n))] * math.prod(init.shape[:-2])
    return out


def qr_step(cfg) -> dict:
    members = muon_members(cfg)
    flops = sum(qr_flops(m, n) for m, n in members)
    nbytes = sum(qr_bytes(m, n) for m, n in members)
    return {"members": len(members), "flops": flops, "bytes": nbytes,
            "roofline_s": max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)}


def matmul_params(cfg) -> float:
    """Active parameters in matrix products a token: every dense weight,
    the MoE's top-k routed experts and shared experts, the router, the
    block-diagonal mLSTM / sLSTM head matrices, and the output head."""
    total = 0.0
    for name, init in ref_model.leaves(ref_model.param_spec(cfg)):
        parts = name.split(".")
        if parts[-1] in ("g", "b", "conv_w", "conv_b", "if_bias", "gate_bias") \
                or parts[0] in ("embed", "final_norm"):
            continue
        n = math.prod(init.shape)
        if parts[-1] in ("gate_w", "up_w", "down_w"):
            n = n * cfg.moe["top_k"] / cfg.moe["num_experts"]
        total += n
    if cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model
    return total


def _mixer_flops(cfg, tokens: int, seq: int) -> float:
    """Forward FLOPs of the products that are not weights: attention's
    causal QK^T and AV, and the mLSTM's memory update and read."""
    flops = 0.0
    for mixer, _ in cfg.period:
        if mixer == "attn":
            flops += 4.0 * tokens * (seq + 1) / 2 * cfg.n_heads * cfg.d_head
        elif mixer == "mlstm":
            _, h, dh = ref_model.mlstm_dims(cfg)
            flops += 4.0 * tokens * h * dh * dh
    return flops * cfg.n_periods


def train_flops(cfg, batch: int, seq: int) -> float:
    tokens = batch * seq
    return 6.0 * matmul_params(cfg) * tokens + 3.0 * _mixer_flops(cfg, tokens, seq)


def decode_flops(cfg, batch: int, context: int) -> float:
    """One decode step: ``batch`` tokens, each against ``context``
    earlier positions (attention only)."""
    return 2.0 * matmul_params(cfg) * batch + _mixer_flops(cfg, batch, 2 * context - 1)


def state_bytes(cfg, batch: int) -> float:
    """The float32 recurrent state of a batch (mLSTM: C, n, m and the conv
    window; sLSTM: c, n, m, h and the conv window)."""
    total = 0.0
    for mixer, _ in cfg.period:
        if mixer == "mlstm":
            di, h, dh = ref_model.mlstm_dims(cfg)
            total += batch * (h * dh * dh + h * dh + h + (cfg.conv_kernel - 1) * di)
        elif mixer == "slstm":
            total += batch * cfg.d_model * (4 + cfg.conv_kernel - 1)
    return 4.0 * total * cfg.n_periods


def decode_bytes(cfg, batch: int) -> float:
    params = sum(math.prod(i.shape) for _, i in ref_model.leaves(ref_model.param_spec(cfg)))
    return 2.0 * params + 2.0 * state_bytes(cfg, batch)
