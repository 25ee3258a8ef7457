"""The work of a Jamba decode step (``perfbench/reference/jamba.py``'s
tree), from shapes alone, the same whatever implements it; the peaks are
:mod:`perfbench.counts`'.

* :func:`decode_flops`: one decode step of a batch: 2 FLOPs a token for
  each parameter in a matrix product (the experts at top-k, the router
  and the head counted; the embedding lookup, norms, conv and scan
  constants not), attention's scores and values against the context, and
  the scan's output product C . h.
* :func:`decode_bytes`: the weights read once in bf16 (of the embedding
  table only the batch's rows), the K/V cache read once over the context
  and the new K/V written, the float32 Mamba states (scan and conv
  window) read and written once.
* :func:`moe_step`: the MoE layers of a decode step at their roofline:
  the routed (token, choice) pairs' expert products and the router, over
  the bf16 expert weights read once, the router's float32 weight, and
  the tokens read and written once in bf16.
"""

from __future__ import annotations

import math

from perfbench.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from perfbench.reference import jamba as ref_model
from perfbench.reference.model import leaves

_NOT_PRODUCTS = ("g", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip")
_EXPERTS = ("gate_w", "up_w", "down_w")


def _leaves(cfg):
    return leaves(ref_model.param_spec(cfg))


def matmul_params(cfg) -> float:
    """Active parameters in matrix products a token: the experts at
    top_k of num_experts, every other product's weight whole, the head."""
    moe = cfg.moe
    total = 0.0
    for name, init in _leaves(cfg):
        last = name.split(".")[-1]
        if last in _NOT_PRODUCTS or name.startswith(("embed", "final_norm")):
            continue
        n = math.prod(init.shape)
        if last in _EXPERTS:
            n = n * moe["top_k"] / moe["num_experts"]
        total += n
    return total


def _kinds(cfg, mixer):
    return sum(m == mixer for m, _ in cfg.period) * cfg.n_periods


def decode_flops(cfg, batch: int, context: int) -> float:
    """One decode step: ``batch`` tokens, each against ``context``
    positions in every attention layer."""
    attn = 4.0 * batch * context * cfg.n_heads * cfg.d_head * _kinds(cfg, "attn")
    scan = 2.0 * batch * cfg.d_inner * cfg.d_state * _kinds(cfg, "mamba")
    return 2.0 * matmul_params(cfg) * batch + attn + scan


def state_bytes(cfg, batch: int) -> float:
    """The float32 Mamba states of a batch: the scan state and the conv
    window."""
    per = cfg.d_inner * (cfg.d_state + cfg.conv_kernel - 1)
    return 4.0 * batch * per * _kinds(cfg, "mamba")


def kv_bytes(cfg, batch: int, context: int) -> float:
    """The bf16 K/V cache over ``context`` positions, all attention
    layers."""
    return 2.0 * 2 * batch * context * cfg.n_kv_heads * cfg.d_head * _kinds(cfg, "attn")


def decode_bytes(cfg, batch: int, context: int) -> float:
    params = sum(math.prod(i.shape) for n, i in _leaves(cfg) if not n.startswith("embed"))
    params += batch * cfg.d_model
    return (2.0 * params + kv_bytes(cfg, batch, context) + kv_bytes(cfg, batch, 1)
            + 2.0 * state_bytes(cfg, batch))


def moe_step(cfg, batch: int) -> dict:
    """The MoE layers of one decode step of ``batch`` tokens: FLOPs,
    bytes and the roofline time, max(FLOPs / bf16 peak, bytes / HBM)."""
    moe, d = cfg.moe, cfg.d_model
    e, k, de = moe["num_experts"], moe["top_k"], moe["d_expert"]
    layers = sum(f == "moe" for _, f in cfg.period) * cfg.n_periods
    flops = layers * (2.0 * batch * k * 3 * d * de + 2.0 * batch * d * e)
    nbytes = layers * (2.0 * 3 * e * d * de + 4.0 * d * e + 2 * 2.0 * batch * d)
    return {"flops": flops, "bytes": nbytes,
            "roofline_s": max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)}
