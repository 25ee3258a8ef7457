"""Roofline model of the port: QR flops, modeled seconds, per-cell costs.

Counterpart of the reference's ``repro.launch.roofline``, with one NVIDIA
H100's peaks in place of the TPU's.  The peaks are NVIDIA's data-sheet
figures for the H100 SXM part (dense, no sparsity, at its 700 W limit):

    FP32 (CUDA cores)   67 TFLOP/s   the kernels' FMA roof
    FP64                34 TFLOP/s
    BF16 tensor cores  989 TFLOP/s   the dense decoder's matmuls
    HBM3              3.35 TB/s

A card set below 700 W runs slower under load; a share of these peaks
is stated beside the card's power limit.

    modeled_seconds = max(flops / peak(dtype), hbm_bytes / HBM_BW)

FLOPs and HBM bytes of a model cell are analytic, from the architecture
and the cell's shape, with the reference's conventions: attention counts
the full masked S^2 blocks unless ``attn_causal_skip``; training FLOPs
= 4 x forward + the QR-Muon optimizer's QR cost; MODEL_FLOPS = 6 N_active
D.  Parameter counts come from the port's ``init_params`` on the
``meta`` device (no allocation); MoE's active count takes top_k of the
routed experts.

The per-cell table (:func:`roofline_row`, :func:`build_table`,
``python -m repro_torch.launch.roofline``) reads the artifacts of
:mod:`repro_torch.launch.dryrun` as the reference's reads its own:

    compute_s    = FLOPs / (chips * PEAK_FLOPS["bfloat16"])
    memory_s     = HBM_bytes / (chips * HBM_BW)
    collective_s = collective bytes per rank / LINK_BW

FLOPs and HBM bytes are the analytic model above; the collective bytes
are the artifact's (counted from the placements).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

#: Data-sheet peak FLOP/s of one H100 SXM, by operand type.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
#: Data-sheet HBM3 bandwidth of one H100 SXM, bytes/s.
HBM_BW = 3.35e12
#: Data-sheet NVLink 4 bandwidth of one H100 SXM, bytes/s (18 links, 900
#: GB/s in all), in place of the reference's ICI link rate.  NVLink joins
#: the 8 GPUs of one node; a 16-wide model axis spans two such nodes, and
#: its collectives cross the network between them (400 Gb/s, 50 GB/s, a
#: GPU on a DGX H100).  The roofline charges every collective byte at
#: this rate all the same, so on such meshes ``collective_s`` is a lower
#: bound.
LINK_BW = 900e9

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "CellCost",
           "analytic_cell_cost", "roofline_row", "build_table",
           "format_markdown", "main", "modeled_seconds", "qr_flops",
           "n_active_traffic"]


# ----------------------------------------------------- generic roofline

def qr_flops(m: int, n: int) -> float:
    """Householder QR flop count: ``2 k^2 (max(m, n) - k/3)`` with
    ``k = min(m, n)`` — the effective-GFLOPs convention of the QR
    benchmarks, shared with the tuner's candidate pruning."""
    k = min(m, n)
    return 2.0 * k * k * (max(m, n) - k / 3.0)


def modeled_seconds(flops: float, hbm_bytes: float, *, chips: int = 1,
                    dtype: str = "float32") -> float:
    """Roofline lower bound on one kernel: the larger of the compute term
    at ``dtype``'s peak and the HBM term, on ``chips`` cards."""
    return max(flops / (chips * PEAK_FLOPS[str(dtype).replace("torch.", "")]),
               hbm_bytes / (chips * HBM_BW))


# ------------------------------------------------------------- flop model

def _attn_flops(cfg: ModelConfig, t: int, s_ctx: int,
                window: Optional[int] = None) -> float:
    """One attention layer on t query tokens against s_ctx keys."""
    d, dq, dkv = cfg.d_model, cfg.d_q, cfg.d_kv
    proj = 2 * t * d * (dq + 2 * dkv) + 2 * t * dq * d
    frac = 1.0
    if getattr(cfg, "attn_causal_skip", False) and t > 1:
        c = max(cfg.seq_chunk, 1024)
        nk = max(1, s_ctx // c)
        if window is not None:
            frac = min(1.0, (window / c + 2) / nk)
        else:
            frac = (nk + 1) / (2.0 * nk)    # lower-triangular blocks only
    scores_av = 4 * t * s_ctx * dq * frac   # QK^T + AV
    return proj + scores_av


def _ffn_flops(cfg: ModelConfig, t: int) -> float:
    mats = 3 if cfg.ffn_act in ("swiglu", "geglu") else 2
    return 2 * mats * t * cfg.d_model * cfg.d_ff


def _moe_flops(cfg: ModelConfig, t: int) -> float:
    moe = cfg.moe
    if moe.capacity_factor is None:      # dropless: the routed pairs alone
        slots = t * moe.top_k
    else:
        slots = moe.num_experts * max(8, min(t, math.ceil(
            t * moe.top_k / moe.num_experts * moe.capacity_factor + 7) // 8 * 8))
    mats = 3 if cfg.ffn_act in ("swiglu", "geglu") else 2
    routed = 2 * mats * slots * cfg.d_model * moe.d_expert
    shared = 2 * mats * t * cfg.d_model * (moe.num_shared * moe.d_expert)
    router = 2 * t * cfg.d_model * moe.num_experts
    return routed + shared + router


def _mamba_flops(cfg: ModelConfig, t: int) -> float:
    d = cfg.d_model
    di = cfg.d_inner or 2 * d
    ds = cfg.d_state
    dtr = cfg.dt_rank or math.ceil(d / 16)
    proj = 2 * t * d * 2 * di + 2 * t * di * d
    conv = 2 * t * di * cfg.conv_kernel
    ssm_in = 2 * t * di * (dtr + 2 * ds) + 2 * t * dtr * di
    scan = 8 * t * di * ds
    return proj + conv + ssm_in + scan


def _mlstm_flops(cfg: ModelConfig, t: int) -> float:
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    h = cfg.n_heads
    dh = di // h
    proj = 2 * t * d * 2 * di + 2 * t * di * d
    qkv = 3 * 2 * t * di * dh                  # block-diagonal per head
    cell = 6 * t * h * dh * dh
    return proj + qkv + cell + 2 * t * di * cfg.conv_kernel


def _slstm_flops(cfg: ModelConfig, t: int) -> float:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    gates = 2 * t * d * 4 * d
    rec = 2 * t * h * dh * 4 * dh
    ffn_dim = int(round(cfg.slstm_ffn_factor * d / 64) * 64)
    return gates + rec + 2 * t * d * d + 6 * t * d * ffn_dim + \
        2 * t * d * cfg.conv_kernel


def _layer_flops(cfg: ModelConfig, spec, t: int, s_ctx: int) -> float:
    mixer = {
        "attn": lambda: _attn_flops(cfg, t, s_ctx),
        "attn_local": lambda: _attn_flops(cfg, t, s_ctx, window=cfg.window),
        "mamba": lambda: _mamba_flops(cfg, t),
        "mlstm": lambda: _mlstm_flops(cfg, t),
        "slstm": lambda: _slstm_flops(cfg, t),
    }[spec.mixer]()
    ffn = {"dense": lambda: _ffn_flops(cfg, t),
           "moe": lambda: _moe_flops(cfg, t),
           "none": lambda: 0.0}[spec.ffn]()
    return mixer + ffn


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: shapes
    without storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _meta_params(cfg: ModelConfig):
    from repro_torch.models import init_params

    return init_params(_MetaGenerator(), cfg)


def _param_counts(cfg: ModelConfig) -> tuple:
    """(total, active) parameter counts — analytic, no allocation."""
    from repro_torch.models import active_param_count, param_count

    params = _meta_params(cfg)
    return param_count(params), active_param_count(params, cfg)


def _qr_optimizer_flops(cfg: ModelConfig) -> float:
    """QR-Muon orthogonalization cost per step: blocked MHT QR (~4 m n^2
    with the masked full-width fori) + thin-Q formation, over the leaves
    the port's ``is_muon_param`` sends to Muon.  Period-stacked vectors
    (norm gains) are not among them (ROADMAP C5), so with 8 or more
    periods this is less than the reference's count."""
    from repro_torch.optim.qr_muon import is_muon_param

    total = 0.0
    for name, leaf in _meta_params(cfg).named_parameters():
        if not is_muon_param(name, leaf):
            continue
        lead = math.prod(leaf.shape[:-2])
        m, n = sorted(leaf.shape[-2:], reverse=True)
        total += lead * 8.0 * m * n * n
    return total


@dataclasses.dataclass
class CellCost:
    flops: float
    hbm_bytes: float
    model_flops: float
    params_total: int
    params_active: int
    tokens: int


def analytic_cell_cost(cfg: ModelConfig, shape: ShapeConfig,
                       kind: str) -> CellCost:
    n_total, n_active = _param_counts(cfg)
    b, s = shape.global_batch, shape.seq_len

    if kind == "decode":
        t, s_ctx, d_tokens = b, s, b
    else:
        t, s_ctx, d_tokens = b * s, s, b * s

    fwd = 0.0
    per_period = cfg.n_layers // len(cfg.period)
    for spec in cfg.period:
        fwd += per_period * _layer_flops(cfg, spec, t, s_ctx)
    head_tokens = b if kind == "prefill" else t
    fwd += 2 * head_tokens * cfg.d_model * cfg.vocab_size
    if cfg.embedding_input and kind != "decode":
        fwd += 2 * t * cfg.d_model * cfg.d_model  # adapter

    if kind == "train":
        flops = 4.0 * fwd + _qr_optimizer_flops(cfg)
        model_flops = 6.0 * n_active * d_tokens
    else:
        flops = fwd
        model_flops = 2.0 * n_active * d_tokens

    # ----------------------------------------------------- traffic model
    if kind == "train":
        # fp32 params+grads+opt read/write (~28 N) + bf16 weight casts per
        # microbatch + activations ~10 passes of (T, d) per layer
        n_micro = 1
        hbm = 28.0 * n_total + 10.0 * cfg.n_layers * t * cfg.d_model * 2
        hbm += 2.0 * n_total * n_micro
    elif kind == "prefill":
        cache = 2 * sum(1 for sp in cfg.period if "attn" in sp.mixer) \
            * per_period * t * cfg.d_kv * 2
        hbm = 2.0 * n_active_traffic(cfg, n_total) + \
            6.0 * cfg.n_layers * t * cfg.d_model * 2 + cache
    else:  # decode: params + full cache read dominate
        n_attn = sum(1 for sp in cfg.period if "attn" in sp.mixer) * per_period
        cache = 2 * n_attn * b * s * cfg.d_kv * 2
        state = _state_bytes(cfg, b)
        hbm = 2.0 * n_active_traffic(cfg, n_total) + cache + state

    return CellCost(flops=flops, hbm_bytes=hbm, model_flops=model_flops,
                    params_total=n_total, params_active=n_active,
                    tokens=d_tokens)


def n_active_traffic(cfg: ModelConfig, n_total: int) -> float:
    """Weights actually read per step (MoE: top-k of expert weights are
    touched per token, but with E*C dispatch all experts stream once)."""
    return float(n_total)


def _state_bytes(cfg: ModelConfig, b: int) -> float:
    per_period = cfg.n_layers // len(cfg.period)
    total = 0.0
    for sp in cfg.period:
        if sp.mixer == "mamba":
            di = cfg.d_inner or 2 * cfg.d_model
            total += per_period * b * di * cfg.d_state * 4 * 2
        elif sp.mixer == "mlstm":
            di = int(cfg.mlstm_proj_factor * cfg.d_model)
            dh = di // cfg.n_heads
            total += per_period * b * cfg.n_heads * dh * dh * 4 * 2
        elif sp.mixer == "slstm":
            total += per_period * b * cfg.d_model * 4 * 8
    return total


# ------------------------------------------------------------- table

def roofline_row(artifact: dict, *, chips: Optional[int] = None) -> dict:
    """One cell's roofline row from its dry-run artifact."""
    from repro_torch.configs import SHAPES, get_config

    arch, shape_name = artifact["arch"], artifact["shape"]
    cfg = get_config(arch)
    if artifact.get("variant") == "optimized":
        cfg = cfg.scaled(attn_causal_skip=True)
    shape = SHAPES[shape_name]
    kind = artifact.get("kind", shape.kind)
    chips = chips or artifact.get("devices", 256)
    cost = analytic_cell_cost(cfg, shape, kind)

    coll = artifact.get("collectives", {})
    coll_per_shard = coll.get("total_weighted_bytes") or coll.get(
        "total_bytes", 0)
    peak = PEAK_FLOPS["bfloat16"]
    compute_s = cost.flops / (chips * peak)
    memory_s = cost.hbm_bytes / (chips * HBM_BW)
    collective_s = coll_per_shard / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    # The useful-FLOP utilization the dominant term allows (perfect
    # overlap): what MFU this cell could reach.
    mfu_bound = (cost.model_flops / (chips * peak * bound_s)
                 if bound_s > 0 else 0.0)
    return dict(
        arch=arch, shape=shape_name, mesh=artifact["mesh"], kind=kind,
        status=artifact["status"], chips=chips,
        flops=cost.flops, hbm_bytes=cost.hbm_bytes,
        collective_bytes_per_shard=coll_per_shard,
        **terms,
        dominant=dominant.replace("_s", ""),
        roofline_fraction=mfu_bound,
        compute_share=compute_s / bound_s if bound_s > 0 else 0.0,
        model_flops=cost.model_flops,
        model_to_hlo=cost.model_flops / cost.flops if cost.flops else 0.0,
        params_total=cost.params_total, params_active=cost.params_active,
        hlo_flops_reported=artifact.get("cost_analysis", {}).get("flops"),
        temp_bytes=artifact.get("memory_analysis", {}).get(
            "temp_size_in_bytes"),
    )


def build_table(artifact_dir: str, mesh: str = "pod16x16") -> list:
    """Rows of every dry-run artifact of ``mesh`` in ``artifact_dir``."""
    rows = []
    for path in sorted(glob.glob(os.path.join(artifact_dir,
                                              f"*__{mesh}.json"))):
        with open(path) as f:
            art = json.load(f)
        if art["status"] == "ok":
            rows.append(roofline_row(art))
        else:
            rows.append(dict(arch=art["arch"], shape=art["shape"],
                             mesh=art["mesh"], status=art["status"],
                             reason=art.get("reason", art.get("error", ""))))
    return rows


def format_markdown(rows: list) -> str:
    hdr = ("| arch | shape | status | compute_s | memory_s | collective_s | "
           "dominant | roofline_frac | MODEL/HLO |")
    lines = [hdr, "|" + "---|" * 9]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']}"
                         f" | - | - | - | - | - | - |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"{r['dominant']} | {r['roofline_fraction']:.3f} | "
            f"{r['model_to_hlo']:.3f} |")
    return "\n".join(lines)


def main(argv=None) -> list:
    from repro_torch.launch.dryrun import DEFAULT_OUT

    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default=DEFAULT_OUT)
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--out", default=os.path.join(DEFAULT_OUT,
                                                  "roofline.json"))
    args = ap.parse_args(argv)
    rows = build_table(args.artifacts, args.mesh)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(format_markdown(rows))
    return rows


if __name__ == "__main__":
    main()
