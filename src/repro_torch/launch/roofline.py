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
``meta`` device (no allocation), so the mixers and FFNs the port does not
have yet (ROADMAP A16) raise ``NotImplementedError`` here as they do
there.  The per-cell table reads the dry-run artifacts of A16's
launchers, which the port does not have: :func:`roofline_row`,
:func:`build_table` and the CLI raise until then.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

#: Data-sheet peak FLOP/s of one H100 SXM, by operand type.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
#: Data-sheet HBM3 bandwidth of one H100 SXM, bytes/s.
HBM_BW = 3.35e12

__all__ = ["PEAK_FLOPS", "HBM_BW", "CellCost", "analytic_cell_cost",
           "roofline_row", "build_table", "main", "modeled_seconds",
           "qr_flops", "n_active_traffic"]


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


def _layer_flops(cfg: ModelConfig, spec, t: int, s_ctx: int) -> float:
    """The port's mixers and FFNs only: MoE and the recurrent mixers are
    costed with their port (A16); :func:`_param_counts` raises first."""
    mixer = {
        "attn": lambda: _attn_flops(cfg, t, s_ctx),
        "attn_local": lambda: _attn_flops(cfg, t, s_ctx, window=cfg.window),
    }[spec.mixer]()
    ffn = {"dense": lambda: _ffn_flops(cfg, t),
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
    """(total, active) parameter counts — analytic, no allocation.  The
    port's models are dense (MoE raises, A16), so active == total."""
    total = sum(p.numel() for p in _meta_params(cfg).parameters())
    return total, total


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

def _a16(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} reads the dry-run artifacts of the port's launchers, which "
        f"are not ported yet (ROADMAP A16)")


def roofline_row(artifact: dict, *, chips: Optional[int] = None) -> dict:
    """One cell's roofline row from its dry-run artifact (ROADMAP A16)."""
    raise _a16("roofline_row")


def build_table(artifact_dir: str, mesh: str = "pod16x16") -> list:
    """Rows of every dry-run artifact in ``artifact_dir`` (ROADMAP A16)."""
    raise _a16("build_table")


def main() -> None:
    raise _a16("python -m repro_torch.launch.roofline")


if __name__ == "__main__":
    main()
