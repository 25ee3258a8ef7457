"""Config schema for the model zoo and run shapes.

One ``ModelConfig`` fully determines a model: the layer *period* (a short
pattern of (mixer, ffn) specs tiled n_layers/len(period) times) composes
dense/GQA attention, local attention, Mamba, mLSTM/sLSTM and dense/MoE
FFNs into any of the assigned architectures.  Parameters are stacked
over periods (one leaf per period position, leading axis ``n_periods``).
A copy of the reference's ``repro.configs.base``: shapes only, no
weights.  Three switches are the port's own, for the published Jamba
block (``jamba2-mini``): ``ModelConfig.mamba_inner_norm``,
``rope_theta=None`` and ``MoEConfig(capacity_factor=None,
normalize_topk=False)``; their defaults are the reference's behaviour.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["LayerSpec", "MoEConfig", "ModelConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position in the layer period."""

    mixer: str          # "attn" | "attn_local" | "mamba" | "mlstm" | "slstm"
    ffn: str = "dense"  # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0          # always-on shared experts (qwen2-moe style)
    # None: dropless, every routed (token, choice) pair computed (jamba)
    capacity_factor: Optional[float] = 1.25
    router_aux_weight: float = 0.01
    normalize_topk: bool = True  # False: top-k softmax weights as they are (jamba)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    period: Tuple[LayerSpec, ...]
    # families / options
    norm: str = "rmsnorm"              # "rmsnorm" | "layernorm" | "nonparam_ln"
    ffn_act: str = "swiglu"            # "swiglu" | "geglu" | "gelu"
    qkv_bias: bool = False
    qk_norm: bool = False              # chameleon
    rope_theta: Optional[float] = 10_000.0   # None: no positional encoding (jamba)
    logit_softcap: Optional[float] = None   # gemma2
    attn_softcap: Optional[float] = None    # gemma2
    window: Optional[int] = None            # local-attention window
    post_norm: bool = False                 # gemma2 sandwich norms
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    embedding_input: bool = False           # vlm/audio stub: inputs are embeds
    # ssm (mamba)
    d_inner: Optional[int] = None
    d_state: int = 16
    dt_rank: Optional[int] = None
    conv_kernel: int = 4
    mamba_inner_norm: bool = False     # RMSNorms on dt, B and C (jamba)
    # xlstm
    mlstm_proj_factor: float = 2.0
    slstm_ffn_factor: float = 1.3334
    # numerics / scan
    dtype: str = "bfloat16"
    seq_chunk: int = 512               # flash/scan chunk for long sequences
    attn_causal_skip: bool = False     # predicated causal block skipping
    remat: str = "nothing"             # "nothing" | "dots" | "none"
    sub_quadratic: bool = False        # eligible for long_500k

    def __post_init__(self):
        if self.n_layers % len(self.period) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"period length {len(self.period)}")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head

    def scaled(self, **kw) -> "ModelConfig":
        """A reduced copy for smoke tests (see tests/test_models_smoke.py)."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
