"""jamba-v0.1-52b  [hybrid]  — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536  [arXiv:2403.19887; hf]
Period of 8 layers: attention at position 4, Mamba elsewhere; MoE replaces
the dense MLP on every other layer (e/a = 2).  Sub-quadratic -> runs the
long_500k cell.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

_PERIOD = tuple(
    LayerSpec(mixer=("attn" if i == 4 else "mamba"),
              ffn=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=65536, period=_PERIOD,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336),
    d_inner=8192, d_state=16, conv_kernel=4,
    rope_theta=10_000.0, sub_quadratic=True,
)

SMOKE = CONFIG.scaled(
    n_layers=16, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=256, d_inner=128, d_state=4,
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=64), seq_chunk=32,
)
