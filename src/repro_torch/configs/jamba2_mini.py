"""jamba2-mini  [hybrid]  — AI21-Jamba2-Mini, the published Jamba block.

32L d_model=4096 32H (GQA kv=8, d_head 128) vocab=65536, untied
[hf:ai21labs/AI21-Jamba2-Mini config.json; arXiv:2403.19887, 2408.12570].
Period of 8 layers: attention at offset 4, Mamba-1 elsewhere; MoE (16
experts of 14336, top-2, none shared) on every odd layer, a dense SwiGLU
of 14336 on the others.  Mamba: d_state 16, d_conv 4, expand 2 (inner
8192), dt_rank 256, conv bias, RMSNorms on dt, B and C.  Attention has no
positional encoding; the router's top-2 softmax weights are used as they
are, and no token is dropped.

The port's own id: the JAX package has no twin of it, so it is kept out
of ``ARCHS`` (the ids the tests hold against the reference) and listed in
``PORT_ARCHS``.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

_PERIOD = tuple(
    LayerSpec(mixer=("attn" if i == 4 else "mamba"),
              ffn=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba2-mini",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=65536, period=_PERIOD,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336,
                  capacity_factor=None, normalize_topk=False),
    d_inner=8192, d_state=16, dt_rank=256, conv_kernel=4,
    mamba_inner_norm=True, rope_theta=None, sub_quadratic=True,
)

SMOKE = CONFIG.scaled(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=256, d_inner=128, d_state=4, dt_rank=8,
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=64,
                  capacity_factor=None, normalize_topk=False),
    seq_chunk=32,
)
