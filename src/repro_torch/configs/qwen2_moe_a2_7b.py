"""qwen2-moe-a2.7b  [moe]  — 60 routed experts top-4 + 4 shared experts.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
d_ff is the per-expert width; the 4 shared experts are fused into one
sigmoid-gated dense FFN of width 4*1408.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab_size=151936, period=(LayerSpec("attn", "moe"),),
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408, num_shared=4),
    qkv_bias=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_head=16, d_ff=32, vocab_size=256,
                      moe=MoEConfig(num_experts=6, top_k=2, d_expert=32,
                                    num_shared=2), seq_chunk=32)
