"""phi3.5-moe-42b-a6.6b  [moe]  — 16 experts, top-2 routing.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=6400, vocab_size=32064, period=(LayerSpec("attn", "moe"),),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=6400),
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=64, vocab_size=256,
                      moe=MoEConfig(num_experts=4, top_k=2, d_expert=64),
                      seq_chunk=32)
