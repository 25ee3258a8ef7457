"""qwen2.5-32b  [dense]  — GQA with QKV bias, SwiGLU, RMSNorm.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
[hf:Qwen/Qwen2.5-0.5B family; hf]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=27648, vocab_size=152064, period=(LayerSpec("attn", "dense"),),
    qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=160, vocab_size=256, seq_chunk=32)
