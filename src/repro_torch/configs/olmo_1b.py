"""olmo-1b  [dense]  — non-parametric LayerNorm, SwiGLU, tied embeddings.

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304  [arXiv:2402.00838; hf]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=8192, vocab_size=50304, period=(LayerSpec("attn", "dense"),),
    norm="nonparam_ln", ffn_act="swiglu", tie_embeddings=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_head=16, d_ff=128, vocab_size=256, seq_chunk=32)
