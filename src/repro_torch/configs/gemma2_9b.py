"""gemma2-9b  [dense]  — local/global alternating attention, logit softcap.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000  [arXiv:2408.00118; hf]
Period of 2: 4096-window local layer then global layer; attention-score
softcap 50, final-logit softcap 30, sandwich (pre+post) RMSNorm, GeGLU.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_head=256,
    d_ff=14336, vocab_size=256000,
    period=(LayerSpec("attn_local", "dense"), LayerSpec("attn", "dense")),
    window=4096, attn_softcap=50.0, logit_softcap=30.0, post_norm=True,
    ffn_act="geglu", tie_embeddings=True,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab_size=256, window=16,
                      seq_chunk=32)
