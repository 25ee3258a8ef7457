"""chameleon-34b  [vlm]  — early-fusion over VQ image tokens, QK-norm.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
[arXiv:2405.09818; unverified]
The modality frontend is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings (B, S, d); decode runs over the unified
text+image token vocabulary.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab_size=65536, period=(LayerSpec("attn", "dense"),),
    qk_norm=True, embedding_input=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab_size=256, seq_chunk=32)
