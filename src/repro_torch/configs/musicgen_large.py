"""musicgen-large  [audio]  — decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf]
The EnCodec frontend is a STUB per the assignment: input_specs() supplies
precomputed frame embeddings; the backbone is a plain GELU/LayerNorm
decoder over the 2048-entry codebook (RoPE substitutes the original
sinusoidal positions — noted in DESIGN.md).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab_size=2048, period=(LayerSpec("attn", "dense"),),
    norm="layernorm", ffn_act="gelu", embedding_input=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_head=16, d_ff=128, vocab_size=64, seq_chunk=32)
