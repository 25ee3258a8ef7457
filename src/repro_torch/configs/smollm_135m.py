"""smollm-135m  [dense]  — llama-architecture small model.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M; hf]
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_head=64,
    d_ff=1536, vocab_size=49152, period=(LayerSpec("attn", "dense"),),
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(n_layers=3, d_model=48, n_heads=3, n_kv_heads=3,
                      d_head=16, d_ff=96, vocab_size=256, seq_chunk=32)
