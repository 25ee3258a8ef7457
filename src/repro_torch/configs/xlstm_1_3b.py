"""xlstm-1.3b  [ssm]  — sLSTM + mLSTM blocks (xLSTM[7:1]).

48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304  [arXiv:2405.04517; unverified]
Period of 8: seven mLSTM blocks (matrix memory, internal 2x projection, no
separate FFN) then one sLSTM block (scalar memory + 4/3 gated FFN).
Recurrent -> O(1) decode state -> runs the long_500k cell.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_PERIOD = tuple(LayerSpec("mlstm", "none") for _ in range(7)) + (
    LayerSpec("slstm", "none"),)

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_head=512,
    d_ff=0, vocab_size=50304, period=_PERIOD,
    norm="layernorm", mlstm_proj_factor=2.0, conv_kernel=4,
    sub_quadratic=True, tie_embeddings=True,
)

SMOKE = CONFIG.scaled(n_layers=8, d_model=64, n_heads=2, n_kv_heads=2,
                      d_head=32, vocab_size=256, seq_chunk=32)
