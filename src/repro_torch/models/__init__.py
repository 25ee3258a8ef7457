"""Model zoo of the port: one composable decoder covering all ten
architectures, for training and serving.

    layers       norms, FFNs, embeddings, RoPE, soft-capping
    attention    GQA chunked (online-softmax) attention + cached decode
    ssm          Mamba selective-scan mixer
    xlstm        mLSTM / sLSTM blocks
    moe          top-k capacity-dispatch Mixture-of-Experts
    transformer  period-stacked parameters, train / prefill / decode
    carry        the reference's weights as the port's parameters
"""

from repro_torch.models.carry import params_from_numpy
from repro_torch.models.transformer import (
    ParamTree, active_param_count, forward_decode, forward_hidden,
    forward_prefill, forward_train, init_caches, init_params, lm_head_weight,
    param_count,
)

__all__ = ["ParamTree", "init_params", "forward_hidden", "forward_train",
           "forward_prefill", "forward_decode", "init_caches",
           "lm_head_weight", "param_count", "active_param_count",
           "params_from_numpy"]
