"""Model zoo of the port: the dense decoder (attention mixers, dense
FFNs) for training.

    layers       norms, FFNs, embeddings, RoPE, soft-capping
    attention    GQA chunked (online-softmax) attention
    transformer  period-stacked parameters, the training forward pass
    carry        the reference's weights as the port's parameters
"""

from repro_torch.models.carry import params_from_numpy
from repro_torch.models.transformer import (
    ParamTree, forward_hidden, forward_train, init_params, lm_head_weight,
    param_count,
)

__all__ = ["ParamTree", "init_params", "forward_hidden", "forward_train",
           "lm_head_weight", "param_count", "params_from_numpy"]
