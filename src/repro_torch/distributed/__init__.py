"""Distribution substrate of the port: QR domain groups and their
collectives, the training meshes' sharding rules as DTensor placements,
gradient compression, the step watchdog and the elastic re-mesh.
"""

from repro_torch.distributed.compression import (
    compressed_psum, dequantize, ef_compress_tree, init_error_state, quantize,
)
from repro_torch.distributed.fault_tolerance import (
    ElasticPlan, StepWatchdog, plan_elastic_mesh,
)
from repro_torch.distributed.sharding import (
    QR_DOMAIN_AXIS, DivergentCopiesError, MeshRules, Spec, activation_policy,
    batch_specs, cache_specs, constrain_decode_scores, constrain_expert_stack,
    constrain_hidden, constrain_logits, constrain_token_stack,
    distribute_tree, largest_pow2, param_specs, placements, row_domain_mesh,
    state_specs, tree_placements, world_size,
)

__all__ = ["StepWatchdog", "ElasticPlan", "plan_elastic_mesh", "quantize",
           "dequantize", "ef_compress_tree", "compressed_psum",
           "init_error_state", "QR_DOMAIN_AXIS", "largest_pow2",
           "row_domain_mesh", "world_size", "DivergentCopiesError",
           "MeshRules", "Spec", "param_specs", "state_specs", "batch_specs",
           "cache_specs", "placements", "tree_placements", "distribute_tree",
           "activation_policy", "constrain_hidden", "constrain_logits",
           "constrain_expert_stack", "constrain_token_stack",
           "constrain_decode_scores"]
