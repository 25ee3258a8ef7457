"""Distribution substrate of the port: QR domain groups and their
collectives, gradient compression, the step watchdog.

The training meshes (sharding rules, the elastic mesh) are ROADMAP A21.
"""

from repro_torch.distributed.compression import (
    compressed_psum, dequantize, ef_compress_tree, init_error_state, quantize,
)
from repro_torch.distributed.fault_tolerance import StepWatchdog
from repro_torch.distributed.sharding import (
    QR_DOMAIN_AXIS, largest_pow2, row_domain_mesh, world_size,
)

__all__ = ["StepWatchdog", "quantize", "dequantize", "ef_compress_tree",
           "compressed_psum", "init_error_state", "QR_DOMAIN_AXIS",
           "largest_pow2", "row_domain_mesh", "world_size"]
