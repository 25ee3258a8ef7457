"""Distribution substrate of the port: so far the step watchdog.

Sharding rules, gradient compression, the elastic mesh and checkpointing
wait for ROADMAP A14.
"""

from repro_torch.distributed.fault_tolerance import StepWatchdog

__all__ = ["StepWatchdog"]
