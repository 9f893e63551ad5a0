"""The training path's distribution substrate, after ``repro/distributed``:
checkpointing with atomic commit (``checkpoint``), heartbeats, straggler
detection and elastic re-mesh planning (``fault_tolerance``), and int8
gradient compression with error feedback (``compression``).  The
reference's sharding rules and logical-axis annotations (``api``,
``sharding``) serve its XLA mesh and are not ported yet (``ROADMAP.md``
queue A item 12)."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .compression import compress_grads, decompress_grads, init_residuals
from .fault_tolerance import (HeartbeatMonitor, HostState, StragglerDetector,
                              plan_elastic_mesh)

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "compress_grads", "decompress_grads", "init_residuals",
           "HostState", "HeartbeatMonitor", "StragglerDetector",
           "plan_elastic_mesh"]
