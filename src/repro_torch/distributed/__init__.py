"""Distribution substrate, after ``repro/distributed``: logical-axis
annotations (``api``: ``lc``, ``use_rules``), the sharding rules of the
production mesh (``sharding``: ``ShardingPlan``), checkpointing with
atomic commit (``checkpoint``), heartbeats, straggler detection and
elastic re-mesh planning (``fault_tolerance``), and int8 gradient
compression with error feedback (``compression``)."""
from .api import lc, use_rules
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .compression import compress_grads, decompress_grads, init_residuals
from .fault_tolerance import (HeartbeatMonitor, HostState, StragglerDetector,
                              plan_elastic_mesh)
from .sharding import ShardingPlan

__all__ = ["lc", "use_rules", "ShardingPlan", "save_checkpoint", "latest_step", "restore_checkpoint",
           "compress_grads", "decompress_grads", "init_residuals",
           "HostState", "HeartbeatMonitor", "StragglerDetector",
           "plan_elastic_mesh"]
