"""Auxiliary subsystems (counterpart of `embeddingtables_tpu/utils/`):
checkpoints (`checkpoint`), delta checkpoints and the serving follower
(`deltackpt`), divergence rollback and auto-resume (`resilience`), phase
timings and profiler traces (`telemetry`), and row lifecycle (`rowstats`),
on one device and on a mesh (`ModRowLayout`, `evict_rows_sharded`)."""
from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from .deltackpt import (DeltaCheckpointManager, DeltaFollower, FlatRowLayout,
                        ModRowLayout, TouchedRowTracker, apply_delta,
                        load_base_data, snapshot_delta)
from .resilience import DivergenceGuard, resume_or_init
from .rowstats import (FrequencyTracker, evict_rows, evict_rows_sharded,
                       inverse_permutation, relayout, remap_batch,
                       reset_rows_state)
from .telemetry import (Telemetry, get_telemetry, phase, set_telemetry,
                        trace_profile)

__all__ = [
    "CheckpointManager", "save_checkpoint", "restore_checkpoint",
    "DeltaCheckpointManager", "TouchedRowTracker", "snapshot_delta",
    "apply_delta", "DeltaFollower", "FlatRowLayout", "ModRowLayout",
    "load_base_data",
    "DivergenceGuard", "resume_or_init",
    "Telemetry", "get_telemetry", "set_telemetry", "phase", "trace_profile",
    "FrequencyTracker", "evict_rows", "evict_rows_sharded",
    "inverse_permutation", "relayout",
    "remap_batch", "reset_rows_state",
]
