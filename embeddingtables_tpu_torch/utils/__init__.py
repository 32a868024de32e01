"""Auxiliary subsystems (counterpart of `embeddingtables_tpu/utils/`): row
lifecycle (`rowstats`). Checkpoints, delta checkpoints, resilience and
telemetry wait for ROADMAP.md queue 1, item E."""
from .rowstats import (FrequencyTracker, evict_rows, inverse_permutation,
                       relayout, remap_batch, reset_rows_state)

__all__ = ["FrequencyTracker", "evict_rows", "inverse_permutation",
           "relayout", "remap_batch", "reset_rows_state"]
