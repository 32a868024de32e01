"""Multi-device placement over `torch.distributed` (counterpart of
`embeddingtables_tpu/parallel/`): one process per card, NCCL on cards and
gloo on the CPU. Meshes (`mesh`), mod-row-sharded tables with the exact
gather exchange (`sharded`), the capacity-bounded butterfly (`alltoall`)
and the sharded DLRM (`dlrm`). Column sharding, the other families and the
planner are not ported yet (ROADMAP.md queue 1, items I-2 and I-3)."""
from .alltoall import (CapacityAutoTuner, sharded_lookup_a2a,
                       sharded_update_a2a, suggest_capacity_factor)
from .dlrm import (ShardedDLRM, init_sharded_dlrm, local_batch,
                   make_sharded_eval_step, make_sharded_train_step,
                   shard_dlrm, unshard_dlrm)
from .mesh import default_mesh, init_process, local_mesh, multihost_mesh
from .sharded import (ShardedStackedTables, flat_index, shard_row_accum,
                      sharded_ensemble_lookup, sharded_ensemble_update,
                      sharded_lookup, sharded_sgd_update, unshard_row_state)
