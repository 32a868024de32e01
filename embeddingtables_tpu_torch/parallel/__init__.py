"""Multi-device placement over `torch.distributed` (counterpart of
`embeddingtables_tpu/parallel/`): one process per card, NCCL on cards and
gloo on the CPU. Meshes (`mesh`), mod-row-sharded tables with the exact
gather exchange (`sharded`), the capacity-bounded butterfly (`alltoall`),
and every family on the mesh: the sharded DLRM (`dlrm`), DCN (`dcn`),
DeepFM (`deepfm`) and two-tower retriever (`two_tower`), column sharding
(`colshard`) and the sharding planner (`planner`: replicated, row- and
column-sharded tables in one plan, for every family, and tables of mixed
dims)."""
from .alltoall import (CapacityAutoTuner, sharded_adagrad_update_a2a,
                       sharded_adam_update_a2a, sharded_ftrl_update_a2a,
                       sharded_lookup_a2a, sharded_sgd_update_a2a,
                       sharded_update_a2a, suggest_capacity_factor)
from .colshard import (ColShardedStackedTables, col_sharded_lookup,
                       col_sharded_update, init_col_row_state)
from .dcn import (ShardedDCN, make_sharded_dcn_eval_step,
                  make_sharded_dcn_train_step, shard_dcn, unshard_dcn)
from .deepfm import (ShardedDeepFM, make_sharded_deepfm_eval_step,
                     make_sharded_deepfm_train_step, shard_deepfm,
                     unshard_deepfm)
from .dlrm import (ShardedDLRM, batch_shardings, init_sharded_dlrm,
                   local_batch, make_sharded_eval_step,
                   make_sharded_train_step, shard_dlrm, unshard_dlrm)
from .mesh import default_mesh, init_process, local_mesh, multihost_mesh
from .planner import (COL_SHARD, REPLICATE, ROW_SHARD, MixedDimPlannedTables,
                      PlacementDecision, PlannedDCN, PlannedDeepFM,
                      PlannedDLRM, PlannedTables, PlannedTwoTower,
                      ShardingPlan, evict_rows_planned, hotness_from_trackers,
                      init_planned_dcn, init_planned_deepfm,
                      init_planned_dlrm, init_planned_two_tower,
                      make_planned_dcn_eval_step,
                      make_planned_dcn_train_step,
                      make_planned_deepfm_eval_step,
                      make_planned_deepfm_train_step, make_planned_eval_step,
                      make_planned_train_step, make_planned_tt_train_step,
                      mixed_planned_apply, mixed_planned_lookup,
                      place_stacked_on_plan, place_two_tower_on_plan,
                      plan_model, plan_sharding, plan_sharding_mixed,
                      planned_apply, planned_build_item_index,
                      planned_lookup, planned_retrieve, planned_row_state,
                      skew_from_trackers)
from .sharded import (ShardedStackedTables, flat_index, shard_row_accum,
                      shard_table, sharded_ensemble_lookup,
                      sharded_ensemble_update, sharded_lookup,
                      sharded_sgd_update, unshard_row_state)
from .two_tower import (ShardedTwoTower, build_sharded_item_index,
                        make_sharded_retriever, make_sharded_tt_train_step,
                        shard_two_tower, sharded_retrieve,
                        tt_batch_shardings, unshard_two_tower)
