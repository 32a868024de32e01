"""embeddingtables_tpu_torch — the embedding-table engine in PyTorch and CUDA.

The port of `embeddingtables_tpu` (JAX, the reference) to an NVIDIA H100. Its
module names mirror the JAX package's. Every op dispatches on its tensor's
device: CUDA tensors go to the hand-written kernels in `csrc/`, CPU tensors
to their plain PyTorch versions. Entry points that create state (the `init_*`
functions, the `*_from_arrays` builders and the `train_*` loops) run on CUDA
unless the caller passes `device="cpu"`.

Training: `lookup_vjp` (one table) and `maplookup_vjp` (an ensemble) give
lazy `SparseEmbeddingUpdate`s, which `SparseSGD`, `SparseRowWiseAdaGrad`,
`SparseLazyAdam` and `SparseFTRL` (`optim`) apply in place, on a
`SimpleEmbedding` or shard by shard on a `SplitEmbedding`
(`ensemble_update`); `sgd_update` and `ensemble_sgd_update` take an
`Indexer`'s result.

Models (`models`): the DLRM, DCN-v2 and DeepFM CTR rankers and the
two-tower retriever, each an `nn.Module` with its train step, its loop
(`train_dlrm`, `train_dcn`, `train_deepfm`, `train_two_tower`) and its
service (`serving`, quantized to int8 or int4 rows by `quant`), reachable
over the binary RPC transport (`rpc`). The CTR train steps take a
`torch.optim` factory for the towers (`dense_tx`) and accumulate gradients
over slices of the batch (`microbatch`).

Input (`io`, `data`): the native Criteo parser and synthesizer, host
prefetch, and `DevicePrefetcher`, which copies the next batches to the card
on a side stream beside the step.

Persistence (`utils`): checkpoints (`CheckpointManager`), delta checkpoints
of the touched rows (`DeltaCheckpointManager`, resumed by `restore_delta`),
the loops' divergence guard (`DivergenceGuard`), telemetry phases and
profiler traces, and refreshable services
(`serving.make_refreshable_service`) that follow a trainer's deltas through
`DeltaFollower`.

Multi-device (`parallel`): one process per card over `torch.distributed`
(NCCL; gloo on the CPU), the stacked tables mod-row-sharded over a
`DeviceMesh`, the exact gather exchange and the capacity-bounded
butterfly, every family's sharded step (DLRM, DCN, DeepFM in both layouts,
the two-tower retriever with its block-row sharded index), every loop and
service with `mesh=`, and the loops' checkpoints, guard, delta
checkpoints (`utils.ModRowLayout`) and eviction
(`utils.evict_rows_sharded`) on the mesh.

Ecosystem: `nn.Embed` / `nn.SparseEmbed` modules for stock torch models,
`compat`'s optax-shaped sparse transform, and the torch bridge
(`from_torch`, `to_torch_embedding`, `stacked_from_torch`,
`stacked_to_torch`).

Table variants: `QuantizedEmbedding` and `Int4QuantizedEmbedding` (serving);
the compositional `QREmbedding`, `MDEmbedding` and `TTEmbedding` with their
`*_lookup_vjp`; `HostOffloadEmbedding` and `TieredEmbedding` (rows in pinned
host memory); `utils.rowstats` for frequency tracking, eviction and
relayout.

Layout convention: tables are row-major `(vocab, dim)`;
`lookup(A, I)[i, :] == A[I[i], :]`.
"""
from . import config
from .ops import (AbstractExecutionStrategy, DefaultStrategy, DenseIndexer,
                  Indexer, IndexerResult, IndexerView, PreallocationStrategy,
                  SimpleParallelStrategy, Slicer, SparseEmbeddingUpdate,
                  SparseIndexer, StackedTables, accumulate_updates,
                  effective_weights, ensemble_sgd_update, ensemble_update,
                  flatten_indices, index, indexer_view, lookup, lookup_oracle,
                  lookup_vjp, maplookup, maplookup_vjp, normalize_indices,
                  normalize_weights, sgd_update, uncompress)
from .types import (Dynamic, Forward, IndexingContext, NoContext, Static,
                    TableSpec, Update, cdiv, featuresize)
from .tables import (SimpleEmbedding, SplitEmbedding, as_table, destination,
                     example, is_table)
from .offload import HostOffloadEmbedding
from .quant import Int4QuantizedEmbedding, QuantizedEmbedding
from .qr import QREmbedding, qr_lookup_vjp
from .md import MDEmbedding, md_lookup_vjp
from .tt import TTEmbedding, tt_lookup_vjp
from .tiered import TieredEmbedding
from .models import (DCN, DLRM, DCNConfig, DeepFM, DeepFMConfig, DLRMConfig,
                     RetrievalTrainResult, TrainResult, TwoTower,
                     TwoTowerConfig, build_item_index, dcn_forward,
                     dcn_small_config, deepfm_forward, deepfm_small_config,
                     dlrm_forward, dlrm_small_config, evaluate_metrics,
                     fuse_deepfm, in_batch_softmax_loss, init_dcn,
                     init_deepfm, init_dlrm, init_two_tower, make_eval_step,
                     make_retriever, make_train_step, restore_delta,
                     retrieve, train_dcn, train_deepfm, train_dlrm,
                     train_two_tower, two_tower_scores, unfuse_deepfm)
from .optim import (SparseAdamState, SparseFTRL, SparseFTRLState,
                    SparseLazyAdam, SparseOptState, SparseRowWiseAdaGrad,
                    SparseSGD, warmup_constant_lr, warmup_cosine_lr)
from .rounding import stochastic_cast, stochastic_round_to_bf16
from .data import SyntheticCriteo, SyntheticRetrieval
from .interop import (dcn_from_arrays, deepfm_from_arrays, dlrm_from_arrays,
                      from_torch, md_from_arrays, qr_from_arrays,
                      quantized_from_arrays, stacked_from_torch,
                      stacked_to_torch, tiered_from_arrays, to_torch_embedding,
                      tt_from_arrays, two_tower_from_arrays)
from . import utils
from .serving import (MicroBatcher, make_dcn_service, make_deepfm_service,
                      make_dlrm_service, make_refreshable_dlrm_service,
                      make_refreshable_service, make_retrieval_service,
                      serve_http)
from .rpc import ModelRouter, RPCClient, RPCServer, serve_rpc
from . import compat, io, nn, parallel

__all__ = [
    "Static", "Dynamic", "TableSpec", "IndexingContext", "NoContext",
    "Forward", "Update", "featuresize", "cdiv",
    "SimpleEmbedding", "SplitEmbedding", "HostOffloadEmbedding",
    "QuantizedEmbedding", "Int4QuantizedEmbedding", "QREmbedding",
    "qr_lookup_vjp", "MDEmbedding", "md_lookup_vjp", "TTEmbedding",
    "tt_lookup_vjp", "TieredEmbedding", "as_table", "example",
    "destination", "is_table",
    "lookup", "lookup_oracle", "lookup_vjp", "effective_weights",
    "maplookup", "maplookup_vjp", "AbstractExecutionStrategy",
    "DefaultStrategy", "SimpleParallelStrategy", "PreallocationStrategy",
    "StackedTables", "Slicer", "normalize_indices", "normalize_weights",
    "Indexer", "SparseIndexer", "DenseIndexer", "IndexerResult", "IndexerView",
    "index", "indexer_view", "flatten_indices",
    "SparseEmbeddingUpdate", "accumulate_updates", "uncompress",
    "sgd_update", "ensemble_sgd_update", "ensemble_update",
    "SparseOptState", "SparseAdamState", "SparseFTRLState", "SparseSGD",
    "SparseRowWiseAdaGrad", "SparseLazyAdam", "SparseFTRL",
    "warmup_cosine_lr", "warmup_constant_lr",
    "stochastic_cast", "stochastic_round_to_bf16",
    "DLRM", "DLRMConfig", "dlrm_small_config", "init_dlrm", "dlrm_forward",
    "make_eval_step", "make_train_step", "train_dlrm", "TrainResult",
    "DCN", "DCNConfig", "dcn_small_config", "init_dcn", "dcn_forward",
    "train_dcn", "DeepFM", "DeepFMConfig", "deepfm_small_config",
    "init_deepfm", "deepfm_forward", "fuse_deepfm", "unfuse_deepfm",
    "train_deepfm", "TwoTower", "TwoTowerConfig", "init_two_tower",
    "two_tower_scores", "in_batch_softmax_loss", "build_item_index",
    "make_retriever", "retrieve", "train_two_tower", "RetrievalTrainResult",
    "evaluate_metrics", "restore_delta",
    "SyntheticCriteo", "SyntheticRetrieval", "dlrm_from_arrays",
    "dcn_from_arrays", "deepfm_from_arrays", "two_tower_from_arrays",
    "quantized_from_arrays", "qr_from_arrays", "md_from_arrays",
    "tt_from_arrays", "tiered_from_arrays", "from_torch",
    "to_torch_embedding", "stacked_from_torch", "stacked_to_torch",
    "MicroBatcher", "make_dlrm_service", "make_dcn_service",
    "make_deepfm_service", "make_retrieval_service", "serve_http",
    "make_refreshable_service", "make_refreshable_dlrm_service",
    "ModelRouter", "RPCServer", "RPCClient", "serve_rpc",
    "config", "utils", "io", "compat", "nn", "parallel",
]
