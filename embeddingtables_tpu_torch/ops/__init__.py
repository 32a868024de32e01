from .lookup import effective_weights, lookup, lookup_oracle, lookup_vjp
from .ensemble import (AbstractExecutionStrategy, DefaultStrategy,
                       PreallocationStrategy, SimpleParallelStrategy, Slicer,
                       StackedTables, maplookup, maplookup_vjp,
                       normalize_indices, normalize_weights)
from .indexer import (DenseIndexer, Indexer, IndexerResult, IndexerView,
                      SparseIndexer, flatten_indices, index, indexer_view)
from .sparse_update import (SparseEmbeddingUpdate, accumulate_updates,
                            ensemble_sgd_update, ensemble_update,
                            sgd_update, uncompress)

__all__ = ["lookup", "lookup_oracle", "lookup_vjp", "effective_weights",
           "StackedTables", "maplookup", "maplookup_vjp",
           "AbstractExecutionStrategy", "DefaultStrategy",
           "SimpleParallelStrategy", "PreallocationStrategy", "Slicer",
           "normalize_indices", "normalize_weights",
           "Indexer", "SparseIndexer", "DenseIndexer", "IndexerResult",
           "IndexerView", "index", "indexer_view", "flatten_indices",
           "SparseEmbeddingUpdate", "accumulate_updates",
           "ensemble_sgd_update", "ensemble_update", "sgd_update",
           "uncompress"]
