from .lookup import effective_weights, lookup, lookup_oracle, lookup_vjp
from .ensemble import StackedTables
from .sparse_update import (SparseEmbeddingUpdate, accumulate_updates,
                            ensemble_update, sgd_update, uncompress)

__all__ = ["lookup", "lookup_oracle", "lookup_vjp", "effective_weights",
           "StackedTables", "SparseEmbeddingUpdate", "accumulate_updates",
           "ensemble_update", "sgd_update", "uncompress"]
