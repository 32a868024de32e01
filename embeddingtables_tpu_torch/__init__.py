"""embeddingtables_tpu_torch — the embedding-table engine in PyTorch and CUDA.

The port of `embeddingtables_tpu` (JAX, the reference) to an NVIDIA H100. Its
module names mirror the JAX package's. Every op dispatches on its tensor's
device: CUDA tensors go to the hand-written kernels in `csrc/`, CPU tensors
to their plain PyTorch versions. Entry points that create state (`init_dlrm`,
`dlrm_from_arrays`) run on CUDA unless the caller passes `device="cpu"`.

Training: `lookup_vjp` gives a lazy `SparseEmbeddingUpdate`, which
`SparseSGD` / `SparseRowWiseAdaGrad` (`optim`) apply in place; the DLRM
train step is `make_train_step` and its loop `train_dlrm`.

Layout convention: tables are row-major `(vocab, dim)`;
`lookup(A, I)[i, :] == A[I[i], :]`.
"""
from . import config
from .ops import (SparseEmbeddingUpdate, StackedTables, accumulate_updates,
                  effective_weights, ensemble_update, lookup, lookup_oracle,
                  lookup_vjp, sgd_update, uncompress)
from .types import (Dynamic, Forward, IndexingContext, NoContext, Static,
                    TableSpec, Update, cdiv, featuresize)
from .tables import SimpleEmbedding, as_table, is_table
from .models import (DLRM, DLRMConfig, TrainResult, dlrm_forward,
                     dlrm_small_config, init_dlrm, make_eval_step,
                     make_train_step, train_dlrm)
from .optim import (SparseOptState, SparseRowWiseAdaGrad, SparseSGD,
                    warmup_constant_lr, warmup_cosine_lr)
from .rounding import stochastic_cast, stochastic_round_to_bf16
from .data import SyntheticCriteo
from .interop import dlrm_from_arrays
from .serving import MicroBatcher, make_dlrm_service, serve_http

__all__ = [
    "Static", "Dynamic", "TableSpec", "IndexingContext", "NoContext",
    "Forward", "Update", "featuresize", "cdiv",
    "SimpleEmbedding", "as_table", "is_table",
    "lookup", "lookup_oracle", "lookup_vjp", "effective_weights",
    "StackedTables",
    "SparseEmbeddingUpdate", "accumulate_updates", "uncompress",
    "sgd_update", "ensemble_update",
    "SparseOptState", "SparseSGD", "SparseRowWiseAdaGrad",
    "warmup_cosine_lr", "warmup_constant_lr",
    "stochastic_cast", "stochastic_round_to_bf16",
    "DLRM", "DLRMConfig", "dlrm_small_config", "init_dlrm", "dlrm_forward",
    "make_eval_step", "make_train_step", "train_dlrm", "TrainResult",
    "SyntheticCriteo", "dlrm_from_arrays",
    "MicroBatcher", "make_dlrm_service", "serve_http",
    "config",
]
