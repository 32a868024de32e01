"""embeddingtables_tpu_torch — the embedding-table engine in PyTorch and CUDA.

The port of `embeddingtables_tpu` (JAX, the reference) to an NVIDIA H100. Its
module names mirror the JAX package's. Every op dispatches on its tensor's
device: CUDA tensors go to the hand-written kernels in `csrc/`, CPU tensors
to their plain PyTorch versions. Entry points that create state (`init_dlrm`,
`dlrm_from_arrays`) run on CUDA unless the caller passes `device="cpu"`.

Layout convention: tables are row-major `(vocab, dim)`;
`lookup(A, I)[i, :] == A[I[i], :]`.
"""
from . import config
from .ops import StackedTables, lookup, lookup_oracle
from .types import (Dynamic, Forward, IndexingContext, NoContext, Static,
                    TableSpec, Update, cdiv, featuresize)
from .tables import SimpleEmbedding, as_table, is_table
from .models import (DLRM, DLRMConfig, dlrm_forward, dlrm_small_config,
                     init_dlrm, make_eval_step)
from .interop import dlrm_from_arrays
from .serving import MicroBatcher, make_dlrm_service, serve_http

__all__ = [
    "Static", "Dynamic", "TableSpec", "IndexingContext", "NoContext",
    "Forward", "Update", "featuresize", "cdiv",
    "SimpleEmbedding", "as_table", "is_table",
    "lookup", "lookup_oracle", "StackedTables",
    "DLRM", "DLRMConfig", "dlrm_small_config", "init_dlrm", "dlrm_forward",
    "make_eval_step", "dlrm_from_arrays",
    "MicroBatcher", "make_dlrm_service", "serve_http",
    "config",
]
