"""Model families built on the embedding engine."""
from .dlrm import (DLRM, DLRMConfig, bce_loss, dlrm_forward, dlrm_small_config,
                   init_dlrm, make_eval_step)

__all__ = ["DLRM", "DLRMConfig", "dlrm_small_config", "init_dlrm",
           "dlrm_forward", "make_eval_step", "bce_loss"]
