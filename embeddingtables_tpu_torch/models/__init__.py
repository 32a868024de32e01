"""Model families built on the embedding engine."""
from .dlrm import (DLRM, DLRMConfig, bce_loss, dlrm_forward, dlrm_small_config,
                   init_dlrm, make_eval_step, make_train_step)
from .train import TrainResult, evaluate_auc, train_dlrm

__all__ = ["DLRM", "DLRMConfig", "dlrm_small_config", "init_dlrm",
           "dlrm_forward", "make_eval_step", "make_train_step", "bce_loss",
           "train_dlrm", "TrainResult", "evaluate_auc"]
