"""Model families built on the embedding engine."""
from .dcn import (DCN, DCNConfig, dcn_forward, dcn_small_config, init_dcn)
from .dcn import make_eval_step as make_dcn_eval_step
from .dcn import make_train_step as make_dcn_train_step
from .deepfm import (DeepFM, DeepFMConfig, deepfm_forward,
                     deepfm_small_config, fuse_deepfm, init_deepfm,
                     unfuse_deepfm)
from .deepfm import make_eval_step as make_deepfm_eval_step
from .deepfm import make_train_step as make_deepfm_train_step
from .dlrm import (DLRM, DLRMConfig, bce_loss, dlrm_forward, dlrm_small_config,
                   init_dlrm, make_eval_step, make_train_step)
from .train import (RetrievalTrainResult, TrainResult, evaluate_auc,
                    evaluate_metrics, restore_deepfm_delta, restore_delta,
                    restore_dlrm_delta, restore_two_tower_delta, train_dcn,
                    train_deepfm, train_dlrm, train_two_tower)
from .two_tower import (TwoTower, TwoTowerConfig, build_item_index,
                        in_batch_softmax_loss, init_two_tower, make_retriever,
                        retrieve, two_tower_scores)

__all__ = ["DLRM", "DLRMConfig", "dlrm_small_config", "init_dlrm",
           "dlrm_forward", "make_eval_step", "make_train_step", "bce_loss",
           "DCN", "DCNConfig", "dcn_small_config", "init_dcn", "dcn_forward",
           "make_dcn_train_step", "make_dcn_eval_step",
           "DeepFM", "DeepFMConfig", "deepfm_small_config", "init_deepfm",
           "deepfm_forward", "fuse_deepfm", "unfuse_deepfm",
           "make_deepfm_train_step", "make_deepfm_eval_step",
           "TwoTower", "TwoTowerConfig", "init_two_tower", "two_tower_scores",
           "in_batch_softmax_loss", "build_item_index", "make_retriever",
           "retrieve",
           "train_dlrm", "train_dcn", "train_deepfm", "train_two_tower",
           "TrainResult", "RetrievalTrainResult", "evaluate_auc",
           "evaluate_metrics", "restore_delta", "restore_dlrm_delta",
           "restore_deepfm_delta", "restore_two_tower_delta"]
