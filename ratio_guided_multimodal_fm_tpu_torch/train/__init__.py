"""Flow-matching training (port of train/): the Adam+EMA step, reference-
layout .pth checkpoints, the preemption-safe epoch driver."""
from ratio_guided_multimodal_fm_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    get_checkpoint_path,
    load_checkpoint,
    save_checkpoint,
    wait_for_saves,
)
from ratio_guided_multimodal_fm_tpu_torch.train.loop import (
    EarlyStopper,
    restore_preempt,
    train_epochs,
    train_flow_matching_epochs,
)
from ratio_guided_multimodal_fm_tpu_torch.train.steps import (
    FMTrainState,
    RatioTrainState,
    make_classifier_train_step,
    make_fm_train_step,
    make_ratio_train_step,
)

__all__ = ["EarlyStopper", "FMTrainState", "RatioTrainState",
           "checkpoint_exists", "get_checkpoint_path", "load_checkpoint",
           "make_classifier_train_step", "make_fm_train_step",
           "make_ratio_train_step", "restore_preempt", "save_checkpoint",
           "train_epochs", "train_flow_matching_epochs", "wait_for_saves"]
