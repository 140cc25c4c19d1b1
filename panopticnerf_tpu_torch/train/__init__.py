from panopticnerf_tpu_torch.train.loss import compute_losses
from panopticnerf_tpu_torch.train.step import (
    StepDraws,
    TrainState,
    apply_gradients,
    ema_update,
    eval_state_dict,
    lr_at,
    make_train_state,
    make_train_step,
    resolve_train_model,
    weight_th_schedule,
)

__all__ = [
    "StepDraws", "TrainState", "apply_gradients", "compute_losses", "ema_update", "eval_state_dict",
    "lr_at", "make_train_state", "make_train_step", "resolve_train_model",
    "weight_th_schedule",
]
