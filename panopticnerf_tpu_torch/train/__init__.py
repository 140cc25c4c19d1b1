from panopticnerf_tpu_torch.train.loss import compute_losses
from panopticnerf_tpu_torch.train.step import (
    RankShare,
    StepDraws,
    TrainState,
    apply_gradients,
    draw_step,
    ema_update,
    eval_state_dict,
    lr_at,
    make_train_state,
    make_train_step,
    resolve_train_model,
    weight_th_schedule,
)

__all__ = [
    "RankShare", "StepDraws", "TrainState", "apply_gradients", "compute_losses", "draw_step",
    "ema_update", "eval_state_dict",
    "lr_at", "make_train_state", "make_train_step", "resolve_train_model",
    "weight_th_schedule",
]
