from panopticnerf_tpu_torch.config.config import (
    Config,
    DataConfig,
    EvalConfig,
    LossConfig,
    ModelConfig,
    ParallelConfig,
    RenderConfig,
    TrainConfig,
    load_config,
    make_cfg,
)

__all__ = [
    "Config",
    "DataConfig",
    "EvalConfig",
    "LossConfig",
    "ModelConfig",
    "ParallelConfig",
    "RenderConfig",
    "TrainConfig",
    "load_config",
    "make_cfg",
]
