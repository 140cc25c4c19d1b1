from panopticnerf_tpu_torch.utils.profiling import (
    calls,
    count,
    enable_debug_nans,
    reset,
    snapshot,
    span,
    timed,
    trace,
)

__all__ = ["calls", "count", "enable_debug_nans", "reset", "snapshot", "span", "timed", "trace"]
