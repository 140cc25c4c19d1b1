from panopticnerf_tpu_torch.utils.profiling import enable_debug_nans, timed, trace

__all__ = ["enable_debug_nans", "timed", "trace"]
