from panopticnerf_tpu_torch.viz.visualizer import (
    Visualizer,
    depth_to_color,
    label_transfer_maps,
    semantic_raw_ids,
)

__all__ = ["Visualizer", "depth_to_color", "label_transfer_maps", "semantic_raw_ids"]
