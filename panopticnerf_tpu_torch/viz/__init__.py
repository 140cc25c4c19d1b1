from panopticnerf_tpu_torch.viz.visualizer import (
    Visualizer,
    depth_to_color,
    label_transfer_maps,
    semantic_raw_ids,
)


def make_visualizer(cfg) -> Visualizer:
    """The reference's factory: the Visualizer of `cfg`."""
    return Visualizer(cfg)


__all__ = ["Visualizer", "depth_to_color", "label_transfer_maps", "make_visualizer",
           "semantic_raw_ids"]
