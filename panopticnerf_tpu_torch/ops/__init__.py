from panopticnerf_tpu_torch.ops.composite import CompositeOut, composite, compute_weights
from panopticnerf_tpu_torch.ops.encoding import posenc_dim, positional_encoding
from panopticnerf_tpu_torch.ops.intersect import (
    BIG,
    Primitives,
    RayIntervals,
    fixed_map_from_weights,
    intersect_rays,
    intersect_rays_plain,
    labeled_containment,
    ray_box_intervals,
    samples_in_intervals,
    top_k_intervals,
)
from panopticnerf_tpu_torch.ops.rays import (
    full_image_uv,
    gen_rays_perspective,
    pixel_dirs_perspective,
    rays_from_dirs,
)
from panopticnerf_tpu_torch.ops.sampling import (
    guided_z,
    merge_sorted,
    merge_z,
    sample_pdf,
    stratified_z,
)

__all__ = [
    "BIG", "CompositeOut", "Primitives", "RayIntervals", "composite",
    "compute_weights", "fixed_map_from_weights", "full_image_uv",
    "gen_rays_perspective", "guided_z", "intersect_rays",
    "intersect_rays_plain", "labeled_containment", "merge_sorted", "merge_z",
    "pixel_dirs_perspective", "posenc_dim", "positional_encoding",
    "ray_box_intervals", "rays_from_dirs", "sample_pdf",
    "samples_in_intervals", "stratified_z", "top_k_intervals",
]
