from panopticnerf_tpu_torch.ops.composite import CompositeOut, composite, compute_weights
from panopticnerf_tpu_torch.ops.encoding import posenc_dim, positional_encoding
from panopticnerf_tpu_torch.ops.intersect import (
    BIG,
    Primitives,
    RayIntervals,
    fixed_map_from_weights,
    fixed_semantic_distribution,
    intersect_groups,
    intersect_groups_plain,
    intersect_rays,
    intersect_rays_per_ray,
    intersect_rays_plain,
    labeled_containment,
    make_box_primitives,
    ray_box_intervals,
    samples_in_intervals,
    top_k_intervals,
)
from panopticnerf_tpu_torch.ops.rays import (
    FisheyeParams,
    full_image_uv,
    gen_rays_fisheye,
    gen_rays_perspective,
    pixel_dirs_fisheye,
    pixel_dirs_perspective,
    rays_from_dirs,
)
from panopticnerf_tpu_torch.ops.field_train import field_hybrid_apply, field_train_apply
from panopticnerf_tpu_torch.ops.mlp_train import fused_trunk_train
from panopticnerf_tpu_torch.ops.sampling import (
    guided_split,
    guided_z,
    merge_sorted,
    merge_z,
    sample_pdf,
    stratified_z,
    topm_eval_select,
)

__all__ = [
    "BIG", "CompositeOut", "FisheyeParams", "Primitives", "RayIntervals", "composite",
    "compute_weights", "field_hybrid_apply", "field_train_apply", "fixed_map_from_weights",
    "fixed_semantic_distribution", "full_image_uv", "fused_trunk_train", "gen_rays_fisheye",
    "gen_rays_perspective", "guided_split", "guided_z",
    "intersect_groups", "intersect_groups_plain", "intersect_rays",
    "intersect_rays_per_ray", "intersect_rays_plain", "labeled_containment",
    "make_box_primitives", "merge_sorted", "merge_z",
    "pixel_dirs_fisheye", "pixel_dirs_perspective", "posenc_dim", "positional_encoding",
    "ray_box_intervals", "rays_from_dirs", "sample_pdf",
    "samples_in_intervals", "stratified_z", "top_k_intervals", "topm_eval_select",
]
