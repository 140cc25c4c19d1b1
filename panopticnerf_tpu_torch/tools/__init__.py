"""Command-line tools of the port, each run as
`python -m panopticnerf_tpu_torch.tools.<name>`: `landing_sweep` and
`pq_analysis` (the fusion sweep on a checkpoint), `compute_visible_ids`
and `xview_diag` (host tools on a KITTI-360 tree)."""
