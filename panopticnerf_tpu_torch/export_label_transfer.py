"""Export rendered label-transfer maps for the whole frame window (port of
`tools/export_label_transfer.py`).

Renders every frame's image_00 view from a trained checkpoint (kernel A1,
then the tiled render, on the card) and writes the maps in the
`data_2d_semantics` layout the KITTI-360 loader reads as ground truth:

    <out>/train/<seq>/image_00/semantic/<frame:010d>.png   raw ids (uint8)
    <out>/train/<seq>/image_00/instance/<frame:010d>.png   sem*1000+inst (uint16)

so a dataset whose data_2d_semantics points at the export reads the maps
back exactly. PNGs are written without PIL. Usage:

    python -m panopticnerf_tpu_torch.export_label_transfer --cfg_file configs/<x>.yaml \\
        --out DIR [--zip] [--device cpu] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import os
import shutil

import torch

from panopticnerf_tpu_torch.config import Config


def export(cfg: Config, out_dir: str, device: torch.device | str, log=print) -> list[str]:
    """Write the maps of every frame of the window -> the files written
    (semantic, instance per frame)."""
    from panopticnerf_tpu_torch.engine import _render_view, _restore_for_eval
    from panopticnerf_tpu_torch.eval import make_evaluator
    from panopticnerf_tpu_torch.viz import label_transfer_maps
    from panopticnerf_tpu_torch.viz.png import write_png

    ds, _, model, step = _restore_for_eval(cfg, device)
    ev = make_evaluator(cfg)
    hw = tuple(ds.images.shape[1:3])
    n_frames = cfg.data.frame_num
    cams_per_frame = ds.images.shape[0] // n_frames
    dirs = [os.path.join(out_dir, "train", cfg.data.sequence, "image_00", kind)
            for kind in ("semantic", "instance")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    written = []
    for i in range(n_frames):
        view = i * cams_per_frame                       # image_00 leads each frame
        frame = cfg.data.frame_start + i * cfg.data.frame_step
        sem, inst = ev.evaluate(_render_view(cfg, model, ds, view))
        for d, arr in zip(dirs, label_transfer_maps(sem, inst, hw, cfg.model.num_classes)):
            written.append(os.path.join(d, f"{frame:010d}.png"))
            write_png(written[-1], arr)
    log(f"exported {len(written)} label-transfer maps (ckpt step {step}) under {out_dir}")
    return written


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description="label-transfer map export")
    p.add_argument("--cfg_file", default=None)
    p.add_argument("--out", required=True, help="export root directory")
    p.add_argument("--zip", action="store_true", help="also write <out>.zip of the export tree")
    p.add_argument("--device", type=str, default="cuda")
    args, opts = p.parse_known_args(argv)
    for tok in opts:
        if tok.startswith("--"):
            p.error(f"unrecognized flag {tok!r}")
    args.opts = opts

    from panopticnerf_tpu_torch.config import make_cfg

    written = export(make_cfg(args), args.out, args.device)
    if args.zip:
        print(f"wrote {shutil.make_archive(args.out.rstrip('/'), 'zip', root_dir=args.out)}")
    return written


if __name__ == "__main__":
    main()
