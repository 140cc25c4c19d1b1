import dataclasses

import numpy as np
import torch

from panopticnerf_tpu_torch.data.dataset import (
    DeviceDataset,
    concat_datasets,
    train_test_split,
    view_primitives,
    view_rays,
)
from panopticnerf_tpu_torch.utils.profiling import span


@span("data.make_dataset", sync=True)
def make_dataset(cfg, device: torch.device | str):
    """-> (DeviceDataset, train_ids, test_ids): the synthetic scene, or
    KITTI-360 with every sequence of `data.sequences` (else `data.sequence`)
    in one view pool, built on the host and moved to `device` once. With
    streaming (`data.stream_window` > 0) the pool stays on the host: only a
    rotating window of it (`data/stream.py`) and the views an evaluation
    touches go to the device, while the steps and renders still run there.
    Its spans: `data.make_dataset` (host seconds, the card synchronised at
    the end) around `data.decode`, `data.resize`, `data.boxes` and
    `data.upload` (utils/profiling.py)."""
    if cfg.data.stream_window > 0:
        device = "cpu"
    if cfg.data.dataset == "synthetic":
        from panopticnerf_tpu_torch.data.synthetic import build_synthetic_dataset

        ds = build_synthetic_dataset(cfg, device, seed=cfg.train.seed)
    elif cfg.data.dataset == "kitti360":
        from panopticnerf_tpu_torch.data.kitti360 import build_kitti360_dataset

        seqs = list(cfg.data.sequences) or [cfg.data.sequence]
        parts = [build_kitti360_dataset(
            dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, sequence=sq)), "cpu")
            for sq in seqs]
        with span("data.upload", sync=True):
            ds = DeviceDataset(*[None if t is None else t.to(device)
                                 for t in concat_datasets(parts)])
    else:
        raise ValueError(f"unknown dataset {cfg.data.dataset!r}")
    train_ids, test_ids = train_test_split(ds.images.shape[0], cfg.data.test_every)
    if len(test_ids) == 0:
        test_ids = train_ids[:1]
    return ds, np.asarray(train_ids), np.asarray(test_ids)


__all__ = [
    "DeviceDataset",
    "concat_datasets",
    "make_dataset",
    "train_test_split",
    "view_primitives",
    "view_rays",
]
