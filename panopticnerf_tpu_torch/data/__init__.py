import numpy as np
import torch

from panopticnerf_tpu_torch.data.dataset import (
    DeviceDataset,
    train_test_split,
    view_primitives,
    view_rays,
)


def make_dataset(cfg, device: torch.device | str):
    """-> (DeviceDataset on `device`, train_ids, test_ids). The port builds
    the synthetic scene only so far."""
    if cfg.data.dataset != "synthetic":
        raise NotImplementedError(f"dataset {cfg.data.dataset!r} is not ported yet")
    from panopticnerf_tpu_torch.data.synthetic import build_synthetic_dataset

    ds = build_synthetic_dataset(cfg, device, seed=cfg.train.seed)
    train_ids, test_ids = train_test_split(ds.images.shape[0], cfg.data.test_every)
    if len(test_ids) == 0:
        test_ids = train_ids[:1]
    return ds, np.asarray(train_ids), np.asarray(test_ids)


__all__ = [
    "DeviceDataset",
    "make_dataset",
    "train_test_split",
    "view_primitives",
    "view_rays",
]
