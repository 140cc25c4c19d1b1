import torch

from panopticnerf_tpu_torch.models.nerf import NeRFMLP, PanopticNeRF, coarse_field_cfg


def make_network(cfg, device: torch.device | str) -> PanopticNeRF:
    """The flagship field network for `cfg`, on `device` (weights are
    loaded by the caller; see convert.params_from_flax)."""
    return PanopticNeRF(cfg.model, has_fine=cfg.render.n_importance > 0).to(device)


__all__ = ["NeRFMLP", "PanopticNeRF", "coarse_field_cfg", "make_network"]
