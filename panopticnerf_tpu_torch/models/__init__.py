import math

import torch

from panopticnerf_tpu_torch.models.nerf import HashGrid, NeRFMLP, PanopticNeRF, coarse_field_cfg

# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal") draws
# from a normal truncated at +-2 and divides by that distribution's stddev.
_TRUNC_STD = 0.87962566103423978


def make_network(cfg, device: torch.device | str) -> PanopticNeRF:
    """The flagship field network for `cfg`, on `device` (weights are
    loaded by the caller, see convert.params_from_flax, or drawn by
    init_params)."""
    return PanopticNeRF(cfg.model, has_fine=cfg.render.n_importance > 0).to(device)


@torch.no_grad()
def init_params(model: PanopticNeRF, generator: torch.Generator) -> PanopticNeRF:
    """Draw every weight as flax `Dense` does by default (lecun normal:
    truncated normal, variance 1 / fan_in) and zero every bias, in place;
    a hash grid's tables uniform in +-1e-4, as Instant-NGP draws them.
    `generator` lives on the model's device."""
    for module in model.modules():
        if isinstance(module, torch.nn.Linear):
            std = math.sqrt(1.0 / module.in_features) / _TRUNC_STD
            torch.nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
            module.bias.zero_()
        elif isinstance(module, HashGrid):
            for table in module.tables():
                table.uniform_(-1e-4, 1e-4, generator=generator)
    return model


__all__ = ["HashGrid", "NeRFMLP", "PanopticNeRF", "coarse_field_cfg", "init_params", "make_network"]
