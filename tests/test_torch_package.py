"""Package-level checks of the PyTorch port: it imports no JAX (nor flax,
optax, orbax, nor any module of the JAX package), and its config schema is
the JAX package's, field for field."""

import dataclasses
import glob
import os
import subprocess
import sys
import typing

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys\n"
        "import panopticnerf_tpu_torch, panopticnerf_tpu_torch.run\n"
        "import panopticnerf_tpu_torch.engine, panopticnerf_tpu_torch.ops.intersect_cuda\n"
        "import panopticnerf_tpu_torch.train_net, panopticnerf_tpu_torch.train\n"
        "import panopticnerf_tpu_torch.ops.mlp_train, panopticnerf_tpu_torch.ops.mlp_train_cuda\n"
        "import panopticnerf_tpu_torch.ops.field_train, panopticnerf_tpu_torch.ops.field_train_cuda\n"
        "import panopticnerf_tpu_torch.models.fused_apply\n"
        "import panopticnerf_tpu_torch.train.checkpoint, panopticnerf_tpu_torch.train.recorder\n"
        "import panopticnerf_tpu_torch.viz, panopticnerf_tpu_torch.viz.png\n"
        "import panopticnerf_tpu_torch.data.stream, panopticnerf_tpu_torch.render.panorama\n"
        "import panopticnerf_tpu_torch.parallel, panopticnerf_tpu_torch.export_label_transfer\n"
        "import chip_smoke\n"
        # chip_smoke imports the port inside main(); load what it loads
        "from panopticnerf_tpu_torch import engine, convert\n"
        "from panopticnerf_tpu_torch.ops import _nvcc, field_train_cuda, intersect_cuda, mlp_train_cuda\n"
        "from panopticnerf_tpu_torch.data import make_dataset\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'panopticnerf_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda():
    """No card: non-zero exit and no result line."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _schema(cls):
    hints = typing.get_type_hints(cls)
    out = {}
    for f in dataclasses.fields(cls):
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
        ty = hints[f.name]
        if dataclasses.is_dataclass(default):
            ty, default = ty.__name__, _schema(type(default))
        out[f.name] = (str(ty), default)
    return out


def test_config_schema_matches_jax_package():
    from panopticnerf_tpu.config.config import _ALIASES as jax_aliases
    from panopticnerf_tpu.config.config import Config as JaxConfig
    from panopticnerf_tpu_torch.config.config import _ALIASES, Config

    assert _schema(Config) == _schema(JaxConfig)
    assert _ALIASES == jax_aliases


@pytest.mark.parametrize("cfg_file", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))))
def test_every_shipped_yaml_loads_identically(cfg_file):
    from panopticnerf_tpu.config.config import load_config as jax_load_config
    from panopticnerf_tpu.config.config import to_dict as jax_to_dict
    from panopticnerf_tpu_torch.config.config import load_config, to_dict

    opts = ["N_samples", "32", "use_stereo", "false", "render.far", "80", "gpus", "0"]
    assert to_dict(load_config(cfg_file, opts)) == jax_to_dict(jax_load_config(cfg_file, opts))


def test_config_rejects_unknown_keys():
    from panopticnerf_tpu_torch.config import load_config

    with pytest.raises(KeyError):
        load_config(None, ["render.no_such_key", "1"])
    with pytest.raises(KeyError):
        load_config(None, ["nosection.key", "1"])
    with pytest.raises(ValueError):
        load_config(None, ["render.perturb"])
