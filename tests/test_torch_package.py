"""Package-level checks of the PyTorch port: it imports no JAX (nor flax,
optax, orbax, nor any module of the JAX package) and no PIL (the card's
machine has none), its kernel wrappers launch only through `ops/_nvcc.py`,
and its config schema is the JAX package's, field for field."""

import ast
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
        "import panopticnerf_tpu_torch.run_staged, panopticnerf_tpu_torch.eval.lpips\n"
        "import panopticnerf_tpu_torch.eval.sweep, panopticnerf_tpu_torch.utils.profiling\n"
        "import panopticnerf_tpu_torch.tools.landing_sweep, panopticnerf_tpu_torch.tools.pq_analysis\n"
        "import panopticnerf_tpu_torch.tools.compute_visible_ids, panopticnerf_tpu_torch.tools.check_data\n"
        "import panopticnerf_tpu_torch.tools.xview_diag\n"
        "import chip_smoke\n"
        # chip_smoke imports the port inside main(); load what it loads
        "from panopticnerf_tpu_torch import engine, convert\n"
        "from panopticnerf_tpu_torch.ops import _nvcc, field_train_cuda, intersect_cuda, mlp_train_cuda\n"
        "from panopticnerf_tpu_torch.data import make_dataset\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'panopticnerf_tpu', 'PIL'))\n"
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


OPS = os.path.join(REPO, "panopticnerf_tpu_torch", "ops")
WRAPPERS = sorted(os.path.basename(f) for f in glob.glob(os.path.join(OPS, "*_cuda.py")))


def _cuda_imports(nodes) -> list:
    """The `*_cuda` modules that the import statements among `nodes` name."""
    names = []
    for node in nodes:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names += [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
    return sorted({n for n in names if n.endswith("_cuda")})


def _launch_work(tree) -> list:
    """What only the launch seam may do, as the code (not the docstrings) of
    `tree` does it: call `count`, read `.cuda_stream`, assign `.argtypes`,
    define a tensor-check, pointer or stream helper."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if (f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)) == "count":
                found.append("count")
        elif isinstance(node, ast.Attribute) and node.attr == "cuda_stream":
            found.append("cuda_stream")
        elif (isinstance(node, ast.Attribute) and node.attr == "argtypes"
              and isinstance(node.ctx, ast.Store)):
            found.append("argtypes")
        elif isinstance(node, ast.FunctionDef) and node.name.strip("_") in ("check", "ptr",
                                                                            "stream"):
            found.append(node.name)
    return sorted(set(found))


@pytest.mark.parametrize("fname", WRAPPERS + ["field_eval.py", "_nvcc.py"])
def test_kernels_launch_through_one_seam(fname):
    """No `ops/*_cuda.py` imports another, `ops/field_eval.py` imports none
    at module level, and neither counts a launch, reads the stream, declares
    an entry point or checks a tensor itself: `ops/_nvcc.py` does all four."""
    tree = ast.parse(open(os.path.join(OPS, fname)).read())
    if fname == "_nvcc.py":
        assert _launch_work(tree) == ["argtypes", "check", "count", "cuda_stream", "ptr"]
        return
    assert len(WRAPPERS) == 7, WRAPPERS
    own = fname[:-len(".py")]
    nodes = ast.walk(tree) if fname in WRAPPERS else tree.body
    assert [m for m in _cuda_imports(nodes) if m.rsplit(".", 1)[-1] != own] == []
    assert _launch_work(tree) == []


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
    """Field for field and default for default, but for the port's one own
    key, `model.hash_grid` (the JAX package has no grid), off by default."""
    from panopticnerf_tpu.config.config import _ALIASES as jax_aliases
    from panopticnerf_tpu.config.config import Config as JaxConfig
    from panopticnerf_tpu_torch.config.config import _ALIASES, PORT_ONLY, Config

    schema = _schema(Config)
    assert PORT_ONLY == {"model": ("hash_grid",)}
    assert schema["model"][1].pop("hash_grid") == (str(bool), False)
    assert schema == _schema(JaxConfig)
    assert _ALIASES == jax_aliases


@pytest.mark.parametrize("cfg_file", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))))
def test_every_shipped_yaml_loads_identically(cfg_file):
    from panopticnerf_tpu.config.config import load_config as jax_load_config
    from panopticnerf_tpu.config.config import to_dict as jax_to_dict
    from panopticnerf_tpu_torch.config.config import load_config, to_dict, without_port_only

    opts = ["N_samples", "32", "use_stereo", "false", "render.far", "80", "gpus", "0"]
    port = to_dict(load_config(cfg_file, opts))
    assert port["model"]["hash_grid"] is False
    assert without_port_only(port) == jax_to_dict(jax_load_config(cfg_file, opts))


@pytest.mark.parametrize("cfg_file", sorted(glob.glob(os.path.join(REPO, "configs", "torch",
                                                                 "*.yaml"))))
def test_every_port_only_yaml_is_jax_reading_plus_its_keys(cfg_file, tmp_path):
    """A config of the port alone (configs/torch/) sets a port-only key: the JAX package
    refuses it whole, and reads the file without that key as the port reads the rest."""
    import yaml

    from panopticnerf_tpu.config.config import load_config as jax_load_config
    from panopticnerf_tpu.config.config import to_dict as jax_to_dict
    from panopticnerf_tpu_torch.config.config import (
        PORT_ONLY,
        load_config,
        to_dict,
        without_port_only,
    )

    opts = ["N_samples", "32", "use_stereo", "false", "render.far", "80", "gpus", "0"]
    raw = yaml.safe_load(open(cfg_file))
    own = [(s, k) for s, keys in PORT_ONLY.items() for k in keys if k in raw.get(s, {})]
    assert own, cfg_file
    with pytest.raises(KeyError):
        jax_load_config(cfg_file, opts)
    port = to_dict(load_config(cfg_file, opts))
    for s, k in own:
        del raw[s][k]
    stripped = str(tmp_path / "without_port_keys.yaml")
    with open(stripped, "w") as f:
        yaml.safe_dump(raw, f)
    assert without_port_only(port) == jax_to_dict(jax_load_config(stripped, opts))


def test_config_rejects_unknown_keys():
    from panopticnerf_tpu_torch.config import load_config

    with pytest.raises(KeyError):
        load_config(None, ["render.no_such_key", "1"])
    with pytest.raises(KeyError):
        load_config(None, ["nosection.key", "1"])
    with pytest.raises(ValueError):
        load_config(None, ["render.perturb"])
