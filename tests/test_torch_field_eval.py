"""Kernel E's plain version (`ops/field_eval.py`), its packing and its
dispatch on the CPU: the plain version against the model it replaces on the
card (`NeRFMLP.forward`) at the three shipped field shapes, the evaluation
branch's choice of E (CUDA only, shapes E takes only, never in training),
the adapter and its counters, and the benchmark's reader of them."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from panopticnerf_tpu_torch.config import ModelConfig, load_config
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.models.eval_field import EvalField, eval_field
from panopticnerf_tpu_torch.models.nerf import NeRFMLP, coarse_field_cfg
from panopticnerf_tpu_torch.ops.field_eval import (
    eval_dims,
    evaluator,
    field_eval_plain,
    freqs,
    pack_eval,
)
from panopticnerf_tpu_torch.ops.field_train import CO_PAD, D_PAD
from panopticnerf_tpu_torch.ops.mlp_train import F_PAD
from panopticnerf_tpu_torch.render import renderer
from panopticnerf_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the shipped fields: the 8x256 (skip 4, 19 classes) of both shipped configs,
# KITTI-360's 4x64 proposal coarse, synthetic_panoptic's 128-wide field
SHAPES = {
    "8x256": ModelConfig(num_classes=19),
    "4x64 proposal": coarse_field_cfg(ModelConfig(num_classes=19, coarse_trunk_depth=4,
                                                  coarse_trunk_width=64), True),
    "128-wide": ModelConfig(trunk_width=128, color_width=64, num_classes=8),
}


def _field(cfg: ModelConfig, dtype: str, seed: int) -> NeRFMLP:
    """A field with seeded weights and biases far from zero."""
    torch.manual_seed(seed)
    net = NeRFMLP(dataclasses.replace(cfg, compute_dtype=dtype))
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return net


def _points(rays: int, samples: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    pts = (torch.rand(rays, samples, 3, generator=g) * 2 - 1) * 1.5
    dirs = torch.nn.functional.normalize(torch.randn(rays, 3, generator=g), dim=-1)
    return pts, dirs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("samples", [64, 128, 96])  # coarse, fine, a keep-M count
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_version_equals_the_model(shape, samples, dtype):
    """E's plain version on the packed weights (encodings from the points
    and the rays' directions, flax's roundings) gives the model's sigma,
    rgb and semantic logits: bit for bit in float32; in bfloat16 at most
    one bf16 ulp apart on at most 1e-3 of the outputs (it runs the model's
    own products, so it is exact there too)."""
    cfg = SHAPES[shape]
    net = _field(cfg, dtype, samples)
    dims = eval_dims(cfg)
    rays = 4
    pts, dirs = _points(rays, samples, samples + len(shape))
    ref = net(pts, dirs[:, None, :])
    got = field_eval_plain(pts.reshape(-1, 3), dirs, samples, pack_eval(net, dims,
                                                                         getattr(torch, dtype)),
                           dims)
    assert got[2] is not None
    for name, a, b in zip(("sigma", "rgb", "sem"), got, ref):
        b = b.reshape(a.shape)
        assert a.dtype == b.dtype == torch.float32, name
        if dtype == "float32":
            assert torch.equal(a, b), name
            continue
        ulp = torch.finfo(torch.bfloat16).eps * b.abs().clamp(min=torch.finfo(torch.float32).tiny)
        off = a != b
        assert bool(((a - b).abs() <= ulp)[off].all()), name
        assert float(off.float().mean()) <= 1e-3, name


def test_packing_holds_each_layer_of_the_model():
    """pack_eval puts each Dense layer's weight (cast to bf16) where E reads
    it, each bias rounded to bf16 and held as float32, zeros in every
    padding row and column."""
    cfg = SHAPES["8x256"]
    net = _field(cfg, "bfloat16", 1)
    dims = eval_dims(cfg)
    pk = pack_eval(net, dims, torch.bfloat16)
    bf = lambda m: m.weight.detach().to(torch.bfloat16).t()
    rb = lambda m: m.bias.detach().to(torch.bfloat16).float()
    w, sh, sa, xd = dims.width, dims.sem_hidden, dims.sa, dims.x_dim
    assert dims.skips == (5,) and (dims.x_dim, dims.d_dim) == (63, 27)
    assert (dims.cwp, dims.cp, dims.ho) == (128, 32, 160 + 256)
    for i in range(dims.layers):
        layer = getattr(net, f"trunk_{i}")
        rows = slice(w, w + xd) if i == 0 else slice(0, w + xd if i in dims.skips else w)
        assert torch.equal(pk.wp[i, rows], bf(layer)), i
        assert torch.equal(pk.bp[i], rb(layer)), i
    assert not pk.wp[0, :w].any() and not pk.wp[:, w + xd:].any() and not pk.wp[1:4, w:].any()
    assert pk.bp.dtype == pk.hb.dtype == pk.bso.dtype == torch.float32
    assert torch.equal(pk.hw[:, :sh], bf(net.sem_hidden)) and torch.equal(pk.hb[:sh],
                                                                           rb(net.sem_hidden))
    assert torch.equal(pk.hw[:, sh:sh + 1], bf(net.sigma)) and pk.hb[sh] == rb(net.sigma)[0]
    assert not pk.hw[:, sh + 1:sa].any() and not pk.hb[sh + 1:sa].any()
    assert torch.equal(pk.hw[:, sa:], bf(net.feature)) and torch.equal(pk.hb[sa:],
                                                                       rb(net.feature))
    assert torch.equal(pk.wso[:, :19], bf(net.sem_out)) and not pk.wso[:, 19:].any()
    assert torch.equal(pk.wch[:w + 27, :128], bf(net.color_hidden))
    assert not pk.wch[w + 27:].any() and pk.wch.shape == (w + D_PAD, 128)
    assert torch.equal(pk.wco[:128, :3], bf(net.color_out)) and not pk.wco[:, 3:].any()
    assert pk.wco.shape == (128, CO_PAD) and torch.equal(pk.bco[:3], rb(net.color_out))
    assert pk.wp.shape == (8, w + F_PAD, w)
    assert (freqs(dims.x_dim), freqs(dims.d_dim), freqs(0)) == (10, 4, -1)


@pytest.mark.parametrize("change,takes", [
    ({}, True), ({"trunk_width": 32}, False), ({"trunk_width": 512}, False),
    ({"num_classes": 129}, False), ({"num_classes": 128}, True), ({"color_width": 160}, False),
    ({"xyz_freqs": 11}, False), ({"dir_freqs": 5}, False), ({"skips": (7,)}, False),
    ({"skips": (0, 3)}, True), ({"trunk_depth": 33, "skips": ()}, False),
    ({"use_viewdirs": False, "dir_freqs": 9}, True), ({"use_semantic": False}, True),
    ({"xyz_freqs": 0, "dir_freqs": 0}, True)])
def test_eval_dims_takes_the_shapes_the_kernel_takes(change, takes):
    """E takes W in {64, 128, 256}, up to 32 layers, skips before the last
    layer, encodings within 64 / 32 columns, colour width and classes up to
    128; the skips become the layers that read [h, x_enc]."""
    dims = eval_dims(dataclasses.replace(ModelConfig(num_classes=19), **change))
    assert (dims is not None) == takes
    if dims is not None and "skips" in change:
        assert dims.skips == tuple(s + 1 for s in change["skips"])


def _model(overrides=()):
    cfg = load_config(os.path.join(REPO, "configs", "kitti360_panoptic.yaml"), list(overrides))
    return cfg, make_network(cfg, "cpu").eval()


@pytest.mark.parametrize("overrides,levels", [
    ((), (0, 1)),                                            # 4x64 proposal + 8x256 fine
    (("model.coarse_trunk_width", "32"), (1,)),              # a coarse E does not take
    (("model.trunk_width", "32", "model.coarse_trunk_width", "0",
      "model.coarse_trunk_depth", "0"), ()),                 # neither level
    (("model.compute_dtype", "float32"), ()),                # E computes in bf16 only
    (("render.n_importance", "0",), (0,))])                  # a coarse-only model
def test_eval_branch_picks_the_kernel_on_cuda_for_the_shapes_it_takes(overrides, levels):
    """On a CUDA device without gradients the evaluation branch wraps the
    model in an EvalField for the levels E takes (from each field's own
    config), and returns the model itself where E takes no level; on the
    CPU, with gradients on, or for another module, always the model."""
    cfg, model = _model(overrides)
    cuda = torch.device("cuda")
    with torch.no_grad():
        field = eval_field(model, cfg.model, cuda)
        assert eval_field(model, cfg.model, torch.device("cpu")) is model
        assert eval_field(torch.nn.Identity(), cfg.model, cuda).__class__ is torch.nn.Identity
    if levels:
        assert isinstance(field, EvalField) and tuple(sorted(field.dims)) == levels
    else:
        assert field is model
    with torch.enable_grad():
        assert eval_field(model, cfg.model, cuda) is model


def _tiny_cfg(extra=()):
    return load_config(None, [
        "data.max_intervals", "4", "model.trunk_depth", "3", "model.trunk_width", "64",
        "model.skips", "0", "model.color_width", "32", "model.num_classes", "7",
        "render.n_samples", "8", "render.n_importance", "8", "render.use_primitives", "false",
        "render.near", "0.5", "render.far", "6.0", *extra])


def _rays(n=24, seed=0):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)) * 0.1
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
                                      dim=-1)
    return o, d


BOUNDS = renderer.SceneBounds(torch.zeros(3), torch.tensor(0.25))


def test_training_render_never_reaches_the_kernel(monkeypatch):
    """`render_rays(train=True)` evaluates the model (or the training
    adapter) it is given: the evaluation field is never asked for, and no
    evaluation counter moves; `train=False` asks for it once per batch."""
    cfg = _tiny_cfg()
    model = make_network(cfg, "cpu")
    asked = []
    monkeypatch.setattr(renderer, "eval_field", lambda m, c, d: asked.append(d) or m)
    o, d = _rays()
    profiling.reset()
    out = renderer.render_rays(model, o, d, BOUNDS, cfg, train=True,
                               generator=torch.Generator().manual_seed(0))
    out.rgb.sum().backward()
    assert asked == [] and profiling.calls("render.field.points") == 0
    with torch.no_grad():
        renderer.render_rays(model, o, d, BOUNDS, cfg, train=False)
    assert asked == [torch.device("cpu")]
    assert profiling.calls("render.field.points") == 24 * (8 + 16)
    assert profiling.calls("render.field.points_fused") == 0
    profiling.reset()


@pytest.mark.parametrize("keep", [0, 12])
def test_eval_field_adapter_renders_as_the_model(monkeypatch, keep):
    """The EvalField adapter (its plain version on the CPU) in the tiled
    evaluation render of a bf16 model gives the plain model's maps bit for
    bit, with and without keep-M; the counters hold every point both fields
    evaluate and every point E evaluates; weights changed in place are
    packed again."""
    cfg = _tiny_cfg(["render.eval_keep_samples", str(keep), "render.ray_tile", "16"])
    torch.manual_seed(1)
    model = make_network(cfg, "cpu").eval()
    o, d = _rays(40, 2)
    ref = renderer.render_image_rays(model, o, d, BOUNDS, cfg)
    dims = {lv: eval_dims(cfg.model) for lv in (0, 1)}
    monkeypatch.setattr(renderer, "eval_field",
                        lambda m, c, dv: m if isinstance(m, EvalField) else EvalField(m, dims))
    profiling.reset()
    out = renderer.render_image_rays(model, o, d, BOUNDS, cfg)
    for name in ("rgb", "depth", "acc", "sem_logits"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    points = 48 * (8 + (keep or 16))  # 40 rays padded to 3 tiles of 16
    assert profiling.calls("render.field.points") == points
    assert profiling.calls("render.field.points_fused") == points
    profiling.reset()
    # weights changed in place: the next render packs them again
    with torch.no_grad():
        model.fine.trunk_1.weight.mul_(1.5)
        model.coarse.color_out.bias.add_(0.25)
    again = renderer.render_image_rays(model, o, d, BOUNDS, cfg)
    monkeypatch.undo()
    changed = renderer.render_image_rays(model, o, d, BOUNDS, cfg)
    assert not torch.equal(changed.rgb, ref.rgb)
    for name in ("rgb", "depth", "acc", "sem_logits"):
        assert torch.equal(getattr(again, name), getattr(changed, name)), name


def test_evaluator_by_device():
    """On the CPU the packed field evaluates through the plain version; a
    device with no implementation raises."""
    cfg = SHAPES["128-wide"]
    net = _field(cfg, "bfloat16", 3)
    dims = eval_dims(cfg)
    pk = pack_eval(net, dims, torch.bfloat16)
    pts, dirs = _points(2, 64, 0)
    got = evaluator(pk, dims, "cpu")(pts.reshape(-1, 3), dirs, 64)
    ref = field_eval_plain(pts.reshape(-1, 3), dirs, 64, pk, dims)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError):
        evaluator(pk, dims, "meta")


def _reader():
    path = os.path.join(REPO, "benchmark", "metrics", "render_field_fused_pct.render.py")
    spec = importlib.util.spec_from_file_location("render_field_fused_pct_render", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fused_share_reader():
    """The benchmark's `render_field_fused_pct.render`: the share of the
    field's points that E evaluated, None where the program counts neither
    (a program without these counters)."""
    read = _reader().read
    profiling.reset()
    assert read({}) is None
    profiling.count("render.field.points", 300)
    assert read({}) == 0.0
    profiling.count("render.field.points_fused", 75)
    assert read({}) == 25.0
    profiling.reset()
