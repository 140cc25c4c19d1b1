"""The port's LPIPS (panopticnerf_tpu_torch/eval/lpips.py) against the JAX
package's, on random weights in the layout of tools/convert_lpips_weights.py
(the real ones are not in the repo): the cases of tests/test_lpips.py on
the port, the distance against JAX's at rtol 1e-5 (float32 on the CPU; the
two convolution libraries sum in other orders), the evaluator's `lpips`
key, and the repaired fault: a config with `eval.lpips_weights` evaluates
(with LPIPS from a good file, without it after "LPIPS disabled" from a bad
one) where the port used to raise NotImplementedError."""

import numpy as np
import pytest
import torch

from panopticnerf_tpu.eval.lpips import LPIPS as JaxLPIPS
from panopticnerf_tpu_torch.eval.lpips import _ALEX_LAYERS, LPIPS, make_lpips
from test_torch_run_staged import one_intra_op_thread  # noqa: F401 (autouse)

RTOL = 1e-5


def _random_weights(path, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {}
    in_ch = 3
    for i, (out_ch, k, _, _, _) in enumerate(_ALEX_LAYERS):
        arrays[f"conv{i}_w"] = rng.normal(0, 0.1, (out_ch, in_ch, k, k)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(0, 0.01, (out_ch,)).astype(np.float32)
        arrays[f"lin{i}"] = np.abs(rng.normal(0, 1, (out_ch,))).astype(np.float32)
        in_ch = out_ch
    np.savez(path, **arrays)
    return str(path)


def test_lpips_metric_invariants(tmp_path):
    fn = LPIPS(_random_weights(tmp_path / "w.npz"))
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(64, 96, 3)).astype(np.float32)
    b = rng.uniform(size=(64, 96, 3)).astype(np.float32)
    d = lambda x, y: float(fn(x, y))
    assert d(a, a) == pytest.approx(0.0, abs=1e-6)
    d_ab, d_ba = d(a, b), d(b, a)
    assert d_ab > 1e-4
    assert d_ab == pytest.approx(d_ba, rel=1e-4)
    a_eps = np.clip(a + 0.01 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    assert d(a, a_eps) < d_ab
    # tensors and arrays give the same distance
    assert float(fn(torch.from_numpy(a), torch.from_numpy(b))) == d_ab


def test_lpips_small_frame_returns_nan(tmp_path):
    fn = LPIPS(_random_weights(tmp_path / "w.npz"))
    tiny = np.zeros((24, 32, 3), np.float32)
    assert np.isnan(float(fn(tiny, tiny)))


def test_make_lpips_graceful_skip(tmp_path):
    msgs = []
    assert make_lpips("", log=msgs.append) is None
    assert msgs == []
    missing = make_lpips(str(tmp_path / "nope.npz"), log=msgs.append)
    assert missing is None and "LPIPS disabled" in msgs[-1]
    np.savez(tmp_path / "bad.npz", conv0_w=np.zeros((2, 2)))
    bad = make_lpips(str(tmp_path / "bad.npz"), log=msgs.append)
    assert bad is None and "missing arrays" in msgs[-1]
    # a truncated file is malformed too (the reference raises BadZipFile there)
    good = open(_random_weights(tmp_path / "w.npz"), "rb").read()
    (tmp_path / "cut.npz").write_bytes(good[: len(good) // 2])
    assert make_lpips(str(tmp_path / "cut.npz"), log=msgs.append) is None
    assert "LPIPS disabled" in msgs[-1]
    shapes = dict(np.load(tmp_path / "w.npz"))
    shapes["conv2_w"] = shapes["conv2_w"][:, :, :2]
    np.savez(tmp_path / "shape.npz", **shapes)
    assert make_lpips(str(tmp_path / "shape.npz"), log=msgs.append) is None
    assert "conv2_w shape" in msgs[-1]


class _Out:  # the rgb path of a RenderOut
    def __init__(self, rgb):
        self.rgb = rgb
        self.depth = self.sem_logits = self.sem_fixed = None


def test_evaluator_emits_lpips_when_configured(tmp_path):
    from panopticnerf_tpu_torch.config import Config
    from panopticnerf_tpu_torch.eval import make_evaluator

    cfg = Config()
    cfg.model.num_classes = 4
    cfg.eval.lpips_weights = _random_weights(tmp_path / "w.npz")
    ev = make_evaluator(cfg)
    assert ev.lpips_fn is not None
    rgb = torch.from_numpy(np.random.default_rng(0).uniform(size=(64 * 96, 3)).astype(np.float32))
    gt = np.random.default_rng(2).uniform(size=(64 * 96, 3)).astype(np.float32)
    ev.evaluate(_Out(rgb), gt_rgb=gt, image_hw=(64, 96))
    res = ev.summarize()
    assert "lpips" in res and res["lpips"] > 0
    assert "LPIPS:" in ev.summary_table()
    cfg2 = Config()
    cfg2.model.num_classes = 4
    assert make_evaluator(cfg2).lpips_fn is None


@pytest.mark.parametrize("hw", [(48, 64), (64, 96), (94, 352)])
def test_lpips_matches_jax(tmp_path, hw):
    path = _random_weights(tmp_path / "w.npz", seed=3)
    rng = np.random.default_rng(hw[0])
    a = rng.uniform(size=hw + (3,)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ref = JaxLPIPS(path)(a, b)
    assert float(LPIPS(path)(a, b)) == pytest.approx(ref, rel=RTOL)


def test_evaluator_lpips_key_matches_jax(tmp_path):
    from panopticnerf_tpu.config import Config as JaxConfig
    from panopticnerf_tpu.eval import make_evaluator as jax_make_evaluator
    from panopticnerf_tpu_torch.config import Config
    from panopticnerf_tpu_torch.eval import make_evaluator

    path = _random_weights(tmp_path / "w.npz", seed=4)
    rng = np.random.default_rng(5)
    rgb = rng.uniform(size=(64 * 80, 3)).astype(np.float32)
    gt = rng.uniform(size=(64 * 80, 3)).astype(np.float32)
    evs = []
    for make, cfg in ((jax_make_evaluator, JaxConfig()), (make_evaluator, Config())):
        cfg.model.num_classes = 4
        cfg.eval.lpips_weights = path
        evs.append(make(cfg))
    jev, ev = evs
    jev.evaluate(_Out(rgb), gt_rgb=gt, image_hw=(64, 80))
    ev.evaluate(_Out(torch.from_numpy(rgb)), gt_rgb=gt, image_hw=(64, 80))
    jres, res = jev.summarize(), ev.summarize()
    assert res["lpips"] == pytest.approx(jres["lpips"], rel=RTOL)
    assert res["psnr"] == pytest.approx(jres["psnr"], rel=1e-6)


def test_config_with_lpips_weights_evaluates(tmp_path, capsys):
    """The repaired fault: run_evaluate with eval.lpips_weights set scores
    LPIPS from a good file and, from a bad one, logs "LPIPS disabled" and
    scores the same metrics as without it."""
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config
    from torch_scenes import engine_opts

    opts = engine_opts(tmp_path, "lpips") + ["data.synthetic_image_hw", "48,64"]
    engine.run_train(load_config(None, opts), "cpu", max_steps=4, log=lambda *a: None)
    plain = engine.run_evaluate(load_config(None, opts), "cpu", log=lambda *a: None)
    assert "lpips" not in plain

    good = _random_weights(tmp_path / "w.npz")
    logs = []
    res = engine.run_evaluate(load_config(None, opts + ["eval.lpips_weights", good]), "cpu",
                              log=logs.append)
    assert np.isfinite(res["lpips"]) and res["lpips"] > 0
    assert "LPIPS:" in "\n".join(logs)
    for key in ("psnr", "miou", "pq"):
        assert res[key] == plain[key]

    (tmp_path / "bad.npz").write_bytes(open(good, "rb").read()[:1000])
    bad = engine.run_evaluate(load_config(None, opts + ["eval.lpips_weights",
                                                        str(tmp_path / "bad.npz")]),
                              "cpu", log=lambda *a: None)
    assert "LPIPS disabled" in capsys.readouterr().out
    assert "lpips" not in bad
    for key in ("psnr", "miou", "pq"):
        assert bad[key] == plain[key]
