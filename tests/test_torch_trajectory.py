"""Many consecutive training steps of the port against the JAX package's
jitted step, from the same flax init, with JAX's draws of every step
replayed (`tools/export_torch_train_trajectory.py`'s runs at a small size).

One run of K steps crosses every schedule boundary of the step: the
pretrain gate (semantic losses off before train.pretrain_steps), the
agreement filter switching on at agree_start * max_steps, the weight_th
anneal from weight_th_anneal_start * max_steps, the exponential lr decay
over max_steps, the EMA's warmup rule min(decay, (1 + t) / (10 + t))
turning into the constant decay at t = 8, and clipping by global norm at
the steps whose norm exceeds train.grad_clip. float32 compute: every stat
at every step within the one-step test's rtol 1e-4
(tests/test_torch_train_step.py), the params and EMA after every step
within PARAM_ATOL.
In bf16 the two packages round differently, as do the JAX package's own
plain and Pallas steps: there the port's drift from JAX is held to a
multiple of that floor, measured in the same test.
"""

import os
import sys

import jax
import numpy as np
import pytest

from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.models import init_params as jax_init_params
from panopticnerf_tpu.models import make_network as jax_make_network
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from export_torch_train_trajectory import drift, jax_run, port_run  # noqa: E402
from test_torch_run_staged import one_intra_op_thread  # noqa: E402,F401
from test_torch_train_step import STEP  # noqa: E402

K = 24
# the schedule boundaries inside the run: the pretrain gate opens at step 4,
# the agreement filter turns on at 0.5 * K = 12 (agree_conf 0.3, so that the
# small field's 4-class softmax demotes pixels), the weight_th anneal starts
# at 0.25 * K = 6; the global norm crosses grad_clip both ways
SCHEDULE = [
    "train.max_steps", str(K), "train.pretrain", "nerf", "train.pretrain_steps", "4",
    "loss.pseudo_filter", "true", "loss.agree_filter", "true", "loss.agree_start", "0.5",
    "loss.agree_conf", "0.3",
    "loss.weight_th_final", "0.2", "loss.weight_th_anneal_start", "0.25",
    "train.ema_decay", "0.5", "train.grad_clip", "0.5",
]
# the params and EMA after each of K float32 steps, port against JAX: read at
# most 1.04e-6 over the five cases (every stat at most 9.3e-6 relative),
# where a leaf AdamW failed to decay read 2.6e-5 after 24 steps
PARAM_ATOL = 5e-6
# bf16: the port's drift from JAX at step K over the JAX package's own
# plain-vs-Pallas drift, every parameter together. Read 0.88 (plain) and
# 0.23 (trunk) here; 0.74 and 0.76 at the flagship's full width after 30
# steps (artifacts/torch/synthetic_flagship_jax_trajectory.json)
BF16_FLOOR_MULTIPLE = 1.5


def _runs(opts, names):
    """K steps of each named run ('jax_plain', 'jax_<mode>', 'port_plain',
    'port_<mode>') from one flax init -> {name: (stats, params, ema), each
    a list over the steps}, and the init's flat params."""
    base = jax_load_config(None, opts)
    params = jax_init_params(jax_make_network(base), jax.random.key(0))
    key = jax.random.key(base.train.seed + 1)
    out = {}
    for name in names:
        side, mode = name.split("_")
        run_opts = opts + (["model.use_pallas", "false"] if mode == "plain" else
                           ["model.use_pallas", "true", "model.pallas_mode", mode])
        jcfg = jax_load_config(None, run_opts)
        it = (jax_run(jcfg, params, key) if side == "jax" else
              port_run(load_config(None, run_opts), jcfg, params, key))
        out[name] = tuple(map(list, zip(*(next(it) for _ in range(K)))))
    return out, {k: np.asarray(v) for k, v in flatten(params["params"]).items()}


@pytest.mark.parametrize("mode,extra", [
    ("plain", []), ("trunk", []), ("field", []), ("hybrid", []),
    ("plain", ["train.weight_decay", "0.01"]),
], ids=["plain", "trunk", "field", "hybrid", "plain-adamw"])
def test_trajectory_matches_jax(mode, extra):
    opts = STEP + SCHEDULE + extra
    runs, _ = _runs(opts, [f"jax_{mode}", f"port_{mode}"])
    (want, wp, we), (got, gp, ge) = runs[f"jax_{mode}"], runs[f"port_{mode}"]
    # the run crosses every boundary: the semantic losses join the total at
    # step 4, the agreement filter demotes from step 12, the clip bites
    lc = jax_load_config(None, opts).loss
    for t, s in enumerate(want):
        rest = s["loss_total"] - lc.rgb_weight * s["loss_rgb"] - lc.depth_weight * s["loss_depth"]
        assert (abs(rest) < 1e-6) == (t < 4), (t, rest)
        assert (s["agree_demote_frac"] > 0) == (t >= K // 2), (t, s["agree_demote_frac"])
    assert any(s["grad_norm"] > 0.5 for s in want) and any(s["grad_norm"] < 0.5 for s in want)
    for t, (w, g) in enumerate(zip(want, got)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {t + 1} {k}")
    for t in range(K):
        for name, a, b in (("params", gp[t], wp[t]), ("ema", ge[t], we[t])):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=PARAM_ATOL,
                                           err_msg=f"step {t + 1} {name} {k}")


def test_bf16_trajectory_within_the_jax_floor():
    """bf16 compute: K steps of the port in modes plain and trunk against
    the JAX package's, beside the JAX package's own plain-vs-Pallas drift."""
    names = ["jax_plain", "jax_trunk", "port_plain", "port_trunk"]
    runs, theta0 = _runs(STEP + SCHEDULE + ["model.compute_dtype", "bfloat16"], names)
    p = {n: r[1][-1] for n, r in runs.items()}
    floor, _ = drift(p["jax_trunk"], p["jax_plain"], theta0)
    plain, _ = drift(p["port_plain"], p["jax_plain"], theta0)
    trunk, _ = drift(p["port_trunk"], p["jax_trunk"], theta0)
    print(f"bf16 drift at step {K}: JAX trunk/plain {floor:.4e}, port/JAX plain {plain:.4e}, "
          f"trunk {trunk:.4e}")
    assert floor > 0
    assert plain <= BF16_FLOOR_MULTIPLE * floor and trunk <= BF16_FLOOR_MULTIPLE * floor
