"""The port's SIGTERM checkpoint: `python -m panopticnerf_tpu_torch.train_net`
in a child process (the only way to deliver a real signal to the real
handler, which `signal.signal` installs in the main thread) checkpoints at
the next step boundary after SIGTERM and exits with code 0; resumed to N
steps it equals an uninterrupted N-step run bit for bit, in every loss and
every final parameter."""

import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from panopticnerf_tpu_torch import engine
from panopticnerf_tpu_torch.config import load_config
from torch_scenes import engine_opts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sigterm_checkpoints_and_resumes_exactly(tmp_path):
    opts = engine_opts(tmp_path / "run", "preempt", log_interval=2, ema_decay=0.9)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "panopticnerf_tpu_torch.train_net", "--device", "cpu",
         "--max_steps", "100000", *opts],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")),
                              daemon=True)
    reader.start()
    try:
        deadline = time.time() + 120
        while not any(line.startswith("step ") for line in lines):
            if proc.poll() is not None:
                pytest.fail("child exited before its first log line:\n" + "".join(lines))
            if time.time() > deadline:
                pytest.fail("child never logged:\n" + "".join(lines))
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    reader.join(timeout=10)
    out = "".join(lines)
    assert rc == 0, out
    m = re.search(r"SIGTERM received: checkpointing at step (\d+) and exiting", out)
    assert m, out
    k = int(m.group(1))
    assert k >= 2
    n = k + 4

    cfg = load_config(None, opts + ["train.resume", "true"])
    resumed = engine.run_train(cfg, "cpu", max_steps=n, log=lambda *a: None)
    straight = engine.run_train(load_config(None, engine_opts(tmp_path / "straight", "preempt",
                                                              ema_decay=0.9)),
                                "cpu", max_steps=n, log=lambda *a: None)
    assert len(resumed["losses"]) == n - k and not resumed["preempted"]
    np.testing.assert_array_equal(resumed["losses"], straight["losses"][k:])
    a, b = straight["state"], resumed["state"]
    assert a.step == b.step == n
    for name, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[name]), name
        assert torch.equal(a.ema[name], b.ema[name]), name
