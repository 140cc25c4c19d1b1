"""Training recorder: smoothed scalar stats, JSONL and optional TensorBoard
(port of `panopticnerf_tpu/train/recorder.py`).

Writes newline-delimited JSON always, and TensorBoard scalars when
`torch.utils.tensorboard` imports. The writer is made at the first
`record`, so a run that records nothing never pays for that import.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Mapping


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.values = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, v: float):
        self.values.append(v)
        self.total += v
        self.count += 1

    @property
    def median(self) -> float:
        s = sorted(self.values)
        return s[len(s) // 2] if s else 0.0

    @property
    def avg(self) -> float:
        return sum(self.values) / len(self.values) if self.values else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class Recorder:
    def __init__(self, record_dir: str):
        self.record_dir = record_dir
        self.jsonl_path = os.path.join(record_dir, "metrics.jsonl")
        os.makedirs(record_dir, exist_ok=True)
        self._jsonl = open(self.jsonl_path, "a")
        self.stats = defaultdict(SmoothedValue)
        self.step = 0
        self._tb = None
        self._tb_tried = False
        self._t_last = time.time()

    def update(self, scalars: Mapping[str, float], step: int | None = None):
        if step is not None:
            self.step = step
        for k, v in scalars.items():
            self.stats[k].update(float(v))

    def _writer(self):
        """The TensorBoard writer, made at the first call; None where
        `torch.utils.tensorboard` does not import."""
        if not self._tb_tried:
            self._tb_tried = True
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return None
            self._tb = SummaryWriter(self.record_dir)
        return self._tb

    def record(self, prefix: str = "train"):
        """Flush the current smoothed values at self.step."""
        payload = {"step": self.step, "prefix": prefix}
        payload.update({k: v.avg for k, v in self.stats.items()})
        self._jsonl.write(json.dumps(payload) + "\n")
        self._jsonl.flush()
        tb = self._writer()
        if tb is not None:
            for k, v in self.stats.items():
                tb.add_scalar(f"{prefix}/{k}", v.avg, global_step=self.step)
            tb.flush()

    def log_line(self, epoch: int, max_epoch: int, lr: float, extra: str = "") -> str:
        now = time.time()
        dt = now - self._t_last
        self._t_last = now
        core = "  ".join(f"{k}: {v.avg:.4f}" for k, v in sorted(self.stats.items()))
        return (f"epoch {epoch}/{max_epoch}  step {self.step}  lr {lr:.2e}  {core}  "
                f"({dt:.1f}s) {extra}")

    def close(self):
        """Idempotent: run_train closes it on the way out, also after an
        exception, and callers may close again."""
        if not self._jsonl.closed:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
            self._tb = None
