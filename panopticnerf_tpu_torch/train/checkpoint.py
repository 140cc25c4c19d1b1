"""Checkpoint save / restore in torch's format (port of
`panopticnerf_tpu/train/checkpoint.py`, which uses orbax).

A step root is a directory of `<step>.pt` files, each one whole training
state: the model's params, the optimizer's `state_dict()`, the update
count, the EMA of the params (or None) and the training generator's state.
The generator's state is what the reference does not need: it folds the
step into one base key, while the port draws every batch from a stateful
`torch.Generator`, so a resumed run without that state would draw other
batches. Files are written with `torch.save` to a temporary name and
renamed, and read with `weights_only=True`.

A converted `.npz` (`convert.save_npz`, tools/export_torch_params.py) is a
weights-only checkpoint: `load_network` reads it when given its path.

Read paths create nothing.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Optional

import torch

from panopticnerf_tpu_torch.convert import load_npz

_STEP_FILE = re.compile(r"(\d+)\.pt$")
_NPZ_STEP = re.compile(r"_(\d+)\.npz$")


def step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"{step}.pt")


def all_steps(directory: str) -> list[int]:
    """The steps saved under `directory`, ascending (empty when it does not
    exist)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory) if (m := _STEP_FILE.fullmatch(f)))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def save_model(state, directory: str, step: int, generator: Optional[torch.Generator] = None,
               max_to_keep: int = 3) -> str:
    """Write the whole TrainState (and `generator`'s state) as step `step`,
    keeping the newest `max_to_keep` steps. Returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    path = step_path(directory, step)
    payload = {
        "params": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "ema": state.ema,
        "generator": generator.get_state() if generator is not None else None,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in all_steps(directory)[:-max_to_keep]:
        os.remove(step_path(directory, old))
    return path


def _read(directory: str, step: int) -> dict:
    return torch.load(step_path(directory, step), map_location="cpu", weights_only=True)


@torch.no_grad()
def load_model(state, directory: str, step: Optional[int] = None,
               generator: Optional[torch.Generator] = None):
    """Restore a whole TrainState in place (and `generator`'s state).
    Returns (state, step), or (state, None) untouched when `directory`
    holds no checkpoint (the reference's `resume` semantics)."""
    target = step if step is not None else latest_step(directory)
    if target is None or not os.path.isfile(step_path(directory, target)):
        return state, None
    ck = _read(directory, target)
    if (state.ema is None) != (ck["ema"] is None):
        raise ValueError(
            f"checkpoint {step_path(directory, target)} "
            f"{'has' if ck['ema'] is not None else 'has no'} EMA weights, the run "
            f"{'tracks' if state.ema is not None else 'does not track'} one (train.ema_decay)")
    state.model.load_state_dict(ck["params"])
    state.optimizer.load_state_dict(ck["optimizer"])
    state.step = int(ck["step"])
    if state.ema is not None:
        for k, v in ck["ema"].items():
            state.ema[k].copy_(v)
    if generator is not None and ck["generator"] is not None:
        generator.set_state(ck["generator"])
    return state, target


def _read_weights(path: str, step: Optional[int], prefer_ema: bool):
    """(state_dict on the CPU, step) from a step root or a converted .npz."""
    if path.endswith(".npz"):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint {path}")
        m = _NPZ_STEP.search(os.path.basename(path))
        return load_npz(path), int(m.group(1)) if m else None
    target = step if step is not None else latest_step(path)
    if target is None or not os.path.isfile(step_path(path, target)):
        raise FileNotFoundError(f"no checkpoint found under {path}"
                                + (f" at step {step}" if step is not None else ""))
    ck = _read(path, target)
    if prefer_ema and ck["ema"]:
        return ck["ema"], target
    return ck["params"], target


def load_network(template: dict, path: str, step: Optional[int] = None, strict: bool = True,
                 prefer_ema: bool = False):
    """Weights-only restore (reference `load_network`) -> (state_dict, step).

    `path` is a step root (step `step`, else the latest) or a converted
    `.npz`. `template` is the model's `state_dict()`: the result has its
    names, dtypes and devices. strict=True (evaluation): the names and
    shapes must match. strict=False (warm start): `_merge_params`.
    prefer_ema=True: the checkpoint's EMA weights when it holds them.
    """
    restored, target = _read_weights(path, step, prefer_ema)
    if strict:
        missing = sorted(set(template) ^ set(restored))
        bad = [k for k in template if k in restored
               and tuple(restored[k].shape) != tuple(template[k].shape)]
        if missing or bad:
            raise ValueError(f"checkpoint {path} does not match the model: "
                             f"names only on one side {missing}, shapes differ at {bad}")
        return {k: restored[k].to(t.device, t.dtype) for k, t in template.items()}, target
    copied = [0]
    params = _merge_params(template, restored, copied)
    if copied[0] == 0:
        raise ValueError(
            f"warm start from {path}: no checkpoint leaf matched the model's "
            f"parameters (0/{len(template)}): wrong experiment directory or "
            f"incompatible model")
    if copied[0] < len(template):
        warnings.warn(f"warm start from {path}: merged {copied[0]}/{len(template)} "
                      f"leaves; the rest keep fresh initialization", stacklevel=2)
    return params, target


def _merge_params(template: dict, restored: dict, copied=None) -> dict:
    """Copy every checkpoint leaf whose name and shape match the template;
    keep the template (fresh init) elsewhere, warning on a shape mismatch.

    This lets a coarse-only pretrained field warm-start a coarse+fine
    model: the fine field and new heads keep their fresh initialization.
    """
    out = {}
    for k, t in template.items():
        if k not in restored:
            out[k] = t
        elif tuple(restored[k].shape) == tuple(t.shape):
            if copied is not None:
                copied[0] += 1
            out[k] = restored[k].to(t.device, t.dtype)
        else:
            warnings.warn(f"warm start: shape mismatch at {k} (ckpt {tuple(restored[k].shape)} "
                          f"vs model {tuple(t.shape)}) — keeping fresh initialization for it",
                          stacklevel=2)
            out[k] = t
    return out
