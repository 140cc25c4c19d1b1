"""Flax parameter tree (as numpy arrays) <-> the port's `state_dict`.

The tree is the flax `PanopticNeRF` params — nested dicts, or the flat
`{"coarse/trunk_0/kernel": array}` form that tools/export_torch_params.py
writes to `.npz`. Flax `Dense.kernel` is (in, out); `nn.Linear.weight` is
(out, in). Module names are the same in both packages. A hash grid's table
(`coarse.grid.table_0`, port-only) is kept as it is, (rows, F), under its
own leaf name.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> dict:
    """Nested param dict -> {"coarse/trunk_0/kernel": leaf, ...}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten(v, key))
        else:
            flat[key] = v
    return flat


def params_from_flax(np_tree) -> dict:
    """-> {"coarse.trunk_0.weight": tensor (out, in), ...}, float32 on the CPU.

    Accepts nested dicts (optionally under a top-level "params" key) or the
    flat "/"-joined form.
    """
    if set(np_tree) == {"params"}:
        np_tree = np_tree["params"]
    flat = flatten(np_tree)
    state = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        arr = np.array(value, np.float32)  # a writable copy
        if leaf == "kernel":
            state[".".join(path + ["weight"])] = torch.from_numpy(np.ascontiguousarray(arr.T))
        elif leaf == "bias" or leaf.startswith("table_"):
            state[".".join(path + [leaf])] = torch.from_numpy(arr)
        else:
            raise KeyError(f"unexpected flax leaf {key!r}")
    return state


def load_npz(path: str) -> dict:
    """A converted-checkpoint `.npz` -> state_dict."""
    with np.load(path) as z:
        return params_from_flax({k: z[k] for k in z.files})


def params_to_flax(state_dict) -> dict:
    """The inverse of `params_from_flax`: state_dict -> the flat
    {"coarse/trunk_0/kernel": float32 array (in, out), ...} form."""
    flat = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            flat["/".join(path + ["kernel"])] = np.ascontiguousarray(arr.T)
        elif leaf == "bias" or leaf.startswith("table_"):
            flat["/".join(path + [leaf])] = arr.copy()
        else:
            raise KeyError(f"unexpected state_dict entry {key!r}")
    return flat


def save_npz(path: str, state_dict) -> None:
    """Write a state_dict as a converted-checkpoint `.npz` (what `load_npz`
    and the evaluation read)."""
    np.savez(path, **params_to_flax(state_dict))
