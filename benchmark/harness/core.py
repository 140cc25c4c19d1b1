"""What every cell shares: finding its files by name, the program's config,
the seeds, the device record, the guard against JAX, the per-layer readers
and the result line.

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`
under `paths`, found through the entry's `file`) and a traffic mix
(`traffic/<traffic>.json`), whose `kind` names the driver module
(`harness/<kind>.py`, with `run(ctx) -> dict`). The configuration file's
`reference` key names its plain reference, the module
`reference/<reference>.py`: `make_weights(conf_program, seed, device)`,
the seeded draw that both sides get; `fp8_quant`, the control's rounding;
`render_view` for render mixes; `Trainer`, `leaf_gap` and `quiet_leaves`
for train mixes. A per-layer metric is the reader `metrics/<name>.py`
(`read(ctx) -> float | None`, and `LAYERS`, the kernel layers it reads
from the trace); a kernel layer is the directory `kernel_names/<layer>/`
of pattern files. Adding any of these, a reference too, is adding a file:
nothing here names a cell, a configuration, a reference, a mix or a metric.
"""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "panopticnerf_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merged(base: dict, over: dict) -> dict:
    """A copy of `base` with `over` merged in, nested dicts key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def find_cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """-> (workload entry, config entry, config file's dict)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, conf, load_json(os.path.join(ROOT, conf["file"]))


def load_traffic(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"harness.{kind}")


def reference(conf_file: dict) -> ModuleType:
    """The configuration's plain reference, `reference/<conf_file["reference"]>.py`."""
    return importlib.import_module(f"reference.{conf_file['reference']}")


def cell_metrics(bench: dict, cell_name: str, group: str) -> list[dict]:
    """The metrics of `group` ("end_to_end" | "per_layer") that a cell
    reports: those listing it under `workloads`, and those without the key
    (a per-layer one only where the cell reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if group == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def metric_reader(name: str) -> ModuleType:
    return load_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"), f"metric_{name}")


def kernel_patterns() -> dict[str, list[str]]:
    """layer -> the kernel-name substrings of every file under kernel_names/<layer>/."""
    root = os.path.join(BENCH_DIR, "kernel_names")
    out = {}
    for layer in sorted(os.listdir(root)):
        pats = []
        for fn in sorted(os.listdir(os.path.join(root, layer))):
            with open(os.path.join(root, layer, fn)) as f:
                pats += [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
        out[layer] = pats
    return out


def program_config(conf_file: dict, seed: int, root: Optional[str] = None):
    """The program's Config from the configuration file's `program` section
    (every key given), with train.seed (which seeds the synthetic scene)
    and, for a tree, data.root set for this run."""
    from panopticnerf_tpu_torch.config import load_config

    opts = []
    for section, values in conf_file["program"].items():
        if isinstance(values, dict):
            for k, v in values.items():
                opts += [f"{section}.{k}", v]
        else:
            opts += [section, values]
    cfg = load_config(None, opts)
    cfg.train.seed = int(seed)
    if root is not None:
        cfg.data.root = root
    return cfg


def sub_seeds(seed: int) -> dict[str, int]:
    """Independent 32-bit seeds of the scene, the weights, the step draws
    and the checked sample, from the run's seed (any non-negative integer)."""
    words = np.random.SeedSequence(int(seed)).generate_state(4)
    return dict(zip(("scene", "weights", "draws", "sample"), (int(w) for w in words)))


def build_dataset(conf_file: dict, seeds: dict, tmpdir: str, device, sync) -> tuple:
    """Write the configuration's scene (a tree under `tmpdir`, or nothing for
    the program's procedural scene), then the program's `make_dataset`.
    -> (cfg, DeviceDataset, train ids, seconds of both, synchronised)."""
    import time

    from panopticnerf_tpu_torch.data import make_dataset

    from harness.scene import write_demo_tree

    sc = conf_file["scene"]
    t0 = time.perf_counter()
    root = None
    if sc["kind"] == "demo_tree":
        root = os.path.join(tmpdir, "tree")
        cfg = program_config(conf_file, seeds["scene"], root)
        write_demo_tree(root, sc["frames"], tuple(sc["hw"]), sc["boxes"], seeds["scene"],
                        sc["concave"], cfg.data.frame_start, sc["label_noise"],
                        sc["depth_keep"], sc["baseline"], device=device)
    elif sc["kind"] == "synthetic":
        cfg = program_config(conf_file, seeds["scene"])
    else:
        raise ValueError(f"unknown scene kind {sc['kind']!r}")
    ds, train_ids, _ = make_dataset(cfg, device)
    sync()
    return cfg, ds, train_ids, time.perf_counter() - t0


def forbidden_loaded() -> list[str]:
    loaded = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN_MODULES))


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
