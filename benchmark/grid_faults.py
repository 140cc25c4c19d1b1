"""The grid's faults of a hybrid-field render cell (a configuration whose
fields carry a hash grid), on many seeds in one process: the program's own
render with its tables altered after the seeded weights are loaded, every
table zeroed (the grid skipped) and one level's table zeroed (that level's
lookup dropped), each beside the unaltered render, all read against the
reference. `readings.py` gives the control's and its other faults'
readings for the same seeds.

    python benchmark/grid_faults.py --workload kitti360-grid-render --seeds 1,2,3 [--level 0]

Prints one JSON line per seed.
"""

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]


def read_grid_faults(ctx, drv, level: int) -> dict:
    import torch

    s = drv.setup(ctx)
    views = drv.sample_views(ctx["seeds"]["sample"], range(s["n_views"]),
                             ctx["traffic"]["check_views"])
    got = {"program": {v: s["render"](v) for v in views}}
    tables = {n: p for n, p in s["model"].named_parameters() if ".grid.table_" in n}
    if not tables:
        raise SystemExit(f"{ctx['conf']['name']} has no hash grid")
    with torch.no_grad():
        for n, p in tables.items():
            if n.endswith(f".table_{level}"):
                p.zero_()
        got["drop_level"] = {v: s["render"](v) for v in views}
        for p in tables.values():
            p.zero_()
        got["zero_tables"] = {v: s["render"](v) for v in views}
    del s["model"], s["render"], tables
    gc.collect()
    base = drv.reference_side(ctx["conf"]["program"], s, views)
    return {k: drv.gaps(v, base) for k, v in got.items()}


def main(argv=None, device="cuda", overrides=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--level", type=int, default=0, help="the level whose lookup is dropped")
    p.add_argument("--device", default=device)
    args = p.parse_args(argv)

    import torch

    from harness import core

    bench = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, _, conf = core.find_cell(bench, args.workload)
    if overrides:
        conf = core.merged(conf, overrides)
    traffic = core.load_traffic(cell["traffic"])
    if traffic["kind"] != "render":
        raise SystemExit(f"{args.workload} is not a render cell")
    drv = core.driver("render")
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    out = []
    for seed in (int(x) for x in args.seeds.split(",")):
        tmpdir = tempfile.mkdtemp(prefix="bench_", dir=os.environ.get("TMPDIR"))
        try:
            ctx = {"device": args.device, "sync": sync, "seeds": core.sub_seeds(seed),
                   "conf": conf, "traffic": traffic, "tmpdir": tmpdir}
            rec = read_grid_faults(ctx, drv, args.level)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
        rec = {"workload": args.workload, "seed": seed, "level": args.level, **rec}
        print(json.dumps(rec), flush=True)
        out.append(rec)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
