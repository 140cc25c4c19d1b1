"""The readings that a cell's limits are set from, on many seeds in one
process: for each seed, the numbers that decide `correct` for the
program, for the control (the reference with every product's operands
rounded to float8 e4m3, the precision below the configuration's bf16),
and for the faults the cell can have (the half batch, read from the
reference given the batches' first half; a state left unchanged reads 1
by the change's measure; an answer altered where it is produced).

    python benchmark/readings.py --workload <name> --seeds 1,2,3 [--device cpu]

Prints one JSON line per seed. Training cells need no window: the program
runs its set-up and its first steps, as a run does; render cells render
the views a run would check.
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


def _zero_half(m):
    import torch

    return torch.cat([m[: m.shape[0] // 2], torch.zeros_like(m[m.shape[0] // 2:])])


def read_train(ctx, drv) -> dict:
    s = drv.setup(ctx)
    ref = s["ref"]
    for k in ("model", "state", "one"):
        del s[k]
    gc.collect()
    conf = ctx["conf"]["program"]
    base = drv.reference_side(conf, s)
    n = conf["data"]["n_rays"]
    return {"program": drv.gaps(ref, s["side"], base)[0],
            "control": drv.gaps(ref, drv.reference_side(conf, s, quant=ref.fp8_quant), base)[0],
            "half_batch": drv.gaps(ref, drv.reference_side(conf, s, n_rays=n // 2), base)[0]}


def read_render(ctx, drv) -> dict:
    import torch

    s = drv.setup(ctx)
    views = drv.sample_views(ctx["seeds"]["sample"], range(s["n_views"]),
                             ctx["traffic"]["check_views"])
    got = {v: s["render"](v) for v in views}
    del s["model"], s["render"]
    gc.collect()
    conf = ctx["conf"]["program"]
    base = drv.reference_side(conf, s, views)
    half = {v: [_zero_half(m) for m in maps] for v, maps in got.items()}
    altered = {v: [m[0], m[1], torch.roll(m[2], 1, dims=-1)] for v, m in got.items()}
    return {"program": drv.gaps(got, base),
            "control": drv.gaps(drv.reference_side(conf, s, views, quant=s["ref"].fp8_quant),
                                base),
            "half_batch": drv.gaps(half, base), "alter_answer": drv.gaps(altered, base)}


def main(argv=None, device="cuda", overrides=None, spec=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--device", default=device)
    args = p.parse_args(argv)

    import torch

    from harness import core

    bench = spec or core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, _, conf = core.find_cell(bench, args.workload)
    if overrides:
        conf = core.merged(conf, overrides)
    traffic = core.load_traffic(cell["traffic"])
    drv = core.driver(traffic["kind"])
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    out = []
    for seed in (int(x) for x in args.seeds.split(",")):
        tmpdir = tempfile.mkdtemp(prefix="bench_", dir=os.environ.get("TMPDIR"))
        try:
            ctx = {"device": args.device, "sync": sync, "seeds": core.sub_seeds(seed),
                   "conf": conf, "traffic": traffic, "tmpdir": tmpdir}
            rec = (read_train if traffic["kind"] == "train" else read_render)(ctx, drv)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
        rec = {"workload": args.workload, "seed": seed, **rec}
        print(json.dumps(rec), flush=True)
        out.append(rec)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
