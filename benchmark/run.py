"""Run one cell of the port's benchmark once, in this process, and print its
result as the last line of standard output.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With `--trace 0` the line's metrics are the cell's end-to-end metrics; with
`--trace 1` a stretch after the window runs under the profiler and the
metrics are the cell's per-layer ones. The numbers that decide `correct`
are printed beside their limits, as the last lines of standard error and
under the line's last key, "checks". A run that finds no card, or fewer
cards than the cell asks for, prints no result and exits non-zero; so does
one that has loaded JAX or the JAX package by the window's close.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]


def main(argv=None, device=None, fault=None, overrides=None, t0=None, spec=None) -> int:
    """The run; `device`, `fault`, `overrides` (a dict merged into the
    configuration file) and `spec` (in place of BENCHMARK.json) are for the
    benchmark's own tests: the command line sets none of them, and then
    the run needs the card."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a non-negative integer")

    from harness import core

    bench = spec or core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, _, conf = core.find_cell(bench, args.workload)
    traffic = core.load_traffic(cell["traffic"])
    if overrides:
        conf = core.merged(conf, overrides)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = "cuda"
        os.environ.setdefault("TRITON_CACHE_DIR",
                              os.path.join(ROOT, "panopticnerf_tpu_torch", "_build", "triton"))
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    e2e = core.cell_metrics(bench, cell["name"], "end_to_end")
    layer = core.cell_metrics(bench, cell["name"], "per_layer") if args.trace else []
    readers = {m["name"]: core.metric_reader(m["name"]) for m in layer}
    patterns = core.kernel_patterns()
    limits = core.load_json(os.path.join(BENCH_DIR, "limits", f"{cell['name']}.json"))

    tmpdir = tempfile.mkdtemp(prefix="bench_", dir=os.environ.get("TMPDIR"))
    try:
        ctx = {"t0": T0 if t0 is None else t0, "device": device, "sync": sync,
               "seeds": core.sub_seeds(args.seed), "seconds": args.seconds,
               "trace": bool(args.trace), "conf": conf, "traffic": traffic, "tmpdir": tmpdir,
               "patterns": patterns, "fault": fault,
               "required_layers": {lay for r in readers.values() for lay in r.LAYERS}}
        res = core.driver(traffic["kind"]).run(ctx)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    forbidden = res["forbidden"] or core.forbidden_loaded()
    if forbidden:
        print(f"modules of JAX or the JAX package were loaded: {forbidden}", file=sys.stderr)
        return 4
    checks = {k: {"value": v, "limit": limits[k]} for k, v in res["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": cell["chips"], "memory_peak_bytes": int(res["memory_peak_bytes"])}
    breakdown = None
    if args.trace:
        tr = res["trace"]
        lctx = dict(res["layer_ctx"], trace=tr)
        metrics = {}
        for m in layer:
            v = readers[m["name"]].read(lctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_rec.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        rate = res["layer_ctx"]["window"]["units"] / res["layer_ctx"]["window"]["seconds"]
        print(f"traced stretch: {tr['units']} units at {tr['units'] / tr['window_s']!r}/s traced "
              f"on the device, {tr['units'] / tr['host_traced_s']!r}/s traced on the host too, "
              f"against {rate!r}/s in the window; device sessions {tr['attempts']}",
              file=sys.stderr)
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]} for m in e2e}
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(core.result_line(correct, res["attempted"], res["failed"], metrics, device_rec,
                           checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
