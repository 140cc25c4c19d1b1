"""Ranks of the port's data-parallel CPU tests (tests/test_torch_parallel.py):
`run_ranks` spawns W processes joined over gloo by a file:// rendezvous,
each running one job of this module (which imports no JAX, so a rank
starts in ~1 s), and returns every rank's result. A rank that raises, a
rank that does not finish within the timeout, or any other failure kills
every rank and raises here with each rank's traceback."""

import multiprocessing
import os
import signal
import sys
import time
import traceback

import numpy as np
import torch

GROUP_TIMEOUT_S = 60.0


def run_ranks(tmp, size, job, kwargs, timeout=120.0, poke=None):
    """Run `job(world, **kwargs)` on `size` ranks -> [rank 0's result, ...].
    `poke(procs)` (optional) is called every 20 ms while the ranks run;
    it may signal them."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{os.path.join(tmp, 'rendezvous')}"
    # the arguments go by file: a start() whose pickle exceeds the pipe's buffer
    # waits for that child to read it, and the ranks would start one by one
    torch.save(kwargs, os.path.join(tmp, "kwargs.pt"))
    procs = [ctx.Process(target=_rank_main, args=(init, r, size, job, tmp), daemon=True)
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            bad = [p for p in procs if p.exitcode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            if poke is not None:
                poke(procs)
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    errors = [open(f).read() for r in range(size)
              if os.path.exists(f := os.path.join(tmp, f"rank{r}.err"))]
    codes = [p.exitcode for p in procs]
    if errors or any(c != 0 for c in codes):
        late = " (timed out)" if time.monotonic() > deadline else ""
        raise RuntimeError(f"ranks of {job} failed{late}: exit codes {codes}\n" + "\n".join(errors))
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(size)]


def _rank_main(init, rank, size, job, tmp):
    torch.set_num_threads(1)  # W ranks on the test machine's cores
    # the recorder writes its JSONL without TensorBoard, whose import can take
    # seconds (where it pulls tensorflow) while the other ranks wait
    sys.modules["torch.utils.tensorboard"] = None
    from panopticnerf_tpu_torch.parallel import maybe_init_distributed

    world = None
    try:
        kwargs = torch.load(os.path.join(tmp, "kwargs.pt"), weights_only=False)
        world = maybe_init_distributed("cpu", backend="gloo", init_method=init, rank=rank,
                                       world_size=size, timeout_s=GROUP_TIMEOUT_S)
        result = JOBS[job](world, **kwargs)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)  # the others are killed by the parent, not left in a collective
    if world is not None:
        world.close()


def _state_numpy(model):
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def steps_job(world, cases):
    """Each case: opts, the flax-converted init params, the first step's
    draws (numpy, global) and the number of steps; the later steps draw
    from a generator seeded 1. -> per case, per step: the stats and every
    parameter."""
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data.dataset import BatchDraws
    from panopticnerf_tpu_torch.data.synthetic import build_synthetic_dataset
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.parallel import make_parallel_train_step
    from panopticnerf_tpu_torch.render import RenderDraws
    from panopticnerf_tpu_torch.train import StepDraws, make_train_state

    out = []
    for case in cases:
        cfg = load_config(None, case["opts"])
        model = make_network(cfg, "cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in case["params"].items()})
        state = make_train_state(cfg, model)
        step = make_parallel_train_step(cfg, model, world)
        ds = build_synthetic_dataset(cfg, "cpu", seed=0)
        view_ids = torch.arange(4)
        gen = torch.Generator().manual_seed(1)
        d = {k: torch.from_numpy(v) for k, v in case["draws"].items()}
        first = StepDraws(BatchDraws(d["group"], d["u"], d["v"]),
                          RenderDraws(d.get("coarse"), d.get("bg"), d.get("fine")))
        rows = []
        for i in range(case["steps"]):
            stats = step(state, ds, view_ids, gen, first if i == 0 else None)
            rows.append(({k: float(v) for k, v in stats.items()}, _state_numpy(model)))
        out.append(rows)
    return out


def engine_job(world, root, opts, stream_opts, bad_opts):
    """(c), (d), (e) of the test file on one 2-rank world: a run with saves,
    evaluations, the recorder and the best checkpoint; the same run stopped
    at half and resumed; a streamed run; `run_evaluate`, one view's maps,
    `run_visualize` and `run_network` on the first run's checkpoint; the
    two refusals."""
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config

    quiet = lambda *a: None
    cfg = load_config(None, opts + ["model_dir", f"{root}/straight",
                                    "record_dir", f"{root}/straight_rec"])
    total = cfg.train.max_steps
    straight = engine.run_train(cfg, "cpu", max_steps=total, log=quiet, world=world)
    rcfg = load_config(None, opts + ["model_dir", f"{root}/resumed",
                                     "record_dir", f"{root}/resumed_rec", "train.resume", "true"])
    first = engine.run_train(rcfg, "cpu", max_steps=total // 2, log=quiet, world=world)
    resumed = engine.run_train(rcfg, "cpu", max_steps=total, log=quiet, world=world)
    scfg = load_config(None, stream_opts)
    streamed = engine.run_train(scfg, "cpu", max_steps=scfg.train.max_steps, log=quiet,
                                world=world)

    ev = engine.run_evaluate(cfg, "cpu", log=quiet, world=world)
    ds, _, model, _ = engine._restore_for_eval(cfg, "cpu")
    maps = engine._render_view(cfg, model, ds, 1, world)
    files = engine.run_visualize(cfg, "cpu", log=quiet, panorama_hw=(8, 16), trajectory=2,
                                 world=world)
    network = engine.run_network(cfg, "cpu", log=quiet, world=world)

    refused = []
    for bad in bad_opts:
        try:
            engine.run_train(load_config(None, bad), "cpu", max_steps=1, log=quiet, world=world)
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    pick = lambda res: {"losses": res["losses"], "checkpoint": res["checkpoint"],
                        "steps": res["steps"], "evals": res["evals"],
                        "params": _state_numpy(res["state"].model)}
    return {"straight": pick(straight), "first": pick(first), "resumed": pick(resumed),
            "stream": [(s, np.asarray(ids)) for s, ids in streamed["stream"]["windows"]],
            "evaluate": ev, "maps": [None if x is None else x.numpy() for x in maps],
            "visualize": [os.path.relpath(f, cfg.result_path) for f in files],
            "network": network, "refused": refused}


def sigterm_job(world, opts, log_path):
    """A long run; rank 0 writes its console to `log_path`, where the test
    waits for the first step line before it sends SIGTERM to rank 1."""
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config

    def log(line):
        with open(log_path, "a") as f:
            f.write(line + "\n")

    res = engine.run_train(load_config(None, opts), "cpu", log=log, world=world)
    return {"steps": res["steps"], "preempted": res["preempted"],
            "checkpoint": res["checkpoint"], "losses": res["losses"]}


def sigterm_rank_after_first_log(log_path, rank=1):
    """A `poke` for run_ranks: SIGTERM to `rank` once `log_path` holds a
    step line (once)."""
    sent = []

    def poke(procs):
        if not sent and os.path.exists(log_path) and "\nstep " in "\n" + open(log_path).read():
            os.kill(procs[rank].pid, signal.SIGTERM)
            sent.append(time.monotonic())

    poke.sent = sent
    return poke


JOBS = {"steps": steps_job, "engine": engine_job, "sigterm": sigterm_job}
