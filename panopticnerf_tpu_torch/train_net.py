"""Training entry of the PyTorch port (the same CLI as the repo's train_net.py).

    python -m panopticnerf_tpu_torch.train_net \\
        --cfg_file configs/synthetic_flagship.yaml [KEY VALUE ...]

Trains from a seeded init (or `train.init_from`, or the latest checkpoint
with `train.resume`, the default) and writes checkpoints under
`<model_dir>/torch/<task>/<exp_name>/`, which `python -m
panopticnerf_tpu_torch.run --type evaluate` reads. SIGTERM checkpoints at
the next step boundary and exits with code 0. Runs on the first CUDA device
by default; `--device cpu` runs the plain versions of the kernels instead.
`--max_steps` overrides train.epochs * train.ep_iter.

Data-parallel on N GPUs of one machine, one process per GPU (rank r on
cuda:r; the rays of each step split over the ranks):

    torchrun --standalone --nproc_per_node N -m panopticnerf_tpu_torch.train_net \\
        --cfg_file configs/synthetic_flagship.yaml [KEY VALUE ...]
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="panopticnerf_tpu_torch trainer")
    p.add_argument("--cfg_file", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--max_steps", type=int, default=None)
    args, opts = p.parse_known_args(argv)
    for tok in opts:
        if tok.startswith("--"):
            p.error(f"unrecognized flag {tok!r}")
    args.opts = opts
    return args


def main(argv=None):
    args = parse_args(argv)
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import make_cfg
    from panopticnerf_tpu_torch.parallel import maybe_init_distributed

    world = maybe_init_distributed(args.device)  # before anything touches a card
    try:
        return engine.run_train(make_cfg(args), world.device, max_steps=args.max_steps,
                                world=world)
    finally:
        world.close()


if __name__ == "__main__":
    main()
