"""Training entry of the PyTorch port (the same CLI as the repo's train_net.py).

    python -m panopticnerf_tpu_torch.train_net \\
        --cfg_file configs/synthetic_flagship.yaml [KEY VALUE ...]

Trains from a seeded init and writes `<model_dir>/torch/<exp_name>_<step>.npz`,
which `python -m panopticnerf_tpu_torch.run --type evaluate` reads. Runs on
the first CUDA device by default; `--device cpu` runs the plain versions of
the kernels instead. `--max_steps` overrides train.epochs * train.ep_iter.
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

    cfg = make_cfg(args)
    return engine.run_train(cfg, args.device, max_steps=args.max_steps)


if __name__ == "__main__":
    main()
