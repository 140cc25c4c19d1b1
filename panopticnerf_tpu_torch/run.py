"""Evaluation / visualisation / throughput entry of the PyTorch port (the
same CLI as the repo's run.py).

    python -m panopticnerf_tpu_torch.run --type evaluate \\
        --cfg_file configs/synthetic_flagship.yaml model_dir artifacts [KEY VALUE ...]
    python -m panopticnerf_tpu_torch.run --type visualize --trajectory 30 --cfg_file ...
    python -m panopticnerf_tpu_torch.run --type visualize --panorama 512,1024 --cfg_file ...
    python -m panopticnerf_tpu_torch.run --type network --cfg_file ...   # throughput probe

evaluate and visualize read a checkpoint under `<model_dir>/torch/`
(engine.checkpoint_path: a trained step, the best with `train.eval_step
-1`, or a converted `<exp_name>_<step>.npz`). Runs on the first CUDA
device by default; `--device cpu` runs the plain versions of the kernels
instead.
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="panopticnerf_tpu_torch runner")
    p.add_argument("--type", type=str, required=True,
                   choices=["evaluate", "visualize", "network"])
    p.add_argument("--cfg_file", type=str, default=None)
    p.add_argument("--panorama", type=str, default=None,
                   help="H,W: also render an equirect panorama from the middle test view "
                        "(visualize only)")
    p.add_argument("--trajectory", type=int, default=0,
                   help="N: also render N smoothly interpolated novel poses "
                        "through the training trajectory (visualize only)")
    p.add_argument("--device", type=str, default="cuda")
    # KEY VALUE overrides may come between flags in any order; a leftover
    # --token is a misspelled flag, not an override key
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
    if args.type == "visualize":
        pano = tuple(int(x) for x in args.panorama.split(",")) if args.panorama else None
        return engine.run_visualize(cfg, args.device, panorama_hw=pano,
                                    trajectory=args.trajectory)
    return getattr(engine, f"run_{args.type}")(cfg, args.device)


if __name__ == "__main__":
    main()
