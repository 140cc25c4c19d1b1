"""Evaluation entry of the PyTorch port (the same CLI as the repo's run.py).

    python -m panopticnerf_tpu_torch.run --type evaluate \\
        --cfg_file configs/synthetic_flagship.yaml model_dir artifacts [KEY VALUE ...]

Reads the converted checkpoint `<model_dir>/torch/<exp_name>_<step>.npz`
(tools/export_torch_params.py). Runs on the first CUDA device by default;
`--device cpu` runs the plain versions of the kernels instead.
"""

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="panopticnerf_tpu_torch runner")
    p.add_argument("--type", type=str, required=True, choices=["evaluate"])
    p.add_argument("--cfg_file", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
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
    return engine.run_evaluate(cfg, args.device)


if __name__ == "__main__":
    main()
