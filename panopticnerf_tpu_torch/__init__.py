"""panopticnerf_tpu_torch — the PyTorch/CUDA port of panopticnerf_tpu.

The JAX package beside it is the reference this port is held against; the
layout mirrors it module for module. Ported so far: the evaluation render
(`run.py --type evaluate` on the synthetic scene) with the ray x primitive
intersection as a hand-written CUDA kernel (`csrc/intersect.cu`, built with
nvcc on first use). Plain PyTorch versions of every kernel run on CPU
tensors; a CUDA tensor always goes through the kernel.

Layout:
  config/    typed dataclass config tree (same schema and YAMLs as the JAX package)
  data/      synthetic scene, device dataset, KITTI-360 label table
  models/    NeRF field with semantic head (torch.nn)
  ops/       rays, intersection (+ CUDA kernel), encoding, sampling, composite
  render/    volume renderer, tiled full-image path
  eval/      PSNR / mIoU / PQ evaluator and panoptic fusion
  csrc/      CUDA C++ kernel sources
"""

__version__ = "0.1.0"
