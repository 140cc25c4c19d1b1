"""panopticnerf_tpu_torch — the PyTorch/CUDA port of panopticnerf_tpu.

The JAX package beside it is the reference this port is held against; the
layout mirrors it module for module. Ported so far, on the synthetic
scene: the evaluation render (`run.py --type evaluate`) and the training
step (`train_net.py`) in the three field modes of `model.pallas_mode`,
with hand-written CUDA kernels for the ray x primitive intersection
(`csrc/intersect.cu`), the fused trunk's forward and backward
(`csrc/mlp_train.cu`) and the whole field's forward and backward
(`csrc/field_train.cu`), built with nvcc on first use. Plain PyTorch
versions of every kernel run on CPU tensors; a CUDA tensor always goes
through the kernel.

Layout:
  config/    typed dataclass config tree (same schema and YAMLs as the JAX package)
  data/      synthetic scene, device dataset, KITTI-360 label table
  models/    NeRF field with semantic head (torch.nn), fused train adapter (three modes)
  ops/       rays, intersection, fused trunk and field (+ CUDA kernels), encoding,
             sampling, composite
  render/    volume renderer (training and tiled full-image paths)
  train/     losses, train step, optimizer
  eval/      PSNR / mIoU / PQ evaluator and panoptic fusion
  csrc/      CUDA C++ kernel sources
"""

__version__ = "0.1.0"
