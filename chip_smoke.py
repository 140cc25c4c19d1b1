#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: builds its CUDA kernels, holds each
against its plain PyTorch version, runs the port's evaluation of the
committed flagship checkpoint against the JAX package's recorded scores,
replays one recorded JAX training step in each field mode, trains the
flagship through the kernels in each mode, and drives the engine, KITTI-360
demo trees, streaming, the panorama, mixed batches, keep-M, data
parallelism over torchrun ranks, the staged chain, LPIPS, the fusion sweep,
the host tools and the profiling helpers, holds each training mode to the
plain path over many steps, and runs the full-resolution protocol's tree
(376x1408) through the layout checker, a short run, its evaluation and the
export.

    python3 chip_smoke.py          # from the repo root, on a machine with one NVIDIA GPU

Phases (any failure raises; the exit code is then non-zero and no result
line is printed):
  1. card, power limit, torch / CUDA / nvcc versions;
  2. build of csrc/intersect.cu, csrc/mlp_train.cu, csrc/field_train.cu,
     csrc/field_eval.cu, csrc/hash_grid.cu, csrc/composite.cu and csrc/sample.cu, one nvcc
     each, run together (timed; ptxas registers / shared memory / spills; the forward kernels
     B, C and E, C''s heads data pass, V and Z must not spill, nor have ptxas serialize the
     wgmma chains of
     B, C, C''s heads data pass or E at W = 128 and 256);
  3. kernel vs plain version on every synthetic_flagship view
     (N = 33,088 rays, P = 32, K = 16, F = 0) and on a cut-plane case
     (F = 8 seeded half-spaces through each box centre): every output equal
     bit for bit (share of (ray, slot) entries that differ, max |dt| where
     they agree);
  4. median kernel and plain times at the view shape (CUDA events around
     the wrapper call), the kernel's device time (torch.profiler) and the
     wrapper's host time per call, beside the byte bound
     (`intersect_plan_bytes`);
  5. the main path: `engine.run_evaluate` on configs/synthetic_flagship.yaml
     with artifacts/torch/synthetic_flagship_10000.npz — render time per
     view, PSNR / mIoU / PQ beside artifacts/torch/
     synthetic_flagship_10000_jax_eval.json, and the kernels' launch counts:
     A1 once per view rendered, E (the evaluation field), V (the
     compositing) and Z (the sampling) once per tile and level of every
     view; (b) E against its plain version on the
     checkpoint's coarse and fine fields at the points of one view's first
     tile: per output the share of values that differ and the relative
     Frobenius error within EVAL_SHARE / EVAL_REL, a second call equal bit
     for bit; E's time and the plain model's at that tile, beside the
     bound; (c) kernel G (the hash grid, csrc/hash_grid.cu) and E with its
     features on the seeded hybrid fields of configs/torch/kitti360_grid.yaml
     at fine tiles of 4096 and 33,088 rays: G bit for bit against its plain
     encoding, E within EVAL_SHARE / EVAL_REL of its plain version, the
     times of G (and its device time), its plain encoding, E with and
     without the grid's columns and the plain hybrid model, the bounds;
     then GRID_VIEWS 188x704 views of a KITTI-360 demo tree through the
     evaluation entry (`intersect_and_render`) with the counters cleared
     just before: G, E, V and Z each launched 2 x tiles a view, G encoding and E
     evaluating every field point, the maps within a tenth of the cell
     kitti360-grid-render's limits of the plain hybrid model's; (d) kernel V
     (csrc/composite.cu) against the plain compositing ops at the render
     cells' shapes (33,088 rays of a 188x704 demo-tree view, its A1
     intervals, K = 16, the guided depths at S = 64 and 128, seeded field
     outputs with 19 logits): every output within COMPOSITE_W_ABS /
     COMPOSITE_REL, a second call bit for bit, V's and the plain ops' times
     and V's device time beside its bound (its own bytes at HBM's rate);
     (e) kernel Z (csrc/sample.cu) at the render cells' shapes (the same
     tree's view, 33,088 rays, K = 16): the coarse pass (48 + 16) against
     `guided_z`, the fine pass (64 + 64, weights V composites from seeded
     field outputs) against `sample_pdf` + `merge_z`, both bit for bit
     against the plain ops with their sums in Z's order and within
     tests/test_torch_cuda.py's ceilings against the plain ops as they are
     (`tests/torch_sampling_order.against_plain`; rays where the two orders
     place a position in another segment or bin counted apart), a second
     call bit for bit; Z's time (events and device time) and the plain
     chain's, beside Z's bound (its own bytes at HBM's rate);
  6. kernel A2 (grouped intersection) vs its plain version on 20 training
     batches (G = 8 groups of M = 256 rays, K = 16) and on a cut-plane
     case, bit for bit; A2 and plain times, A2's device and host time as
     for A1;
  7. kernels B / B' (fused trunk forward / backward) vs their plain
     versions at N = 131,072 and 262,144 points with the checkpoint's
     coarse and fine trunk weights, on the encodings of real sample points
     of a training batch: max abs and relative Frobenius error of out, dW,
     db, dx; a second B and a second B' call each equal to the first bit
     for bit; kernel and plain times, beside the bound, B's design floor
     (its own I/O and the activations it saves, at HBM's rate) and the byte
     floor of B''s three-pass plan (the data and weight passes' own
     traffic);
  8. kernels C / C' (whole field forward / backward) vs their plain
     versions at the same point counts, weights and encodings: sigma, rgb
     logits, sem, every saved activation, every packed dW / db block, dx
     and dd, with dW in bf16 (mode field) and in float32 (mode hybrid),
     each against its own ceiling; C' with its recompute (as mode hybrid
     runs it) against plain C' on the plain forward's activations, and bit
     for bit against C' on C's; a second C and a second C' call each equal
     to the first bit for bit; kernel and plain times, beside the bound,
     C's design floor, the plan's byte floor (the trunk's data and weight
     passes and the heads' weight pass); the device time of C''s heads
     data pass (torch.profiler) beside its bound (its own operations and
     bytes);
  9. one full-width training step from the checkpoint with the JAX step's
     recorded draws (artifacts/torch/synthetic_flagship_10000_jax_step.*),
     in model.pallas_mode trunk, field and hybrid, each against the JAX
     record of its mode: loss terms, grad_norm, per-leaf gradient cosines,
     first-update signs;
 10. the training main path in each mode: `engine.run_train` from
     `init_params` (seeded) into a temporary model_dir, 100 steps in mode
     trunk, 200 in field, 100 in hybrid: ms/step, rays/s, peak memory,
     falling finite loss, exact launch counts (A2 = steps; trunk: B = B' =
     2 x steps; field: C = C' = 2 x steps; hybrid: C' = 2 x steps; every
     other count, Z's among them, 0); then `run_evaluate` on the checkpoint
     it wrote;
 11. the engine around the step, mode trunk, with train.ep_iter 50,
     save_ep 2, eval_ep 2: (a) a 200-step `run_train` into a temporary
     model_dir: step checkpoints at 100 and 200, in-training evaluations
     at 100 and 200 with finite PSNR / mIoU / PQ, the sidecar's metric
     miou_pq_mean, exact launch counts (A1 = evaluations x evaluated views,
     A2 = 200, B = B' = 400, C = C' = 0), the wall time of the window
     holding a save and an evaluation, of the evaluation and of one save
     alone, and
     `run_evaluate` with train.eval_step -1 on the best step; (b)
     `python -m panopticnerf_tpu_torch.train_net` as a child process,
     SIGTERM after its first log line (exit code 0, "checkpointing at step
     k"), resumed in this process to 200: its losses from k and its final
     parameters equal (a)'s bit for bit; (c) `run --type network` (rays/s
     beside the card's name and power limit) and `run --type visualize
     --trajectory 4` (the files written; A1 launches = test views + 4);
 12. KITTI-360 on a demo tree the port writes itself (`data/demo_tree.py`,
     raycast on the card): (a) one sequence, 16 frames at KITTI-360's
     rectified 376x1408 with 8 boxes and 2 concave buildings cut into
     convex pieces (write time); (b) configs/kitti360_panoptic.yaml at full
     width (8x256 fine, 4x64 coarse, ratio 0.5: 32 views of 188x704, P =
     64, K = 16, F = 8, 2048 rays) with train.pretrain_steps 100:
     `make_dataset` (build time, shapes, real cut planes), A1 vs plain on
     every evaluated view's tables and A2 vs plain on 20 training batches,
     bit for bit, with their times at these shapes; `run_train` for 200
     steps (ms/step, finite loss, lower at the end than just after the
     semantic losses start at step 100, one save and one in-training
     evaluation at 200; launches A2 = 200, B = B' = 200, C = C' = 0, A1 =
     the evaluation's views); `run_evaluate` (finite PSNR / mIoU / PQ,
     A1 = the views with ground truth or held out); the label-transfer
     export (16 + 16 PNGs, A1 = 16), read back by the loader as ground
     truth bit for bit;
 13. streaming, the panorama, mixed batches and keep-M: (a)
     configs/kitti360_360.yaml as shipped (data.stream_window 64, 4096
     rays, both fields 8x256) on two demo sequences (seeds 0 and 1) of 32
     frames with the left fisheye (192 views, 168 for training), cut to
     100 steps, data.stream_refresh_steps 25, train.pretrain_steps 50:
     `train_net` (every refresh, the host seconds each advance() blocked
     and whether its copy was done, every A2 group's view in the resident
     window, fisheye and perspective groups both, launches A2 = 100, B =
     B' = 200, ms/step and peak device memory beside the host pool's and
     one window's bytes); the same seed stopped at 60 and resumed to 100,
     every resident window held against its host slice bit for bit, equal
     to the first run bit for bit; the same run at data.stream_window 0
     (ms/step, peak memory); `run --type evaluate` at stream_window 64 and
     0, equal bit for bit (A1 = views, each fisheye view with its valid
     mask); (b) `run --type visualize --panorama 512,1024` on (a)'s
     checkpoint (A1 = test views + 1, the four panorama files), the
     panorama's A1 bit for bit with its plain version on its 524,288 rays
     (F = 8), its times and the render's seconds, and a 32x64 panorama on
     the card against the CPU within RENDER_GAP; (c) phase 12's config
     with data.views_per_batch 0 for 100 steps (A2 = 0, B = B' = 100, a
     finite falling loss, ms/step beside the grouped run's), 30 steps in
     model.pallas_mode field (A2 = 0, C = C' = 30, B = B' = 0), and
     `intersect_rays_per_ray` on one batch, card against CPU (masks and
     ids equal, depths within PER_RAY_DT); (d) `run_evaluate` of the
     flagship checkpoint with render.eval_keep_samples 96 (PSNR / mIoU /
     PQ and s/view beside phase 5's, A1 = views), 128 (= S) equal to the
     untruncated render bit for bit, and the first 4096 rays of a view on
     the card against the CPU within RENDER_GAP;
 14. data parallelism, each rank a child of this script under `torchrun
     --standalone` (its process group killed after DP_TIMEOUT s): (a)
     `train_net` on one rank over NCCL, 100 trunk steps: every loss and the final
     parameters equal phase 10's bit for bit, ms/step beside phase 10's,
     launches A2 = 100, B = B' = 200; that world's collectives timed and
     `run_evaluate` over it (tiles gathered by NCCL) equal to phase 5 bit
     for bit, A1 = views; (b) two gloo ranks sharing the card, 20 steps in
     mode trunk and 10 in field: the ranks' parameters bit-equal after
     every step, step 1's loss terms within DP_STEP_REL of one process on
     the same batch and each leaf's gradient cosine >= DP_MIN_COSINE,
     launches per rank A2 = steps, B = B' (or C = C') = 2 x steps, ms/step
     and the host-staged gloo collectives timed; (c) a `train_net` rank
     stopped by SIGTERM after its first log line, resumed under torchrun,
     equal to (a) bit for bit; (d) `run_evaluate` on the two gloo ranks
     equal to phase 5 bit for bit, A1 = views on each rank;
 15. the rest of the JAX package: (a) `run_staged --synthesize-tree` (the
     48x64 8-frame demo tree) with model.use_pallas and
     render.use_pallas_intersect on, STAGED_STEPS steps per stage: each
     stage's train and evaluation seconds, ms/step, metrics (finite), the
     warm start logged by stages 2-4, the pretrain gate dropped by the
     gated stages, the semantic stage's 8x256 coarse warned about against
     the panoptic 4x64 one, launches per stage (A2 = steps and A1 =
     evaluated views where render.use_primitives, else 0; B = B' =
     STAGED_B x steps; C = C' = 0), the last stage above STAGED_FLOORS;
     (b) `run_evaluate` of the 10k flagship checkpoint with a seeded
     random-weight LPIPS file: every other score equal to phase 5 bit for
     bit, a finite `lpips`, one view's LPIPS on the card within LPIPS_RTOL
     of the CPU, its ms per view; a truncated file prints "LPIPS disabled"
     and scores as phase 5; (c) `tools.landing_sweep` on (a)'s last
     checkpoint over blends 0-1 x rules match, raw (A1 = GT views: one
     render for ten variants; cache and grid seconds), its row at the
     config's own fusion equal to (a)'s `run_evaluate` to 4 decimals, and
     `tools.pq_analysis` (report.json, one error map per GT view); (d)
     `tools.compute_visible_ids` on a copy of (a)'s tree, read back by the
     loader (the fields that differ from the tree's own files printed),
     and `tools.xview_diag` on (a)'s tree against a tools/corrupt_pseudo.py
     clone, one grid row; (e) `utils.trace()` around three flagship steps
     (a Chrome trace naming A2, B and B''s kernels) and `utils.timed()` on
     one step beside phase 10's ms/step;
 16. the training main path against its plain version over many steps:
     `run_train` from phase 10's seeded init and generator with
     model.use_pallas and render.use_pallas_intersect off, PLAIN_STEPS
     steps (half, then resumed to the end; no kernel launched), its step 1
     equal to a one-step replay of the same init and draws bit for bit;
     then each mode of phase 10 against it over their common steps: each
     loss term's largest relative gap and its mean over the first and the
     last 20 steps, and the parameter drift ||θ_mode - θ_plain|| /
     ||θ_plain - θ0|| (every parameter, the largest and the median leaf),
     each held to a multiple of the same reading between the JAX
     package's plain and Pallas steps (TRAJ_FLOOR_JSON);
 17. the full-resolution protocol (tools/fullres_protocol_torch.py) in
     short: (a) its demo tree at KITTI-360's 376x1408 (8 stereo frames, 16
     boxes and 4 concave buildings: P = 32, F = 8) with the fisheye streams,
     written on the card (write time); (b) `tools.check_data` on it with
     configs/kitti360_panoptic.yaml, the tree's presets and the fisheye
     streams required: exit code 0, every required stream ok, the printed
     report equal to `check_tree`'s; (c) `train_net` on that config with the
     presets (ratio 1.0: 16 views of 529,408 rays) for FULL_STEPS steps
     (the semantic losses on from the half): ms/step, peak device memory,
     launches A2 = steps, B = B' = steps (the 4x64 coarse runs plain), A1 =
     C = C' = 0; `run --type evaluate` at 376x1408 (s/view, peak memory, A1
     = views evaluated); (d) A1 on one full test view (N = 529,408) against
     its plain version bit for bit, their times as in phase 12, beside its
     bound; (e) the label-transfer export (8 + 8 PNGs, A1 = 8), one frame
     read back by the loader bit for bit.
The last two lines are the kernels' JSON (with each kernel's bound on the
card, computed from this run's shapes and the work of the function the TPU
kernel computes) and `{"ok": true, "device": ...}`.
"""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CFG_FILE = os.path.join(REPO, "configs", "synthetic_flagship.yaml")
REF_JSON = os.path.join(REPO, "artifacts", "torch", "synthetic_flagship_10000_jax_eval.json")
STEP_NPZ = os.path.join(REPO, "artifacts", "torch", "synthetic_flagship_10000_jax_step.npz")
STEP_JSON = os.path.join(REPO, "artifacts", "torch", "synthetic_flagship_10000_jax_step.json")
MODES = ("trunk", "field", "hybrid")
KERNEL_SOURCE = "panopticnerf_tpu_torch/csrc/intersect.cu"
KERNEL_REPLACES = "panopticnerf_tpu/ops/pallas_intersect.py:222"
A2_REPLACES = "panopticnerf_tpu/ops/pallas_intersect.py:294"
TRUNK_SOURCE = "panopticnerf_tpu_torch/csrc/mlp_train.cu"
B_REPLACES = "panopticnerf_tpu/ops/pallas_mlp_train.py:186"
B2_REPLACES = "panopticnerf_tpu/ops/pallas_mlp_train.py:217"
FIELD_SOURCE = "panopticnerf_tpu_torch/csrc/field_train.cu"
EVAL_SOURCE = "panopticnerf_tpu_torch/csrc/field_eval.cu"
EVAL_REPLACES = "none: the JAX package renders the evaluation field with plain XLA ops"
GRID_SOURCE = "panopticnerf_tpu_torch/csrc/hash_grid.cu"
GRID_REPLACES = "none: the JAX package has no hash grid (PanopticNeRF-360's hybrid field)"
GRID_CFG_FILE = os.path.join(REPO, "configs", "torch", "kitti360_grid.yaml")
GRID_VIEWS = 2            # phase 5 (c): hybrid views through the evaluation entry
# phase 5 (c): a tenth of benchmark/limits/kitti360-grid-render.json (mean |rgb
# gap|, relative mean |gap| of depth and of the semantic logits)
GRID_VIEW_GAP = (1e-5, 5e-6, 3e-4)
COMPOSITE_SOURCE = "panopticnerf_tpu_torch/csrc/composite.cu"
COMPOSITE_REPLACES = "none: the JAX package composites with plain XLA ops"
# phase 5 (d): V against the plain ops (tests/test_torch_cuda.py's ceilings: only
# the order of the sums differs): a weight's largest |gap|, a map's relative
# Frobenius error
COMPOSITE_W_ABS, COMPOSITE_REL = 1e-6, 1e-5
SAMPLE_SOURCE = "panopticnerf_tpu_torch/csrc/sample.cu"
SAMPLE_REPLACES = "none: the JAX package samples with plain XLA ops"
# phase 5 (e): rays where the two orders of the sums place a position in another
# segment (coarse) or bin (fine), as shares of the rays (tests/test_torch_cuda.py's)
SAMPLE_FLIPS = (0.01, 0.05)
C_REPLACES = "panopticnerf_tpu/ops/pallas_field_train.py:310"
C2_REPLACES = "panopticnerf_tpu/ops/pallas_field_train.py:345"
PEAK_BF16 = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12          # float32 outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3 bytes/s
TOL = {"psnr": 0.1, "miou": 0.005, "pq": 0.01}  # vs the JAX reference
# B / B' vs plain, relative Frobenius error: summation order differs on the
# card, so bf16 roundings of activations, g and dW flip in places (measured
# at most 8.0e-4, dW of the fine trunk; NVIDIA H100 80GB HBM3, 700 W).
MAX_TRUNK_REL = 2e-3
# one step vs the JAX record, where bf16 roundings flip between the packages
# (measured: loss terms <= 6.6e-4, grad_norm 4.4e-3, min cosine 0.9993,
# update signs 0.9959 on the same card)
STEP_REL = 1e-2           # loss terms and grad_norm, relative
MIN_COSINE = 0.995        # per-leaf gradient cosine
MIN_SIGN_SHARE = 0.99     # entries whose first Adam update has JAX's sign
# C / C' vs plain, relative Frobenius error, per output, from the readings
# at both N (NVIDIA H100 80GB HBM3, 700 W) with room on both sides. sigma
# and the sums behind sem, dd and every db stay f32 in both versions (read
# at most 1.1e-4, 4.5e-4, 2.1e-5, 2.2e-4): a kernel that rounded them to
# bf16 would read ~1e-3 and fail. The rgb logits carry the bf16 flips of r
# (read 1.1e-3); the bf16 outputs (saved activations, dx) flip in places
# (read at most 5.6e-4); dW read 1.07e-3 stored as bf16 and 3.4e-4 as
# float32, where a bf16 rounding (mode hybrid must not round) reads ~1e-3.
# "rec": C' with its own recompute against plain C' on the plain forward's
# activations, where the two forwards' bf16 flips move ReLU masks of the
# colour branch (read at most 1.03e-2, dW of the colour hidden layer at
# N = 131,072); a wrong op reads ~1e-1 or more. That C' equals C' on C's
# activations bit for bit, so the ceilings above hold it as well.
FIELD_REL = {"sigma": 5e-4, "sem": 8e-4, "rgb": 3e-3, "dd": 5e-4, "db": 5e-4,
             "bf16 out": 2e-3, "dW bf16": 3e-3, "dW f32": 7e-4, "rec": 3e-2}
# E vs its plain version (cuBLAS's reduced-precision reductions off), per
# output: the share of values that differ and the relative Frobenius error
# (tests/test_torch_cuda.py's ceilings, where they are justified: one-ulp
# flips of bf16 roundings summed in another order)
EVAL_SHARE, EVAL_REL = 2e-3, 6e-4
TRAIN_STEPS = {"trunk": 100, "field": 200, "hybrid": 100}
ENGINE_STEPS = 200
ENGINE_OPTS = ["train.ep_iter", "50", "train.save_ep", "2", "train.eval_ep", "2"]
KITTI_CFG = os.path.join(REPO, "configs", "kitti360_panoptic.yaml")
K360_CFG = os.path.join(REPO, "configs", "kitti360_360.yaml")
KITTI_HW = (376, 1408)    # KITTI-360's rectified image size
KITTI_FRAMES, KITTI_STEPS = 16, 200
# phase 13 (a): frames per sequence (of the config's 64), steps, and the cuts
# of data.stream_refresh_steps (500) and train.pretrain_steps (20000) that
# give 3 refreshes with the semantic losses on
K360_FRAMES, K360_STEPS, K360_REFRESH, K360_PRETRAIN = 32, 100, 25, 50
PANO_HW = (512, 1024)
MIXED_STEPS, MIXED_FIELD_STEPS = 100, 30
KEEP_M = 96
# a render on the card against the same render on the CPU (plain versions):
# bf16 products accumulate in another order, so ReLU masks and, under
# keep-M, near-tied coarse weights can flip; a wrong op moves most rays
RENDER_GAP = {"rgb max": 0.1, "rgb mean": 2e-3, "depth": 2e-2, "agree": 0.99}
# the per-ray intersection's depths, card against the CPU: the same float32
# ops; a few ulps of a depth up to render.far = 120 m
PER_RAY_DT = 1e-4
# f32 operations of one cut plane on a (ray, primitive) pair: the plane's
# normal against the local origin and direction (two 3-term dot products),
# the crossing depth (a subtraction and a division) and the clip (~2); an
# estimate, like SLAB_OPS
PLANE_OPS = 13
# phase 14: two gloo ranks sharing the card, steps per field mode; step 1 of
# the two ranks against one process on the same batch: the loss terms are
# sums of the same per-ray values in two halves (float32 rounding), the
# gradients sums of bf16-rounded partial products in another split
DP_GLOO_STEPS = {"trunk": 20, "field": 10}
DP_STEP_REL = 1e-6
DP_MIN_COSINE = 0.9999
DP_TIMEOUT = 300          # seconds for each torchrun child (killed after)

STAGED_STEPS = 300        # phase 15 (a): steps per stage (the 2000-step chain runs apart)
# tests/test_staged_quality.py's floors for the last stage
STAGED_FLOORS = {"psnr": 14.0, "miou": 0.80, "pq": 0.55}
# the stages whose config has an in-run pretrain gate, which the chain drops
STAGED_GATED = {"kitti360_semantic", "kitti360_panoptic"}
# kernel B / B' calls per step of each stage (model.use_pallas): one per
# field of 8x256; kitti360_panoptic's 4x64 coarse runs plain
STAGED_B = {"kitti360_rgb_coarse": 1, "kitti360_hierarchical_depth": 2, "kitti360_semantic": 1,
            "kitti360_panoptic": 1}
# one view's LPIPS on the card against the CPU, relative: float32
# convolutions (cuDNN with TF32 off against oneDNN) that sum in other orders
LPIPS_RTOL = 1e-4
# phase 16: the plain path (model.use_pallas and render.use_pallas_intersect
# off) from phase 10's seeded init and draws, against each kernel mode's run
# over their common steps. Each reading's ceiling is a multiple of the same
# reading of the floor at the same steps: the JAX package's own plain and
# Pallas steps of this config from flax's seeded init, which differ only
# where they round in bf16 (tools/export_torch_train_trajectory.py, 200
# steps on the CPU). TRAJ_MULTIPLE holds what rounding moves smoothly: the
# drift over every parameter, the median leaf's and the first 20 steps' mean
# gap of each loss term; correct pairs on the CPU (the port against JAX, the
# port's trunk against its plain) read at most 1.31x the floor on these at
# 2048 rays. TRAJ_LATE_MULTIPLE holds what single steps and leaves dominate:
# one step's largest gap, the last 20 steps' mean gap and the largest leaf's
# drift; correct pairs on the CPU read up to 5.7x the floor's mean of the
# same 20 steps (256 rays, 100 steps), and the floor's own 20-step means
# double within 10-20 steps around step 100. Read on the card (NVIDIA H100
# 80GB HBM3, 700.00 W): drift 0.86x / 1.10x / 0.82x the floor (trunk at 100,
# field at 200, hybrid at 100 steps), first-20 gaps at most 1.1x, last-20
# gaps at most 3.5x (hybrid, loss_sem_fix2d), largest gaps at most 3.5x
# (hybrid, loss_sem2d); a wrong op moves the first steps and the drift
PLAIN_STEPS = 200
TRAJ_FLOOR_JSON = os.path.join(REPO, "artifacts", "torch",
                               "synthetic_flagship_jax_trajectory_floor.json")
TRAJ_MULTIPLE = 2.0
TRAJ_LATE_MULTIPLE = 6.0
# profiler sessions that device_ms and phase 15 (e) make before they give up
# on a kernel the profiler did not record
PROFILE_ATTEMPTS = 3
# phase 17: the demo tree of the full-resolution protocol
# (tools/fullres_protocol_torch.py: 8 stereo frames, 16 boxes, 4 concave
# buildings, with fisheye) and the steps of its short run
FULL_FRAMES, FULL_BOXES, FULL_CONCAVE = 8, 16, 4
FULL_STEPS = 100


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def compare(out, ref):
    """-> (entries, differing entries, max |dt| over agreeing hit entries)."""
    agree = ((out.mask == ref.mask) & (out.semantic == ref.semantic)
             & (out.instance == ref.instance))
    both = agree & out.mask
    dt = 0.0
    if bool(both.any()):
        dt = max(float((out.t_in - ref.t_in).abs()[both].max()),
                 float((out.t_out - ref.t_out).abs()[both].max()))
    return agree.numel(), int((~agree).sum()), dt


def cut_planes(p, f, seed):
    """(P, F, 4) half-spaces n.x <= 0 through each box centre (the local
    origin), with normals turned so that every box keeps a non-empty cone."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(p, 1, 3))
    n = rng.normal(size=(p, f, 3))
    n = np.where((n * axis).sum(-1, keepdims=True) > 0, -n, n)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.ascontiguousarray(np.concatenate([n, np.zeros((p, f, 1))], -1), np.float32)


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, name, reps=5, warmup=1, attempts=PROFILE_ATTEMPTS):
    """Device time per call (ms) of the CUDA kernels whose name contains
    `name` inside fn(), from torch.profiler over `reps` calls. CUPTI now and
    then hands the profiler none of a session's kernel records (seen once
    on the H100, for A2 after many sessions in one process): a session that
    saw none is profiled again, up to `attempts` sessions in all."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages() if name in e.key)
        if us > 0:
            break
        print(f"  the profiler saw no device time of {name} (session {attempt} of {attempts})")
    check(us > 0, f"the profiler saw no device time of {name} in {attempts} sessions")
    return us / reps / 1e3


def host_ms(fn, reps=50):
    """Median host time (ms) of one call of fn, nothing synchronised inside
    the timed span (the wrapper's checks, allocations and launch)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return float(np.median(times))


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def nbytes(*tensors):
    """Bytes of the tensors (nested tuples and None allowed)."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def bound(flops, moved, peak=PEAK_BF16):
    """(ms, "operations" | "bytes"): the least time the card could take, the
    larger of flops over the peak rate for their type and the bytes moved
    (each input read once, each output written once) over HBM's rate."""
    t_ops, t_bytes = 1e3 * flops / peak, 1e3 * moved / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def trunk_shapes(x_dim, width, layers, skips):
    """(in, out) of each trunk layer, unpadded (skips in the kernel convention)."""
    return [(x_dim if i == 0 else width + (x_dim if i in skips else 0), width)
            for i in range(layers)]


def field_shapes(dims):
    """(in, out) of every Dense of the whole field, unpadded: the trunk, the
    head block [sem_hidden | sigma | feature], the colour branch, sem_out."""
    w = dims.width
    shapes = trunk_shapes(dims.x_dim, w, dims.layers, dims.skips)
    shapes += [(w + dims.grid_dim, (dims.sem_hidden if dims.use_sem else 0) + 1 + w),
               (w + dims.d_dim, dims.color_width), (dims.color_width, 3)]
    return shapes + ([(dims.sem_hidden, dims.num_classes)] if dims.use_sem else [])


def dense_bound(npts, shapes, point_bytes, backward=False, dw_bytes=2):
    """bound() of the function a TPU kernel computes over a chain of bf16
    Dense layers (`shapes`, unpadded), from its own work and I/O: 2 x in x
    out tensor-core operations per point forward, twice that backward (dW
    and g W^T, no recompute); `point_bytes` per point of inputs and outputs,
    plus the bf16 weights read, and the f32 biases read (forward) or dW
    (`dw_bytes` each) and the f32 db written (backward). What the port's
    design adds (padding, saved activations) is not the function's work."""
    macs = sum(i * o for i, o in shapes)
    biases = sum(o for _, o in shapes)
    params = 2 * macs + (dw_bytes * macs + 4 * biases if backward else 4 * biases)
    return bound((4.0 if backward else 2.0) * npts * macs, npts * point_bytes + params)


def field_ceiling(name):
    """FIELD_REL's ceiling for an output of field_phase ('sigma', 'dx/bf16',
    'dwp/f32', 'dhb/rec', ...)."""
    out, _, tag = name.partition("/")
    if tag == "rec":
        return FIELD_REL["rec"]
    if out in ("sigma", "sem", "rgb", "dd"):
        return FIELD_REL[out]
    if out in ("dbp", "dhb", "dbso", "dbch", "dbco"):
        return FIELD_REL["db"]
    if out in ("dwp", "dhw", "dwso", "dwch", "dwco"):
        return FIELD_REL["dW bf16" if tag == "bf16" else "dW f32"]
    return FIELD_REL["bf16 out"]  # saved activations, dx


# f32 operations of one (ray, primitive) slab test: the affine transform of
# the ray (33), three slabs (21), the interval (4) and the top-K insertion
# (~16 compares); an estimate, far below the bytes the intersection writes.
SLAB_OPS = 75


def ptxas_summary(log_path):
    """'kernel: R registers, static smem S B, spills' lines from nvcc's
    -Xptxas -v log (the kernels' dynamic shared memory is set at launch)."""
    out, name, spills = [], None, ""
    for line in open(log_path):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+((?:trunk|field|reduce|wgrad)_[a-z_]+?)(?:ILi(\d+)E|I|E)",
                          m.group(1))
            name = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")) if k else m.group(1)
            name += ", grid" if k and "Lb1E" in m.group(1) else ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, static smem {m.group(2) or 0} B, {spills}")
    return out


def a2_phase(cfg, ds, train_ids, dev, intersect_cuda):
    """Kernel A2 vs plain on 20 training batches (+ a cut-plane case)."""
    from panopticnerf_tpu_torch.data.dataset import sample_ray_batch
    from panopticnerf_tpu_torch.ops.intersect import Primitives, intersect_groups_plain
    from panopticnerf_tpu_torch.ops.intersect_cuda import intersect_plan_bytes

    near, far, k = cfg.render.near, cfg.render.far, cfg.data.max_intervals
    g, n = cfg.data.views_per_batch, cfg.data.n_rays
    view_ids = torch.as_tensor(train_ids, device=dev)
    gen = torch.Generator(dev).manual_seed(1234)
    max_dt = 0.0

    def grouped(batch):
        gv = batch.view.reshape(g, n // g)[:, 0]
        prims = Primitives(ds.prim_w2p[gv], ds.prim_sem[gv], ds.prim_inst[gv],
                           ds.prim_valid[gv], None)
        return batch.rays_o.reshape(g, n // g, 3), batch.rays_d.reshape(g, n // g, 3), prims

    for case, f in (("F=0", 0), ("F=8", 8)):
        total = bad = hits = 0
        same = True
        for b in range(20 if f == 0 else 4):
            ro, rd, prims = grouped(sample_ray_batch(ds, view_ids, n, g, gen))
            if f:
                p = prims.world_to_prim.shape[1]
                prims = prims._replace(cut_planes=torch.from_numpy(np.stack(
                    [cut_planes(p, f, 100 * b + i) for i in range(g)])).to(dev))
            out = intersect_cuda.intersect_groups_cuda(ro, rd, prims, near, far, k)
            ref = intersect_groups_plain(ro, rd, prims, near, far, k)
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, b) for a, b in zip(out, ref))
            nn_, nb, dt = compare(out, ref)
            total, bad, max_dt = total + nn_, bad + nb, max(max_dt, dt)
            hits += int(out.mask.sum())
        share = bad / total
        print(f"A2 vs plain, {case}: {20 if f == 0 else 4} training batches x G={g} x "
              f"M={n // g} x K={k}: {bad} of {total} entries differ ({share:.2e}), max |dt| "
              f"where they agree {max_dt:.3e} ({hits} hit slots); bit for bit: {same}")
        check(same, f"A2 {case}: the kernel differs from its plain version")
    ro, rd, prims = grouped(sample_ray_batch(ds, view_ids, n, g, gen))
    run_k = lambda: intersect_cuda.intersect_groups_cuda(ro, rd, prims, near, far, k)
    run_p = lambda: intersect_groups_plain(ro, rd, prims, near, far, k)
    plain_ms, kernel_ms = time_ms(run_p), time_ms(run_k)
    plain_ms2, kernel_ms2 = time_ms(run_p), time_ms(run_k)
    dev_ms, wrap_ms = device_ms(run_k, "intersect_kernel", reps=20), host_ms(run_k)
    p = prims.world_to_prim.shape[1]
    bnd = bound(n * p * SLAB_OPS, intersect_plan_bytes(g, n // g, p, 0, k), PEAK_F32)
    print(f"A2 at G={g}, M={n // g}, K={k}: kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms, "
          f"plain {plain_ms:.4f} / {plain_ms2:.4f} ms (events around the call, median of 20, "
          f"plain-kernel-plain-kernel); device time {dev_ms:.5f} ms (torch.profiler, mean of "
          f"20), the wrapper's host time {wrap_ms:.4f} ms per call; bound {bnd[0]:.5f} ms "
          f"({bnd[1]})")
    return max_dt, kernel_ms, plain_ms, bnd


def sample_encodings(cfg, ds, train_ids, model, dev):
    """x_enc and d_enc (bf16) of the coarse and fine sample points of one
    training batch rendered with the checkpoint: {field: (x_enc, d_enc)},
    131,072 and 262,144 points at the flagship."""
    from panopticnerf_tpu_torch.data.dataset import batch_intervals, sample_ray_batch
    from panopticnerf_tpu_torch.ops.encoding import positional_encoding
    from panopticnerf_tpu_torch.render import SceneBounds, render_rays

    g, n = cfg.data.views_per_batch, cfg.data.n_rays
    gen = torch.Generator(dev).manual_seed(99)
    batch = sample_ray_batch(ds, torch.as_tensor(train_ids, device=dev), n, g, gen)
    iv = batch_intervals(ds, batch, cfg.render.near, cfg.render.far, cfg.data.max_intervals, g)
    with torch.no_grad():
        out = render_rays(model, batch.rays_o, batch.rays_d,
                          SceneBounds(ds.bounds_center, ds.bounds_scale), cfg, iv=iv,
                          train=True, generator=gen)
    enc = {}
    for field, z in (("coarse", out.coarse.z), ("fine", out.z)):
        pts = batch.rays_o[:, None] + batch.rays_d[:, None] * z[..., None]
        pts = (pts - ds.bounds_center) * ds.bounds_scale
        dirs = torch.broadcast_to(batch.rays_d[:, None], pts.shape)
        enc[field] = tuple(
            positional_encoding(v.reshape(-1, 3), f).to(torch.bfloat16)
            for v, f in ((pts, cfg.model.xyz_freqs), (dirs, cfg.model.dir_freqs)))
    return enc


def kernel_skips(cfg):
    return tuple(s + 1 for s in cfg.model.skips if s + 1 < cfg.model.trunk_depth)


def trunk_phase(cfg, enc, model, dev):
    """Kernels B / B' vs plain at the step's point counts, with the
    checkpoint's trunk weights on the encodings of real sample points."""
    from panopticnerf_tpu_torch.ops import mlp_train as mt
    from panopticnerf_tpu_torch.ops.mlp_train_cuda import (
        backward_plan_bytes,
        forward_plan_bytes,
        trunk_backward_cuda,
        trunk_forward_cuda,
    )

    gen = torch.Generator(dev).manual_seed(5)
    res = {}
    for field, (x_enc, _) in enc.items():
        net = getattr(model, field)
        layers = [getattr(net, f"trunk_{i}") for i in range(cfg.model.trunk_depth)]
        skips = kernel_skips(cfg)
        wp, bp = mt.pack_trunk([m.weight.t() for m in layers], [m.bias for m in layers],
                               skips, torch.bfloat16)
        xp = mt.pad_x(x_enc)
        npts = xp.shape[0]
        gout = torch.randn((npts, wp.shape[-1]), generator=gen, device=dev) * 1e-3
        acts = trunk_forward_cuda(xp, wp, bp, skips)
        same_fwd = torch.equal(acts, trunk_forward_cuda(xp, wp, bp, skips))
        acts_ref = mt.trunk_forward_plain(xp, wp, bp, skips)
        got = trunk_backward_cuda(xp, acts, gout, wp, skips)
        again = trunk_backward_cuda(xp, acts, gout, wp, skips)
        ref = mt.trunk_backward_plain(xp, acts, gout, wp, skips)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        check(same_fwd, f"B {field} N={npts}: a second call differs from the first")
        check(same, f"B' {field} N={npts}: a second call differs from the first")
        errs = {"out": (acts[-1], acts_ref[-1]), "dW": (got[1], ref[1]),
                "db": (got[2], ref[2]), "dx": (got[0], ref[0])}
        line = []
        for name, (a, b) in errs.items():
            check(bool(torch.isfinite(a.float()).all()), f"B/B' {field}: non-finite {name}")
            r, m = rel_err(a, b), float((a.float() - b.float()).abs().max())
            line.append(f"{name} max|d| {m:.3e} rel {r:.3e}")
            check(r <= MAX_TRUNK_REL, f"B/B' {field} N={npts}: {name} rel err {r} > {MAX_TRUNK_REL}")
            res[(field, name)] = (m, r)
        t = {}
        t["fwd_plain"] = time_ms(lambda: mt.trunk_forward_plain(xp, wp, bp, skips), reps=5, warmup=1)
        t["fwd"] = time_ms(lambda: trunk_forward_cuda(xp, wp, bp, skips), reps=5, warmup=1)
        t["bwd_plain"] = time_ms(lambda: mt.trunk_backward_plain(xp, acts, gout, wp, skips), reps=5, warmup=1)
        t["bwd"] = time_ms(lambda: trunk_backward_cuda(xp, acts, gout, wp, skips), reps=5, warmup=1)
        t["fwd2"] = time_ms(lambda: trunk_forward_cuda(xp, wp, bp, skips), reps=5, warmup=1)
        t["fwd_plain2"] = time_ms(lambda: mt.trunk_forward_plain(xp, wp, bp, skips), reps=5, warmup=1)
        t["bwd2"] = time_ms(lambda: trunk_backward_cuda(xp, acts, gout, wp, skips), reps=5, warmup=1)
        t["bwd_plain2"] = time_ms(lambda: mt.trunk_backward_plain(xp, acts, gout, wp, skips), reps=5, warmup=1)
        # the TPU function's own work: x_enc (bf16) -> the last activation
        # (bf16); backward x_enc and the f32 upstream g -> dx, dW, db
        width, x_dim = wp.shape[-1], x_enc.shape[1]
        shapes = trunk_shapes(x_dim, width, wp.shape[0], skips)
        t["fwd_bound"] = dense_bound(npts, shapes, 2 * x_dim + 2 * width)
        t["bwd_bound"] = dense_bound(npts, shapes, 4 * x_dim + 4 * width, backward=True)
        floor = [1e3 * b / PEAK_BYTES for b in backward_plan_bytes(npts, width, wp.shape[0], skips)]
        t["fwd_floor"] = 1e3 * forward_plan_bytes(npts, width, wp.shape[0]) / PEAK_BYTES
        res[(field, "t")] = t
        print(f"B/B' vs plain, {field} trunk, N={npts}: " + "; ".join(line)
              + f"; a second B call equals the first bit for bit: {same_fwd}, a second B' call:"
              f" {same}")
        print(f"  times (ms, median of 5, plain-kernel-kernel-plain): B {t['fwd']:.3f} / "
              f"{t['fwd2']:.3f}, plain {t['fwd_plain']:.3f} / {t['fwd_plain2']:.3f}; "
              f"B' {t['bwd']:.3f} / {t['bwd2']:.3f}, plain {t['bwd_plain']:.3f} / "
              f"{t['bwd_plain2']:.3f}; bounds B {t['fwd_bound'][0]:.3f} ({t['fwd_bound'][1]}), "
              f"B's design floor {t['fwd_floor']:.3f} (bytes: x_enc, the saved activations, "
              f"the weights), "
              f"B' {t['bwd_bound'][0]:.3f} ({t['bwd_bound'][1]}); byte floor of B''s three-pass "
              f"plan {floor[0]:.3f} (data pass) + {floor[1]:.3f} (weight pass) ms; "
              f"B writes every layer's "
              f"activation, {nbytes(acts) / 1e9:.3f} GB ({1e3 * nbytes(acts) / PEAK_BYTES:.3f} "
              f"ms at HBM's rate; the function writes the last only)")
        del acts, acts_ref, got, again, ref
    return res


def eval_field_phase(cfg, ds, model):
    """5 (b): kernel E against its plain version on the checkpoint's fields
    at the points of view 0's first tile, each level (see the module
    docstring). -> {level: {"err", "ms", "plain_ms", "bound"}}."""
    from panopticnerf_tpu_torch.data import view_primitives, view_rays
    from panopticnerf_tpu_torch.ops.field_eval import field_eval_plain
    from panopticnerf_tpu_torch.ops.field_eval_cuda import EvalKernel
    from panopticnerf_tpu_torch.ops.intersect import intersect_rays
    from panopticnerf_tpu_torch.render import SceneBounds, render_image_rays

    calls, real = [], EvalKernel.__call__

    def capture(kernel, pts, dirs, samples, grid=None):  # the points and packed field E gets
        calls.append((pts, dirs, samples, kernel.pk, kernel.dims))
        return real(kernel, pts, dirs, samples, grid)

    EvalKernel.__call__ = capture
    try:
        o, d = (t[:cfg.render.ray_tile] for t in view_rays(ds, 0))
        iv = intersect_rays(o, d, view_primitives(ds, 0), cfg.render.near, cfg.render.far,
                            cfg.data.max_intervals)
        render_image_rays(model, o, d, SceneBounds(ds.bounds_center, ds.bounds_scale), cfg, iv=iv)
    finally:
        EvalKernel.__call__ = real
    check(len(calls) == 2, f"the tile's render called E {len(calls)} times, expected 2")
    result = {}
    for level, net, (pts, dirs, s, pk, dims) in zip(("coarse", "fine"), (model.coarse, model.fine),
                                                     calls):
        kernel = EvalKernel(pk, dims, pts.device)
        run = lambda: kernel(pts, dirs, s)
        got, again = run(), run()
        matmul = torch.backends.cuda.matmul
        reduced, matmul.allow_bf16_reduced_precision_reduction = (
            matmul.allow_bf16_reduced_precision_reduction, False)
        ref = field_eval_plain(pts, dirs, s, pk, dims)  # each product rounded once, as E's
        torch.cuda.synchronize()
        matmul.allow_bf16_reduced_precision_reduction = reduced
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        shares = {k: float((a != b).float().mean()) for k, a, b in zip(("sigma", "rgb", "sem"), got,
                                                                       ref)}
        rels = {k: rel_err(a, b) for k, a, b in zip(("sigma", "rgb", "sem"), got, ref)}
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        plain = lambda: net(pts.view(-1, s, 3), dirs[:, None, :])
        ms, plain_ms = time_ms(run), time_ms(plain, reps=5)
        ms2, plain_ms2 = time_ms(run), time_ms(plain, reps=5)
        n = pts.shape[0]
        bnd = bound(2.0 * n * sum(i * o for i, o in field_shapes(dims)),
                    nbytes(pts, dirs, got, *[t for t in pk if t is not None]))
        print(f"eval field (b), {level}: E against its plain version at view 0's first tile "
              f"({n} points, {s} a ray): share of values that differ "
              + ", ".join(f"{k} {v:.2e}" for k, v in shares.items())
              + "; relative Frobenius error " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
              + f" (ceilings {EVAL_SHARE} / {EVAL_REL}); max |d| {err:.3e}; a second call bit for "
              f"bit: {same}; E {ms:.4f} / {ms2:.4f} ms, plain model {plain_ms:.4f} / "
              f"{plain_ms2:.4f} ms (events around the call, medians); bound {bnd[0]:.4f} ms "
              f"({bnd[1]})")
        check(same, f"E ({level}): a second call differs")
        check(all(v <= EVAL_SHARE for v in shares.values())
              and all(v <= EVAL_REL for v in rels.values()),
              f"E ({level}) off its plain version: {shares} {rels}")
        result[level] = {"err": err, "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
                         "bound": bnd}
    return result


def grid_points(rays, samples, dev, seed):
    """Sample points as a render makes them: `samples` sorted depths on each
    of `rays` rays from origins near the scene's centre, scene-normalised
    (some outside the unit cube, which take its border cells)."""
    g = torch.Generator(dev).manual_seed(seed)
    o = (torch.rand(rays, 1, 3, device=dev, generator=g) * 2 - 1) * 0.3
    d = torch.nn.functional.normalize(torch.randn(rays, 1, 3, device=dev, generator=g), dim=-1)
    t = torch.rand(rays, samples, 1, device=dev, generator=g).sort(dim=1).values * 1.5
    return (o + d * t).reshape(-1, 3).contiguous(), d[:, 0].contiguous()


def grid_phase(dev):
    """5 (c): kernel G and E with the grid's features, on the hybrid fields of
    configs/torch/kitti360_grid.yaml (8x256 fine, 4x64 coarse, each with 16 levels
    of 2 features, tables of 2^19 rows; seeded, tables uniform in +-1) at a
    fine tile of the shipped tile (4096 rays x 128 samples), and at the
    benchmark's tile (33,088 rays) for both levels: G bit for bit against
    the plain encoding; E with features against its plain version (share /
    relative error within EVAL_SHARE / EVAL_REL); the times of G, of its
    plain encoding, of E with features, of E without (the same field
    without the grid's columns) and of the plain hybrid model; G's device
    time; G's bound (its own I/O, 12 bytes in and 64 out a point, at HBM's
    rate, against ~60 f32 operations a point and level at the f32 peak) and
    E's; the 128-byte lines and 32-byte sectors a point G's warp loads touch
    over the 16 levels (`gather_footprint`), one thread a point against G's
    lane pairs. -> {"G": ..., "E": ...} at the benchmark's fine tile."""
    import dataclasses

    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.models.nerf import NeRFMLP, coarse_field_cfg
    from panopticnerf_tpu_torch.ops.field_eval import eval_dims, field_eval_plain, pack_eval
    from panopticnerf_tpu_torch.ops.field_eval_cuda import EvalKernel
    from panopticnerf_tpu_torch.ops.hash_grid import GRID, hash_grid_encode
    from panopticnerf_tpu_torch.ops.hash_grid_cuda import GridKernel, gather_footprint
    from panopticnerf_tpu_torch.utils.profiling import calls

    fine_cfg = load_config(GRID_CFG_FILE).model
    out = {}
    for level, rays, s in (("fine", 4096, 128), ("fine", 33088, 128), ("coarse", 33088, 64)):
        cfg = fine_cfg if level == "fine" else coarse_field_cfg(fine_cfg, True)
        torch.manual_seed(0)
        net = NeRFMLP(cfg).to(dev)
        gen = torch.Generator(dev).manual_seed(0)
        with torch.no_grad():
            for name, p in net.named_parameters():
                if ".table_" in name:
                    p.copy_(torch.rand(p.shape, device=dev, generator=gen) * 2 - 1)
                else:
                    p.add_(torch.randn(p.shape, device=dev, generator=gen) * 0.05)
        dims = eval_dims(cfg)
        check(dims is not None and dims.grid_dim == 32, f"E does not take the hybrid field: {dims}")
        pk = pack_eval(net, dims, torch.bfloat16)
        tables = [t.detach() for t in net.grid.tables()]
        gk, ek = GridKernel(tables, dev), EvalKernel(pk, dims, dev)
        ek_nogrid = EvalKernel(pk._replace(hw=pk.hw[:dims.width].contiguous()),
                               dataclasses.replace(dims, grid_dim=0), dev)
        pts, dirs = grid_points(rays, s, dev, rays + s)
        n = pts.shape[0]
        before = calls("kernels.launch.G")
        g = gk(pts)
        check(calls("kernels.launch.G") == before + 1, "G's launch not counted")
        ref_g = hash_grid_encode(pts, tables).to(torch.bfloat16)
        torch.cuda.synchronize()
        exact = torch.equal(g.view(torch.int16), ref_g.view(torch.int16))
        check(exact, "G differs from its plain encoding")
        del ref_g
        got = ek(pts, dirs, s, g)
        matmul = torch.backends.cuda.matmul
        reduced, matmul.allow_bf16_reduced_precision_reduction = (
            matmul.allow_bf16_reduced_precision_reduction, False)
        ref = field_eval_plain(pts, dirs, s, pk, dims, g)
        torch.cuda.synchronize()
        matmul.allow_bf16_reduced_precision_reduction = reduced
        shares = {k: float((a != b).float().mean()) for k, a, b in zip(("sigma", "rgb", "sem"),
                                                                       got, ref)}
        rels = {k: rel_err(a, b) for k, a, b in zip(("sigma", "rgb", "sem"), got, ref)}
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        del ref
        check(all(v <= EVAL_SHARE for v in shares.values())
              and all(v <= EVAL_REL for v in rels.values()),
              f"E with the grid's features off its plain version: {shares} {rels}")
        g_ms = [time_ms(lambda: gk(pts)) for _ in range(2)]
        g_dev = device_ms(lambda: gk(pts), "hash_grid_kernel")
        foot = {paired: [sum(f[j] for f in gather_footprint(pts, paired)) / n for j in (0, 1)]
                for paired in (False, True)}
        g_plain = time_ms(lambda: hash_grid_encode(pts, tables).to(torch.bfloat16), reps=3)
        e_ms = [time_ms(lambda: ek(pts, dirs, s, g)) for _ in range(2)]
        e0_ms = [time_ms(lambda: ek_nogrid(pts, dirs, s)) for _ in range(2)]
        with torch.no_grad():
            m_plain = time_ms(lambda: net(pts.view(-1, s, 3), dirs[:, None, :]), reps=3)
        g_bound = bound(n * (GRID.levels * 60 + 9), n * (12 + 2 * GRID.dim), PEAK_F32)
        e_bound = bound(2.0 * n * sum(i * o for i, o in field_shapes(dims)),
                        nbytes(pts, dirs, g, got, *[t for t in pk if t is not None]))
        print(f"grid (c), {level} {cfg.trunk_depth}x{cfg.trunk_width}, {rays} rays x {s}: G bit "
              f"for bit against its plain encoding: {exact}; G {g_ms[0]:.4f} / {g_ms[1]:.4f} ms "
              f"(device {g_dev:.4f}), plain encoding {g_plain:.4f} ms, bound {g_bound[0]:.4f} ms "
              f"({g_bound[1]}); G's loads a point over the levels: lane pairs "
              f"{foot[True][0]:.2f} lines / {foot[True][1]:.2f} sectors, one thread a point "
              f"{foot[False][0]:.2f} / {foot[False][1]:.2f}; E with features {e_ms[0]:.4f} / "
              f"{e_ms[1]:.4f} ms, E without {e0_ms[0]:.4f} / {e0_ms[1]:.4f} ms, plain hybrid "
              f"model {m_plain:.4f} ms, E's bound {e_bound[0]:.4f} ms ({e_bound[1]}); E against "
              "its plain version: share of "
              "values that differ " + ", ".join(f"{k} {v:.2e}" for k, v in shares.items())
              + "; relative Frobenius error " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
              + f"; max |d| {err:.3e}")
        if (level, rays) == ("fine", 33088):
            out = {"G": {"err": 0.0, "ms": min(g_ms), "plain_ms": g_plain, "bound": g_bound},
                   "E": {"err": err, "ms": min(e_ms), "plain_ms": m_plain, "bound": e_bound}}
        del net, pk, gk, ek, ek_nogrid, g, got, pts, dirs
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["launches"] = grid_view_check(dev, tmp)
    return out


def grid_view_check(dev, tmp):
    """5 (c), the main path: GRID_VIEWS 188x704 views of a two-frame KITTI-360
    demo tree through `intersect_and_render` with the model of
    configs/torch/kitti360_grid.yaml (seeded lecun weights, biases drawn in
    N(0, 0.05), tables uniform in +-1, where the grid moves every map), the
    program's counters cleared just before; the same views with
    `renderer.eval_field` giving back the plain hybrid model. Checks G, E, V
    and Z each launched 2 x tiles a view, `render.grid.points` and
    `render.field.points_fused` equal to `render.field.points`, and each
    view's gaps within GRID_VIEW_GAP. -> {"G": launches, "E": ..., "V": ...,
    "Z": ...}."""
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
    from panopticnerf_tpu_torch.models import init_params, make_network
    from panopticnerf_tpu_torch.render import renderer
    from panopticnerf_tpu_torch.utils import profiling

    root = f"{tmp}/tree"
    write_demo_tree(root, n_frames=2, hw=KITTI_HW, n_boxes=8, seed=1, n_concave=2, device=dev)
    cfg = load_config(GRID_CFG_FILE, ["data.root", root, "data.frame_start", "0",
                                      "data.frame_num", "2"])
    ds, _, _ = make_dataset(cfg, dev)
    model = make_network(cfg, dev).eval()
    init_params(model, torch.Generator(dev).manual_seed(11))
    with torch.no_grad():
        for name, p in model.named_parameters():
            gen = torch.Generator(dev).manual_seed(len(name))
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=gen)
            elif ".table_" in name:
                p.uniform_(-1.0, 1.0, generator=gen)
    bounds = renderer.SceneBounds(ds.bounds_center, ds.bounds_scale)
    views = list(range(GRID_VIEWS))

    def render():
        with torch.no_grad():
            return [renderer.intersect_and_render(cfg, model, *view_rays(ds, v),
                                                  view_primitives(ds, v), bounds) for v in views]

    torch.cuda.synchronize()
    profiling.reset()
    outs = render()
    torch.cuda.synchronize()
    launches = {k: profiling.calls(f"kernels.launch.{k}") for k in ("G", "E", "V", "Z")}
    points = {k: profiling.calls(f"render.{k}")
              for k in ("field.points", "field.points_fused", "grid.points")}
    keep = renderer.eval_field
    renderer.eval_field = lambda m, c, d: m
    try:
        refs = render()
    finally:
        renderer.eval_field = keep
    torch.cuda.synchronize()
    rel = lambda a, b: float((a - b).abs().mean() / b.abs().mean().clamp(min=1e-30))
    gaps = [(float((o.rgb - r.rgb).abs().mean()), rel(o.depth, r.depth),
             rel(o.sem_logits, r.sem_logits)) for o, r in zip(outs, refs)]
    rays = ds.images.shape[1] * ds.images.shape[2]
    tiles = -(-rays // cfg.render.ray_tile)
    print(f"grid (c), main path: {len(views)} views of {ds.images.shape[1]}x"
          f"{ds.images.shape[2]} ({rays} rays, {tiles} tiles of {cfg.render.ray_tile}) through "
          f"intersect_and_render, counters cleared before: launches G {launches['G']}, E "
          f"{launches['E']}, V {launches['V']}, Z {launches['Z']} (2 x tiles x views = "
          f"{2 * tiles * len(views)}); "
          "points "
          + ", ".join(f"{k} {v}" for k, v in points.items())
          + "; gaps against the plain hybrid model (mean |rgb|, relative depth, relative "
          "logits) " + "; ".join(", ".join(f"{x:.3e}" for x in g) for g in gaps)
          + f" (ceilings {GRID_VIEW_GAP})")
    check(set(launches.values()) == {2 * tiles * len(views)},
          f"hybrid views: launches {launches}, expected {2 * tiles * len(views)} each")
    check(points["field.points"] > 0
          and points["field.points"] == points["field.points_fused"] == points["grid.points"],
          f"hybrid views: points {points}")
    check(all(x <= c for g in gaps for x, c in zip(g, GRID_VIEW_GAP))
          and all(bool(torch.isfinite(o.rgb).all() and torch.isfinite(o.sem_logits).all())
                  for o in outs), f"hybrid views off the plain model: {gaps}")
    del model, ds, outs, refs
    torch.cuda.empty_cache()
    return launches


def composite_plain(sigma, rgb, sem, z, iv, classes):
    """The evaluation branch's compositing as plain ops (V's plain version)."""
    from panopticnerf_tpu_torch.ops.composite import composite
    from panopticnerf_tpu_torch.ops.intersect import (
        fixed_map_from_weights,
        labeled_containment,
        samples_in_intervals,
    )

    out = composite(sigma, rgb, z, sem_logits=sem, inside_intervals=samples_in_intervals(z, iv))
    lab, cnt = labeled_containment(z, iv)
    return out._replace(sem_fixed=fixed_map_from_weights(out.weights, lab, cnt, iv, classes))


def composite_phase(dev, tmp):
    """5 (d): kernel V (csrc/composite.cu) against the plain ops at the render
    cells' shapes: the first 33,088 rays of a 188x704 view of a two-frame
    KITTI-360 demo tree, their A1 intervals (K = 16), the guided depths of
    each level (S = 64 and 128), seeded field outputs (sigma N(0, 3), rgb
    U(0, 1), 19 logits N(0, 1)). Every output within COMPOSITE_W_ABS /
    COMPOSITE_REL, a second call equal bit for bit; V's time (events and its
    device time) and the plain ops' beside V's bound (its own bytes at HBM's
    rate). -> {"err", "ms", "plain_ms", "bound"} at S = 128."""
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
    from panopticnerf_tpu_torch.ops import sampling
    from panopticnerf_tpu_torch.ops.composite_cuda import composite_cuda
    from panopticnerf_tpu_torch.ops.intersect import RayIntervals, intersect_rays

    root = f"{tmp}/composite_tree"
    write_demo_tree(root, n_frames=2, hw=KITTI_HW, n_boxes=8, seed=3, n_concave=2, device=dev)
    cfg = load_config(KITTI_CFG, ["data.root", root, "data.frame_start", "0",
                                  "data.frame_num", "2"])
    ds, _, _ = make_dataset(cfg, dev)
    rays = 33088
    o, d = (t[:rays] for t in view_rays(ds, 0))
    rc = cfg.render
    iv = intersect_rays(o, d, view_primitives(ds, 0), rc.near, rc.far, cfg.data.max_intervals)
    iv = RayIntervals(*[t.contiguous() for t in iv])
    classes, k = cfg.model.num_classes, cfg.data.max_intervals
    out = {}
    for s in (64, 128):
        z = sampling.guided_z(iv, s, rc.near, rc.far, False, rc.bg_sample_frac)
        g = torch.Generator(dev).manual_seed(s)
        sigma = torch.randn(rays, s, device=dev, generator=g) * 3.0
        rgb = torch.rand(rays, s, 3, device=dev, generator=g)
        sem = torch.randn(rays, s, classes, device=dev, generator=g)
        run = lambda: composite_cuda(sigma, rgb, z, sem_logits=sem, iv=iv, num_classes=classes)
        plain = lambda: composite_plain(sigma, rgb, sem, z, iv, classes)
        got, again, ref = run(), run(), plain()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        w_abs = float((got.weights - ref.weights).abs().max())
        rels = {f: rel_err(a, b) for f, a, b in zip(got._fields, got, ref) if f != "weights"}
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        ms, plain_ms = [time_ms(run) for _ in range(2)], [time_ms(plain, reps=5) for _ in range(2)]
        v_dev = device_ms(run, "volume_composite_kernel", reps=10)
        moved = nbytes(sigma, rgb, sem, z, iv.t_in, iv.t_out, iv.semantic, iv.mask, got)
        bnd = bound(0, moved)
        inside = float(iv.mask.any(-1).float().mean())
        print(f"composite (d), S = {s}: V against the plain ops at {rays} rays x {s} samples, "
              f"K = {k} ({inside:.3f} of the rays hit a primitive), C = {classes}: weights max "
              f"|d| {w_abs:.3e} (ceiling {COMPOSITE_W_ABS}); relative Frobenius error "
              + ", ".join(f"{f} {v:.2e}" for f, v in rels.items())
              + f" (ceiling {COMPOSITE_REL}); a second call bit for bit: {same}; V {ms[0]:.4f} / "
              f"{ms[1]:.4f} ms (device {v_dev:.4f}), plain ops {plain_ms[0]:.4f} / "
              f"{plain_ms[1]:.4f} ms (events around the call, medians); bound {bnd[0]:.4f} ms "
              f"({bnd[1]}: {moved} bytes), {100 * bnd[0] / v_dev:.1f} % of it on the device")
        check(same, f"V (S = {s}): a second call differs")
        check(w_abs <= COMPOSITE_W_ABS and all(v <= COMPOSITE_REL for v in rels.values()),
              f"V (S = {s}) off the plain ops: weights {w_abs}, {rels}")
        out = {"err": err, "ms": min(ms), "plain_ms": min(plain_ms), "bound": bnd}
    del ds
    torch.cuda.empty_cache()
    return out


def sampling_phase(dev, tmp):
    """5 (e): kernel Z (csrc/sample.cu) at the render cells' shapes: the first
    33,088 rays of a 188x704 view of a two-frame KITTI-360 demo tree and their
    A1 intervals (K = 16); the coarse pass (48 + 16) and the fine pass (64 +
    64) on its depths, with the weights V composites from seeded field
    outputs (sigma N(0, 3)). Z equal bit for bit to the plain ops with their
    sums in Z's order and to a second call, and within the card test's
    ceilings of the plain ops as they are (tests/torch_sampling_order.py:
    rays where the orders place a position in another segment or bin within
    SAMPLE_FLIPS); Z's time (events and device time) and the plain chain's
    beside Z's bound (its own bytes at HBM's rate). -> {"err", "ms",
    "plain_ms", "bound"} of both passes together."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_sampling_order import KernelZOrder, against_plain

    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
    from panopticnerf_tpu_torch.ops import sampling
    from panopticnerf_tpu_torch.ops.composite_cuda import composite_cuda
    from panopticnerf_tpu_torch.ops.intersect import RayIntervals, intersect_rays
    from panopticnerf_tpu_torch.ops.sampling_cuda import fine_z_cuda, guided_z_cuda

    root = f"{tmp}/sample_tree"
    write_demo_tree(root, n_frames=2, hw=KITTI_HW, n_boxes=8, seed=3, n_concave=2, device=dev)
    cfg = load_config(KITTI_CFG, ["data.root", root, "data.frame_start", "0",
                                  "data.frame_num", "2"])
    ds, _, _ = make_dataset(cfg, dev)
    o, d = (t[:33088] for t in view_rays(ds, 0))
    rays = o.shape[0]
    rc = cfg.render
    k, s, m, bg = cfg.data.max_intervals, rc.n_samples, rc.n_importance, rc.bg_sample_frac
    iv = intersect_rays(o, d, view_primitives(ds, 0), rc.near, rc.far, k)
    iv = RayIntervals(*[t.contiguous() for t in iv])
    coarse = lambda: guided_z_cuda(iv, s, rc.near, rc.far, bg)
    z = coarse()
    g = torch.Generator(dev).manual_seed(5)
    sigma = torch.randn(rays, s, device=dev, generator=g) * 3.0
    w = composite_cuda(sigma, torch.rand(rays, s, 3, device=dev, generator=g), z).weights
    fine = lambda: fine_z_cuda(z, w, m)
    got_c, got_f = coarse(), fine()
    again_c, again_f = coarse(), fine()

    def plain_coarse():
        return sampling.guided_z(iv, s, rc.near, rc.far, False, bg)

    def plain_fine():
        z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
        return sampling.merge_z(z, sampling.sample_pdf(z_mid, w[:, 1:-1], m, False))

    keep = sampling.torch
    sampling.torch = KernelZOrder()
    try:
        own_c, own_f = plain_coarse(), plain_fine()
    finally:
        sampling.torch = keep
    r = against_plain(iv, s, bg, w, m, rc.near, rc.far)
    torch.cuda.synchronize()
    same = torch.equal(got_c, again_c) and torch.equal(got_f, again_f)
    own = torch.equal(got_c, own_c) and torch.equal(got_f, own_f)
    ms = [time_ms(lambda: (coarse(), fine())) for _ in range(2)]
    plain_ms = [time_ms(lambda: (plain_coarse(), plain_fine()), reps=5) for _ in range(2)]
    dev_c = device_ms(coarse, "sample_coarse_kernel", reps=10)
    dev_f = device_ms(fine, "sample_fine_kernel", reps=10)
    moved_c = nbytes(iv.t_in, iv.t_out, iv.mask, got_c)
    moved_f = nbytes(z, w, got_f)
    bnd = bound(0, moved_c + moved_f)
    inside = float(iv.mask.any(-1).float().mean())
    print(f"sampling (e): Z at {rays} rays, K = {k} ({inside:.3f} of the rays hit a primitive), "
          f"{s} coarse ({sampling.guided_split(s, bg)}) + {m} fine: bit for bit with the plain "
          f"ops in Z's order: {own}; a second call bit for bit: {same}; against the plain ops "
          f"as they are: coarse largest |dz| {r['coarse_gap']:.3e} (ceiling "
          f"{r['coarse_ceiling']:.3e}; {r['coarse_flips']} rays with a segment flipped, largest "
          f"{r['coarse_gap_all']:.3e}), fine {r['fine_gap']:.3e} (over its ceiling by at most "
          f"{r['fine_over']:.3e}; ceilings {r['fine_ceiling_min']:.3e}-"
          f"{r['fine_ceiling_max']:.3e}; {r['fine_flips']} rays with a bin or the rule "
          f"flipped, largest {r['fine_gap_all']:.3e}); Z {ms[0]:.4f} / {ms[1]:.4f} ms (device "
          f"coarse {dev_c:.4f} + fine {dev_f:.4f}), the plain chain {plain_ms[0]:.4f} / "
          f"{plain_ms[1]:.4f} ms (events around the calls, medians); bound {bnd[0]:.4f} ms "
          f"({bnd[1]}: {moved_c} + {moved_f} bytes), {100 * bnd[0] / (dev_c + dev_f):.1f} % of "
          "it on the device")
    check(same, "Z: a second call differs")
    check(own, "Z differs from the plain ops with their sums in its order")
    check(r["coarse_gap"] <= r["coarse_ceiling"] and r["fine_over"] <= 0.0
          and r["coarse_flips"] <= SAMPLE_FLIPS[0] * rays
          and r["fine_flips"] <= SAMPLE_FLIPS[1] * rays, f"Z off the plain ops: {r}")
    del ds
    torch.cuda.empty_cache()
    return {"err": max(r["coarse_gap"], r["fine_gap"]), "ms": min(ms), "plain_ms": min(plain_ms),
            "bound": bnd}


def field_phase(cfg, enc, model, dev):
    """Kernels C / C' vs plain at the step's point counts, with the
    checkpoint's coarse and fine weights on the encodings of real sample
    points; C' on C's saved activations with dW in bf16 (mode field) and
    float32 (mode hybrid), and C' with its own recompute (saved None, as
    mode hybrid runs it)."""
    from panopticnerf_tpu_torch.ops import field_train as ft
    from panopticnerf_tpu_torch.ops.field_train_cuda import (
        field_backward_cuda,
        field_forward_cuda,
        forward_plan_bytes,
        heads_data_plan_bytes,
        heads_weight_plan_bytes,
    )
    from panopticnerf_tpu_torch.ops.mlp_train import F_PAD
    from panopticnerf_tpu_torch.ops.mlp_train_cuda import backward_plan_bytes

    gen = torch.Generator(dev).manual_seed(7)
    c = cfg.model
    res = {}
    for field, (x_enc, d_enc) in enc.items():
        dims = ft.FieldDims(x_dim=x_enc.shape[1], d_dim=d_enc.shape[1], width=c.trunk_width,
                            sem_hidden=c.trunk_width // 2, color_width=c.color_width,
                            num_classes=c.num_classes, layers=c.trunk_depth,
                            skips=kernel_skips(cfg), use_sem=c.use_semantic)
        pk = ft.pack_field(ft._leaf_params(getattr(model, field), dims), dims, torch.bfloat16)
        npts = x_enc.shape[0]
        xp = ft.pad_cols(x_enc, F_PAD, npts, x_enc)
        dp = ft.pad_cols(d_enc, ft.D_PAD, npts, x_enc)
        g_out = torch.randn((npts, 4), generator=gen, device=dev) * 1e-3
        g_sem = torch.randn((npts, dims.num_classes), generator=gen, device=dev) * 1e-3
        out, sem, saved = field_forward_cuda(xp, dp, pk, dims)
        second = field_forward_cuda(xp, dp, pk, dims)
        same_fwd = all(torch.equal(a, b) for a, b in
                       zip((out, sem, *saved), (second[0], second[1], *second[2]))
                       if a is not None)
        del second
        r_out, r_sem, r_saved = ft.field_forward_plain(xp, dp, pk, dims)
        errs = {"sigma": (out[:, 0], r_out[:, 0]), "rgb": (out[:, 1:], r_out[:, 1:]),
                "sem": (sem, r_sem)}
        errs.update({k: (a, b) for k, a, b in zip(saved._fields, saved, r_saved) if a is not None})
        # C' on C's saved activations, dW in bf16 and in float32, against
        # plain C' on the same activations; then C' with its own recompute
        # (saved None, float32 dW: mode hybrid's call) against plain C' on
        # the plain forward's activations
        grads = {}
        for tag, dwt, sv, sv_ref in (("bf16", torch.bfloat16, saved, saved),
                                     ("f32", torch.float32, saved, saved),
                                     ("rec", torch.float32, None, r_saved)):
            got = field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, sv, dwt)
            ref = ft.field_backward_plain(xp, dp, g_out, g_sem, pk, dims, sv_ref, dwt)
            grads[tag] = got
            if tag == "bf16":
                again = field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, sv, dwt)
            errs[f"dx/{tag}"], errs[f"dd/{tag}"] = (got[0], ref[0]), (got[1], ref[1])
            errs.update({f"d{k}/{tag}": (a, b) for k, a, b in zip(got[2]._fields, got[2], ref[2])
                         if a is not None})
        torch.cuda.synchronize()
        # the recompute runs C itself, so it must give C' on C's activations exactly
        same = all(torch.equal(a, b) for a, b in
                   zip((*grads["rec"][:2], *grads["rec"][2]), (*grads["f32"][:2], *grads["f32"][2]))
                   if a is not None)
        repeat = all(torch.equal(a, b) for a, b in
                     zip((*grads["bf16"][:2], *grads["bf16"][2]), (*again[:2], *again[2]))
                     if a is not None)
        stats = {}
        for name, (a, b) in errs.items():
            check(bool(torch.isfinite(a.float()).all()), f"C/C' {field}: non-finite {name}")
            stats[name] = (float((a.float() - b.float()).abs().max()), rel_err(a, b))
        print(f"C/C' vs plain, {field} field, N={npts} (max|d|, relative Frobenius error; "
              f"/rec: C' with its recompute vs plain on the plain forward):")
        names = list(stats)
        for i in range(0, len(names), 6):
            print("  " + "; ".join(f"{k} {stats[k][0]:.2e} {stats[k][1]:.2e}"
                                   for k in names[i:i + 6]))
        print(f"  C' with its recompute equals C' on C's saved activations bit for bit: {same}; "
              f"a second C call equals the first bit for bit: {same_fwd}, a second C' call: "
              f"{repeat}")
        for name, (_, r) in stats.items():
            lim = field_ceiling(name)
            check(r <= lim, f"C/C' {field} N={npts}: {name} rel err {r} > {lim}")
        check(same, f"C' {field} N={npts}: the recompute differs from C' on C's activations")
        check(same_fwd, f"C {field} N={npts}: a second call differs from the first")
        check(repeat, f"C' {field} N={npts}: a second call differs from the first")
        t = {}
        fwd_k = lambda: field_forward_cuda(xp, dp, pk, dims)
        fwd_p = lambda: ft.field_forward_plain(xp, dp, pk, dims)
        bwd_k = lambda: field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, saved, torch.bfloat16)
        bwd_p = lambda: ft.field_backward_plain(xp, dp, g_out, g_sem, pk, dims, saved,
                                                torch.bfloat16)
        rec_k = lambda: field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, None, torch.float32)
        rec_p = lambda: ft.field_backward_plain(xp, dp, g_out, g_sem, pk, dims,
                                                ft.field_forward_plain(xp, dp, pk, dims)[2],
                                                torch.float32)
        for key, fn in (("fwd_plain", fwd_p), ("fwd", fwd_k), ("bwd_plain", bwd_p), ("bwd", bwd_k),
                        ("rec_plain", rec_p), ("rec", rec_k), ("rec2", rec_k),
                        ("rec_plain2", rec_p), ("bwd2", bwd_k), ("bwd_plain2", bwd_p),
                        ("fwd2", fwd_k), ("fwd_plain2", fwd_p)):
            t[key] = time_ms(fn, reps=5, warmup=1)
        # the TPU functions' own work: x_enc, d_enc (bf16) -> sigma, rgb
        # logits, sem (f32); backward x_enc, d_enc and the f32 upstream g ->
        # dx, dd (bf16), dW, db (the recompute computes the same function)
        shapes = field_shapes(dims)
        io_in = 2 * (dims.x_dim + dims.d_dim)
        io_out = 4 * (4 + (dims.num_classes if dims.use_sem else 0))
        t["fwd_bound"] = dense_bound(npts, shapes, io_in + io_out)
        t["bwd_bound"] = dense_bound(npts, shapes, 2 * io_in + io_out, backward=True)
        t["rec_bound"] = dense_bound(npts, shapes, 2 * io_in + io_out, backward=True, dw_bytes=4)
        floor = [1e3 * b / PEAK_BYTES for b in
                 (*backward_plan_bytes(npts, dims.width, dims.layers, dims.skips),
                  heads_weight_plan_bytes(npts, dims))]
        t["fwd_floor"] = 1e3 * forward_plan_bytes(npts, dims) / PEAK_BYTES
        # C''s heads data pass on its own: g W^T through the heads (2 x in x
        # out operations per point and head), its own bytes at HBM's rate
        heads = shapes[dims.layers:]
        t["heads_bound"] = bound(2.0 * npts * sum(i * o for i, o in heads),
                                 heads_data_plan_bytes(npts, dims))
        t["heads_dev"] = device_ms(bwd_k, "field_bwd_heads_kernel")
        res[field] = {"errs": stats, "t": t}
        print(f"  times (ms, median of 5, interleaved): C {t['fwd']:.3f} / {t['fwd2']:.3f}, plain "
              f"{t['fwd_plain']:.3f} / {t['fwd_plain2']:.3f}, bound {t['fwd_bound'][0]:.3f} "
              f"({t['fwd_bound'][1]}), C's design floor {t['fwd_floor']:.3f} (bytes: inputs, "
              f"outputs, the saved activations, the weights); C' {t['bwd']:.3f} / "
              f"{t['bwd2']:.3f}, plain "
              f"{t['bwd_plain']:.3f} / {t['bwd_plain2']:.3f}, bound {t['bwd_bound'][0]:.3f} "
              f"({t['bwd_bound'][1]}), byte floor of the plan's redesigned passes {floor[0]:.3f} "
              f"(trunk data) + {floor[1]:.3f} (trunk weight) + {floor[2]:.3f} (heads' weight) ms"
              f"; the heads' data pass {t['heads_dev']:.4f} (device, torch.profiler, mean of 5) "
              f"against its bound {t['heads_bound'][0]:.4f} ({t['heads_bound'][1]}); "
              f"C' with recompute, f32 dW {t['rec']:.3f} / "
              f"{t['rec2']:.3f}, plain {t['rec_plain']:.3f} / {t['rec_plain2']:.3f}, bound "
              f"{t['rec_bound'][0]:.3f} ({t['rec_bound'][1]}); C writes "
              f"{nbytes(saved) / 1e9:.3f} GB of saved activations ("
              f"{1e3 * nbytes(saved) / PEAK_BYTES:.3f} ms at HBM's rate, which C' reads back: "
              f"a cost of the design, not of the function)")
        del out, sem, saved, r_out, r_sem, r_saved, grads, got, again, ref, errs
    return res


def with_mode(cfg, mode):
    import dataclasses

    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, pallas_mode=mode))


def step_phase(cfg, ds, dev, mode):
    """One flagship step from the 10k checkpoint in `mode` with the JAX
    step's draws, against the JAX record of the same mode."""
    from panopticnerf_tpu_torch.convert import load_npz, params_to_flax
    from panopticnerf_tpu_torch.data.dataset import BatchDraws
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.render import RenderDraws
    from panopticnerf_tpu_torch.train import StepDraws, make_train_state, make_train_step

    cfg = with_mode(cfg, mode)
    suffix = "" if mode == "trunk" else f"_{mode}"
    with open(STEP_JSON[:-5] + suffix + ".json") as fh:
        ref = json.load(fh)
    z = np.load(STEP_NPZ)                       # the draws (the same in every mode)
    zg = np.load(STEP_NPZ[:-4] + suffix + ".npz")  # this mode's gradients and update signs
    model = make_network(cfg, dev)
    model.load_state_dict(load_npz(os.path.join(REPO, "artifacts", "torch",
                                                "synthetic_flagship_10000.npz")))
    old = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = make_train_state(cfg, model)
    step = make_train_step(cfg, model)
    t = lambda key: torch.from_numpy(z[f"draw/{key}"]).to(dev) if f"draw/{key}" in z else None
    draws = StepDraws(BatchDraws(t("group"), t("u"), t("v")),
                      RenderDraws(t("coarse"), t("bg"), t("fine"), t("noise_coarse"),
                                  t("noise_fine")))
    view_ids = torch.from_numpy(z["view_ids"]).to(dev)
    stats = {k: float(v) for k, v in step(state, ds, view_ids, None, draws).items()}
    worst = 0.0
    for key, want in sorted(ref["stats"].items()):
        got = stats[key]
        r = abs(got - want) / max(abs(want), 1e-12)
        print(f"  step ({mode}) {key}: port {got:.6f}  JAX {want:.6f}  rel {r:.2e}")
        check(np.isfinite(got), f"step {key} not finite")
        if key.startswith("loss_") or key == "grad_norm":
            check(r <= STEP_REL or abs(got - want) <= 1e-6,
                  f"step ({mode}) {key} off the JAX record ({r:.3e} > {STEP_REL})")
            worst = max(worst, r if abs(got - want) > 1e-6 else 0.0)
    # a leaf no loss reaches (the coarse semantic head) has no .grad; JAX's is 0
    grads = params_to_flax({k: torch.zeros_like(p) if p.grad is None else p.grad
                            for k, p in model.named_parameters()})
    new = params_to_flax({k: v - old[k] for k, v in model.state_dict().items()})
    cos_min, agree, total = 1.0, 0, 0
    for name in sorted(grads):
        a = grads[name].astype(np.float64).ravel()
        b = zg[f"grad_dir/{name}"].astype(np.float64).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        cos = 1.0 if na == nb == 0 else float(a @ b / max(na * nb, 1e-30))
        cos_min = min(cos_min, cos)
        if cos < MIN_COSINE:
            print(f"  leaf {name}: gradient cosine {cos:.5f}")
        s = np.sign(new[name]).astype(np.int8).ravel()
        agree += int((s == zg[f"update_sign/{name}"].ravel()).sum())
        total += s.size
    print(f"one flagship step ({mode}) vs JAX: loss terms / grad_norm rel <= {worst:.2e}; "
          f"min per-leaf gradient cosine {cos_min:.5f} over {len(grads)} leaves; first Adam "
          f"update sign agrees on {agree} of {total} entries ({agree / total:.4f})")
    check(cos_min >= MIN_COSINE, f"({mode}) gradient cosine {cos_min} < {MIN_COSINE}")
    check(agree / total >= MIN_SIGN_SHARE,
          f"({mode}) first-update sign agreement {agree / total} < {MIN_SIGN_SHARE}")
    return stats, cos_min, agree / total


def train_phase(cfg, dev, engine, mode):
    """The training main path in `mode` (A2 and B / B', or C / C', or C');
    then an evaluation of the checkpoint it wrote."""
    import dataclasses

    counters = ("A2", "B", "B'", "C", "C'", "Z")  # Z, the evaluation's sampling: never
    steps = TRAIN_STEPS[mode]
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = dataclasses.replace(with_mode(cfg, mode), model_dir=tmp, record_dir=tmp)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        res = engine.run_train(tcfg, dev, max_steps=steps, log=lambda *a: None)
        wall = time.perf_counter() - t0
        launches = launch_counts(counters)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        losses = res["losses"]
        ms = [1000.0 * s / k for k, s in res["windows"][1:]]  # the first window warms up
        ms_step = float(np.median(ms))
        first, last = float(losses[:20].mean()), float(losses[-20:].mean())
        print(f"run_train ({mode}): {steps} steps of {cfg.data.n_rays} rays in {wall:.2f} s; "
              f"median {ms_step:.3f} ms/step over {len(ms)} windows of "
              f"{cfg.train.log_interval} after the first (range {min(ms):.3f}-{max(ms):.3f}), "
              f"{cfg.data.n_rays / ms_step * 1000:.0f} rays/s; peak device memory {peak:.0f} MiB")
        print(f"  ms/step of each window: {' '.join(f'{v:.3f}' for v in ms)}")
        print(f"  loss_total mean of the first 20 steps {first:.5f}, last 20 {last:.5f}; "
              f"launches {launches}")
        check(bool(np.isfinite(losses).all()), f"({mode}) non-finite training loss")
        check(last < first, f"({mode}) training loss did not fall ({first} -> {last})")
        per_step = {"trunk": {"B": 2, "B'": 2}, "field": {"C": 2, "C'": 2},
                    "hybrid": {"C'": 2}}[mode]
        want = {k: steps if k == "A2" else per_step.get(k, 0) * steps for k in counters}
        check(launches == want, f"({mode}) launch counts {launches}, expected {want}")
        ecfg = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, eval_step=steps))
        ev = engine.run_evaluate(ecfg, dev, log=lambda *a: None)
        print(f"  run_evaluate of the {steps}-step checkpoint: PSNR {ev['psnr']:.4f}, "
              f"mIoU {ev['miou']:.4f}, PQ {ev['pq']:.4f}")
        check(all(np.isfinite(ev[k]) for k in ("psnr", "miou", "pq")), "non-finite scores")
    final = {k: v.detach().cpu().clone() for k, v in res["state"].model.state_dict().items()}
    return launches, ms_step, {"losses": losses, "params": final, "stats": res["stats"]}


def rel_gaps(a, b):
    """|a - b| / |b| per step (0 where they are equal), b the reference."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.where(a == b, 0.0, np.abs(a - b) / np.maximum(np.abs(b), 1e-30))


def param_drift(a, b, theta0):
    """||a - b|| / ||b - θ0|| over every parameter, and the largest and
    median leaf's (leaves training did not move left out), as
    tools/export_torch_train_trajectory.py's `drift`."""
    num = den = 0.0
    leaves = []
    for k in sorted(b):
        d = float(((a[k].double() - b[k].double()) ** 2).sum())
        m = float(((b[k].double() - theta0[k].double()) ** 2).sum())
        num, den = num + d, den + m
        if m > 0:
            leaves.append(np.sqrt(d / m))
    return float(np.sqrt(num / den)), float(max(leaves)), float(np.median(leaves))


def plain_config(cfg):
    import dataclasses

    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, use_pallas=False),
        render=dataclasses.replace(cfg.render, use_pallas_intersect=False))


def trajectory_phase(cfg, dev, engine, runs):
    """16. The plain path against each kernel mode over many steps (see the
    module docstring); `runs` are phase 10's."""
    import dataclasses

    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.models import init_params, make_network
    from panopticnerf_tpu_torch.train import make_train_state, make_train_step

    pcfg = plain_config(cfg)
    half = PLAIN_STEPS // 2
    with tempfile.TemporaryDirectory() as tmp:
        pcfg = dataclasses.replace(pcfg, model_dir=tmp, record_dir=tmp)
        zero_counts()
        t0 = time.perf_counter()
        first = engine.run_train(pcfg, dev, max_steps=half, log=lambda *a: None)
        at_half = {k: v.detach().cpu().clone()
                   for k, v in first["state"].model.state_dict().items()}
        rest = engine.run_train(pcfg, dev, max_steps=PLAIN_STEPS, log=lambda *a: None)  # resumes
        wall = time.perf_counter() - t0
        launches = launch_counts()
    plain = {k: np.concatenate([first["stats"][k], rest["stats"][k]]) for k in first["stats"]}
    params = {half: at_half, PLAIN_STEPS: {k: v.detach().cpu().clone()
                                           for k, v in rest["state"].model.state_dict().items()}}
    ms = [1000.0 * s / k for r in (first, rest) for k, s in r["windows"][1:]]
    print(f"16. plain path: {PLAIN_STEPS} steps ({half} + {half} resumed) in {wall:.2f} s, median "
          f"{np.median(ms):.3f} ms/step; launches {launches}")
    check(all(v == 0 for v in launches.values()), f"the plain path launched kernels: {launches}")
    check(len(plain["loss_total"]) == PLAIN_STEPS and np.isfinite(plain["loss_total"]).all(),
          "plain path: missing or non-finite losses")
    # the draws: step 1 replayed on a fresh state from the seeded init and
    # run_train's generator (train.seed + 1) equals the run's step 1
    ds, train_ids, _ = make_dataset(pcfg, dev)
    model = make_network(pcfg, dev)
    init_params(model, torch.Generator(dev).manual_seed(pcfg.train.seed))
    theta0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    one = make_train_step(pcfg, model)(make_train_state(pcfg, model), ds,
                                       torch.as_tensor(np.asarray(train_ids), device=dev),
                                       torch.Generator(dev).manual_seed(pcfg.train.seed + 1))
    same = all(float(v) == plain[k][0] for k, v in one.items())
    print(f"  step 1 replayed from the seeded init and generator: loss_rgb "
          f"{float(one['loss_rgb']):.8f} (run {plain['loss_rgb'][0]:.8f}); every stat equal: {same}")
    check(same, "the plain run's step 1 differs from its replay")
    with open(TRAJ_FLOOR_JSON) as fh:
        rec = json.load(fh)
    floor_stats = [rec["runs"][n]["stats"] for n in ("jax_trunk", "jax_plain")]
    floor = rec["pairs"]["jax_trunk/jax_plain"]
    check(rec["steps"] >= PLAIN_STEPS, f"the floor record holds {rec['steps']} steps")
    terms = sorted(k for k in plain if k.startswith("loss_"))
    for mode, (_, _, run) in runs.items():
        n = TRAIN_STEPS[mode]
        print(f"  {mode} against plain over steps 1-{n} (relative gap per step: max, mean of the "
              f"first 20, mean of the last 20; each beside its ceiling from the JAX floor)")
        readings = []
        for k in terms:
            got = rel_gaps(run["stats"][k][:n], plain[k][:n])
            ref = rel_gaps(floor_stats[0][k][:n], floor_stats[1][k][:n])
            row = [(f"{k} max", got.max(), TRAJ_LATE_MULTIPLE * ref.max()),
                   (f"{k} first 20", got[:20].mean(), TRAJ_MULTIPLE * ref[:20].mean()),
                   (f"{k} last 20", got[-20:].mean(), TRAJ_LATE_MULTIPLE * ref[-20:].mean())]
            print("    " + "; ".join(f"{name} {v:.3e} (ceiling {c:.3e})" for name, v, c in row))
            readings += row
        d, d_max, d_med = param_drift(run["params"], params[n], theta0)
        row = [("drift", d, TRAJ_MULTIPLE * floor["drift_by_step"][n - 1]),
               ("largest leaf", d_max, TRAJ_LATE_MULTIPLE * floor["leaf_drift_max_by_step"][n - 1]),
               ("median leaf", d_med, TRAJ_MULTIPLE * floor["leaf_drift_median_by_step"][n - 1])]
        print(f"    parameters at step {n}, ||θ_{mode} - θ_plain|| / ||θ_plain - θ0||: "
              + "; ".join(f"{name} {v:.4e} (ceiling {c:.4e})" for name, v, c in row))
        readings += row
        over = [f"{name} {v:.3e} > {c:.3e}" for name, v, c in readings if not v <= c]
        check(not over, f"({mode}) drifts from the plain path past the JAX floor: {over}")


def engine_phase(dev, engine, run):
    """11. The engine around the step on the card (see the module docstring)."""
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data.dataset import train_test_split
    from panopticnerf_tpu_torch.train.checkpoint import all_steps, save_model

    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    with tempfile.TemporaryDirectory() as tmp:
        opts = lambda run_dir: ENGINE_OPTS + [
            "model.pallas_mode", "trunk", "model_dir", f"{tmp}/{run_dir}",
            "record_dir", f"{tmp}/record_{run_dir}", "result_dir", f"{tmp}/result"]
        cfg = load_config(CFG_FILE, opts("a"))
        tc = cfg.train
        _, test_ids = train_test_split(cfg.data.synthetic_num_frames, cfg.data.test_every)
        n_eval_views = len(test_ids if tc.eval_views <= 0 else test_ids[:tc.eval_views])

        # (a) the cadence
        zero_counts()
        t0 = time.perf_counter()
        res = engine.run_train(cfg, dev, max_steps=ENGINE_STEPS, log=lambda *a: None)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        roots = engine.port_roots(cfg)
        steps = all_steps(roots.steps)
        print(f"engine (a): run_train of {ENGINE_STEPS} steps with saves and in-training "
              f"evaluations in {wall:.2f} s; step checkpoints {steps}; launches {launches}")
        check(steps == [100, 200], f"step checkpoints {steps}, expected [100, 200]")
        check([e[0] for e in res["evals"]] == [100, 200],
              f"in-training evaluations at {[e[0] for e in res['evals']]}, expected [100, 200]")
        for step, secs, ev in res["evals"]:
            print(f"  eval@{step} on {n_eval_views} view(s) in {secs:.3f} s: "
                  f"PSNR {ev['psnr']:.4f}, mIoU {ev['miou']:.4f}, PQ {ev['pq']:.4f}")
            check(all(np.isfinite(ev[k]) for k in ("psnr", "miou", "pq")),
                  f"non-finite in-training scores at step {step}")
        want = {"A1": len(res["evals"]) * n_eval_views, "A2": ENGINE_STEPS,
                "B": 2 * ENGINE_STEPS, "B'": 2 * ENGINE_STEPS, "C": 0, "C'": 0}
        check(launches == want, f"engine launch counts {launches}, expected {want}")
        ends = np.cumsum([k for k, _ in res["windows"]])
        ms = {int(e): 1000.0 * s / k for e, (k, s) in zip(ends, res["windows"])}
        held = int(ends[np.searchsorted(ends, 101)])  # the window after the save and eval at 100
        plain = [v for e, v in ms.items() if e not in (ends[0], held, ENGINE_STEPS)]
        print(f"  window ending at step {held} (holds the save and the evaluation at 100): "
              f"{ms[held]:.3f} ms/step over {int(held - ends[np.searchsorted(ends, 101) - 1])} "
              f"steps, against a median {np.median(plain):.3f} ms/step of the windows without "
              f"either; {card}")
        t0 = time.perf_counter()
        path = save_model(res["state"], f"{tmp}/save_alone", ENGINE_STEPS)
        print(f"  one save_model of the training state alone: "
              f"{1000.0 * (time.perf_counter() - t0):.1f} ms, "
              f"{os.path.getsize(path) / 2**20:.1f} MiB")
        with open(roots.best_metric) as fh:
            meta = json.load(fh)
        print(f"  best sidecar {meta}")
        check(meta["metric"] == "miou_pq_mean", f"sidecar metric {meta['metric']!r}")
        ecfg = load_config(CFG_FILE, opts("a") + ["train.eval_step", "-1"])
        ev = engine.run_evaluate(ecfg, dev, log=lambda *a: None)
        print(f"  run_evaluate of the best (train.eval_step -1): step {ev['step']}, PSNR "
              f"{ev['psnr']:.4f}, mIoU {ev['miou']:.4f}, PQ {ev['pq']:.4f}")
        check(ev["step"] == meta["step"], f"eval_step -1 restored step {ev['step']}, "
              f"the sidecar names {meta['step']}")

        # (b) SIGTERM, then resume
        child = subprocess.Popen(
            [sys.executable, "-u", "-m", "panopticnerf_tpu_torch.train_net", "--cfg_file",
             CFG_FILE, "--device", str(dev), "--max_steps", str(ENGINE_STEPS), *opts("b")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        lines = []
        try:
            for line in child.stdout:
                lines.append(line)
                if line.startswith("step "):
                    child.send_signal(signal.SIGTERM)
                    break
            lines += child.stdout.readlines()
            rc = child.wait(timeout=300)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        out = "".join(lines)
        m = re.search(r"SIGTERM received: checkpointing at step (\d+) and exiting", out)
        check(rc == 0 and m is not None, f"train_net under SIGTERM: rc {rc}, output:\n{out}")
        k = int(m.group(1))
        bcfg = load_config(CFG_FILE, opts("b") + ["train.resume", "true"])
        res_b = engine.run_train(bcfg, dev, max_steps=ENGINE_STEPS, log=lambda *a: None)
        dl = np.abs(res_b["losses"] - res["losses"][k:])
        pa, pb = res["state"].model.state_dict(), res_b["state"].model.state_dict()
        dp = max(float((pa[n] - pb[n]).abs().max()) for n in pa)
        same = bool((dl == 0).all()) and all(torch.equal(pa[n], pb[n]) for n in pa)
        print(f"engine (b): train_net checkpointed at step {k} on SIGTERM (rc {rc}); resumed "
              f"to {ENGINE_STEPS}: max |loss - (a)| {dl.max():.3e} over {len(dl)} steps, max "
              f"|param - (a)| {dp:.3e}; bit for bit: {same}")
        check(len(dl) == ENGINE_STEPS - k, f"resumed run took {len(dl)} steps from {k}")
        check(same, "SIGTERM + resume differs from the uninterrupted run")

        # (c) the other entry points
        zero_counts()
        net = run.main(["--type", "network", "--cfg_file", CFG_FILE, "--device", str(dev),
                        *opts("a")])
        print(f"engine (c): run --type network: {net['rays_per_sec']:.0f} rays/s, "
              f"{1000.0 / net['iters_per_sec']:.3f} ms/step ({engine.NETWORK_ITERS} steps of "
              f"{cfg.data.n_rays} rays after {tc.log_interval} warm-up steps), against a median "
              f"{np.median(plain):.3f} ms/step of (a)'s windows without a save or an "
              f"evaluation; {card}")
        zero_counts()
        files = run.main(["--type", "visualize", "--trajectory", "4", "--cfg_file", CFG_FILE,
                          "--device", str(dev), *opts("a")])
        a1 = launch_counts()["A1"]
        pngs = [f for f in files if f.endswith(".png") and os.path.getsize(f) > 0]
        print(f"  run --type visualize --trajectory 4: {len(files)} files ({len(pngs)} PNG), "
              f"A1 launches {a1}")
        check(a1 == len(test_ids) + 4, f"visualize launched A1 {a1} times, expected "
              f"{len(test_ids)} test views + 4 frames")
        check(len(pngs) == 6 * len(test_ids) + 4 * 4, f"visualize wrote {len(pngs)} PNG files")


# the six kernels, by the names of their launch counters (`kernels.launch.<name>`)
KERNELS = ("A1", "A2", "B", "B'", "C", "C'")


def zero_counts():
    """Clear the program's table of spans and counters (utils/profiling.py)."""
    from panopticnerf_tpu_torch.utils import profiling

    profiling.reset()


def launch_counts(names=KERNELS):
    """Launches of each kernel since the last `zero_counts()`."""
    from panopticnerf_tpu_torch.utils import profiling

    return {k: profiling.calls(f"kernels.launch.{k}") for k in names}


def cli(main, *args, out=None):
    """Run an entry point with its console lines kept out of this log
    (appended to the list `out` when given)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main([*args])
    if out is not None:
        out.append(buf.getvalue())
    return result


def same_scores(a, b):
    """Two evaluator summaries equal value for value (NaN equal to NaN),
    host timings aside."""
    keys = set(a) - {"render_seconds"}
    return keys == set(b) - {"render_seconds"} and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k]), equal_nan=True) for k in keys)


def render_gap(gpu, cpu):
    """(rgb max |d|, rgb mean |d|, depth max |d| / depth scale, share of rays
    whose learned semantic argmax agrees) of two RenderOuts of the same rays."""
    d_rgb = (gpu.rgb.cpu() - cpu.rgb).abs()
    d_depth = (gpu.depth.cpu() - cpu.depth).abs().max() / cpu.depth.abs().max().clamp_min(1e-6)
    agree = (gpu.sem_logits.cpu().argmax(-1) == cpu.sem_logits.argmax(-1)).float().mean()
    return float(d_rgb.max()), float(d_rgb.mean()), float(d_depth), float(agree)


def kitti_phase(dev, engine, tmp):
    """12. KITTI-360 on a demo tree (see the module docstring); returns its
    timings and what phase 13 (c) trains on again."""
    import shutil

    from panopticnerf_tpu_torch import export_label_transfer, run, train_net
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import labels as L
    from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
    from panopticnerf_tpu_torch.data.dataset import batch_intervals, sample_ray_batch
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
    from panopticnerf_tpu_torch.ops import intersect_cuda
    from panopticnerf_tpu_torch.ops.intersect import intersect_rays_plain
    from panopticnerf_tpu_torch.viz.png import read_png

    zero, counts = zero_counts, launch_counts
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    res = {}
    # (a) the tree
    t0 = time.perf_counter()
    seq = write_demo_tree(f"{tmp}/tree", n_frames=KITTI_FRAMES, hw=KITTI_HW, n_boxes=8,
                          seed=0, n_concave=2, frame_start=3353, device=dev)
    res["tree_s"] = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(f"{tmp}/tree")
               for f in fs)
    print(f"kitti (a): write_demo_tree {seq}, {KITTI_FRAMES} frames of {KITTI_HW[0]}x"
          f"{KITTI_HW[1]}, stereo, 8 boxes + 2 concave buildings: {res['tree_s']:.2f} s, "
          f"{size / 2**20:.1f} MiB")

    # (b) configs/kitti360_panoptic.yaml at full width
    opts = ["data.root", f"{tmp}/tree", "data.frame_num", str(KITTI_FRAMES),
            "train.pretrain_steps", "100", "train.ep_iter", "100", "train.save_ep", "2",
            "train.eval_ep", "2", "model_dir", f"{tmp}/m", "record_dir", f"{tmp}/rec",
            "result_dir", f"{tmp}/res"]
    cfg = load_config(KITTI_CFG, opts)
    args = ["--cfg_file", KITTI_CFG, "--device", str(dev), *opts]
    near, far, k = cfg.render.near, cfg.render.far, cfg.data.max_intervals
    g, n = cfg.data.views_per_batch, cfg.data.n_rays
    t0 = time.perf_counter()
    ds, train_ids, test_ids = make_dataset(cfg, dev)
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    check(ds.prim_planes is not None, "the demo tree's concave buildings gave no cut planes")
    f = ds.prim_planes.shape[2]
    n_real = int(((ds.prim_planes[..., :3] != 0).any(-1).any(-1) & ds.prim_valid).sum())
    n_valid = ds.prim_valid.sum(1)
    print(f"kitti (b): make_dataset in {res['build_s']:.2f} s: images "
          f"{tuple(ds.images.shape)}, prim_w2p {tuple(ds.prim_w2p.shape)}, prim_planes "
          f"{tuple(ds.prim_planes.shape)}, valid primitives per view "
          f"{int(n_valid.min())}-{int(n_valid.max())}, (view, primitive) pairs with a "
          f"real cut plane {n_real}; train {len(train_ids)} / test {len(test_ids)} views")
    check(n_real > 0, "every cut plane is all-pass")
    check(tuple(ds.images.shape) == (2 * KITTI_FRAMES, KITTI_HW[0] // 2, KITTI_HW[1] // 2, 3),
          f"images {tuple(ds.images.shape)}")
    has_gt = ds.gt_sem is not None
    gt_views = (torch.nonzero((ds.gt_sem != 255).flatten(1).any(1)).flatten().tolist()
                if has_gt else [])
    eval_views = sorted(set(gt_views) | set(int(v) for v in test_ids))
    same, total, bad = True, 0, 0
    for v in eval_views:
        o, d = view_rays(ds, v)
        prims = view_primitives(ds, v)
        out = intersect_cuda.intersect_rays_cuda(o, d, prims, near, far, k)
        ref = intersect_rays_plain(o, d, prims, near, far, k)
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b) for a, b in zip(out, ref))
        nn_, nb, _ = compare(out, ref)
        total, bad = total + nn_, bad + nb
    print(f"  A1 vs plain on the {len(eval_views)} evaluated views' tables (N = {o.shape[0]}, "
          f"P = {prims.world_to_prim.shape[0]}, F = {f}, K = {k}): {bad} of {total} entries "
          f"differ; bit for bit: {same}")
    check(same, "A1 differs from its plain version on the demo tree's tables")
    gen = torch.Generator(dev).manual_seed(4321)
    view_ids = torch.as_tensor(train_ids, device=dev)
    same, hits = True, 0
    for _ in range(20):
        batch = sample_ray_batch(ds, view_ids, n, g, gen)
        out = batch_intervals(ds, batch, near, far, k, g)
        ref = batch_intervals(ds, batch, near, far, k, g, use_kernel=False)
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b) for a, b in zip(out, ref))
        hits += int(out.mask.sum())
    print(f"  A2 vs plain on 20 training batches (G = {g}, M = {n // g}): bit for bit: "
          f"{same} ({hits} hit slots)")
    check(same, "A2 differs from its plain version on the demo tree's tables")
    # times at these shapes: A1 on the first test view, A2 on one batch
    v = int(test_ids[0])
    o, d = view_rays(ds, v)
    prims = view_primitives(ds, v)
    run_k = lambda: intersect_cuda.intersect_rays_cuda(o, d, prims, near, far, k)
    run_p = lambda: intersect_rays_plain(o, d, prims, near, far, k)
    t = {"a1_plain": time_ms(run_p), "a1": time_ms(run_k)}
    t["a1_plain2"], t["a1_2"] = time_ms(run_p), time_ms(run_k)
    t["a1_dev"], t["a1_host"] = device_ms(run_k, "intersect_kernel", reps=20), host_ms(run_k)
    p_all, p_val = prims.world_to_prim.shape[0], int(prims.valid.sum())
    t["a1_bound"] = bound(o.shape[0] * p_val * (SLAB_OPS + f * PLANE_OPS),
                          intersect_cuda.intersect_plan_bytes(1, o.shape[0], p_all, f, k),
                          PEAK_F32)
    batch = sample_ray_batch(ds, view_ids, n, g, gen)
    run_k = lambda: batch_intervals(ds, batch, near, far, k, g)
    run_p = lambda: batch_intervals(ds, batch, near, far, k, g, use_kernel=False)
    t["a2_plain"], t["a2"] = time_ms(run_p), time_ms(run_k)
    t["a2_plain2"], t["a2_2"] = time_ms(run_p), time_ms(run_k)
    t["a2_dev"], t["a2_host"] = device_ms(run_k, "intersect_kernel", reps=20), host_ms(run_k)
    gv = batch.view.reshape(g, n // g)[:, 0]
    t["a2_bound"] = bound((n // g) * int(ds.prim_valid[gv].sum()) * (SLAB_OPS + f * PLANE_OPS),
                          intersect_cuda.intersect_plan_bytes(g, n // g, p_all, f, k), PEAK_F32)
    res["t"] = t
    print(f"  A1 at N = {o.shape[0]}, P = {p_all} ({p_val} valid), F = {f}, K = {k}: kernel "
          f"{t['a1']:.4f} / {t['a1_2']:.4f} ms, plain {t['a1_plain']:.4f} / "
          f"{t['a1_plain2']:.4f} ms (events, median of 20, P K P K); device {t['a1_dev']:.5f} "
          f"ms, the wrapper's host time {t['a1_host']:.4f} ms; bound {t['a1_bound'][0]:.5f} "
          f"ms ({t['a1_bound'][1]})")
    print(f"  A2 (batch_intervals) at G = {g}, M = {n // g}, F = {f}: kernel {t['a2']:.4f} / "
          f"{t['a2_2']:.4f} ms, plain {t['a2_plain']:.4f} / {t['a2_plain2']:.4f} ms; device "
          f"{t['a2_dev']:.5f} ms, host {t['a2_host']:.4f} ms (the gathers of the group "
          f"tables included); bound {t['a2_bound'][0]:.5f} ms ({t['a2_bound'][1]}); {card}")
    del ds

    # the training main path
    zero()
    t0 = time.perf_counter()
    tr = cli(train_net.main, *args, "--max_steps", str(KITTI_STEPS))
    wall = time.perf_counter() - t0
    launches = counts()
    losses = tr["losses"]
    ms = [1000.0 * s / kk for kk, s in tr["windows"][1:]]
    res["ms_step"] = float(np.median(ms))
    n_eval = len(test_ids if cfg.train.eval_views <= 0 else test_ids[:cfg.train.eval_views])
    at100, end = float(losses[100:110].mean()), float(losses[-10:].mean())
    print(f"  train_net: {KITTI_STEPS} steps in {wall:.2f} s, median {res['ms_step']:.3f} "
          f"ms/step over {len(ms)} windows after the first (range {min(ms):.3f}-"
          f"{max(ms):.3f}); loss_total steps 1-10 {float(losses[:10].mean()):.4f}, 101-110 "
          f"(the semantic losses on) {at100:.4f}, last 10 {end:.4f}; in-training "
          f"evaluations {[(e[0], round(e[1], 3)) for e in tr['evals']]}; launches {launches}; "
          f"{card}")
    for step, secs, ev in tr["evals"]:
        print(f"  eval@{step}: PSNR {ev['psnr']:.4f}, mIoU {ev['miou']:.4f}, PQ {ev['pq']:.4f}")
    check(bool(np.isfinite(losses).all()), "non-finite KITTI-360 training loss")
    check(end < at100, f"KITTI-360 loss did not fall after step 100 ({at100} -> {end})")
    want = {"A1": len(tr["evals"]) * n_eval, "A2": KITTI_STEPS, "B": KITTI_STEPS,
            "B'": KITTI_STEPS, "C": 0, "C'": 0}
    check(len(tr["evals"]) == 1 and launches == want,
          f"KITTI-360 launches {launches}, expected {want}")

    zero()
    ev = cli(run.main, "--type", "evaluate", *args, "train.eval_step", str(KITTI_STEPS))
    a1 = counts()["A1"]
    print(f"  run --type evaluate: {len(ev['views'])} views, render s/view median "
          f"{np.median(ev['render_seconds']):.3f}; PSNR {ev['psnr']:.4f}, mIoU "
          f"{ev['miou']:.4f}, PQ {ev['pq']:.4f}; A1 launches {a1}")
    check(all(np.isfinite(ev[kk]) for kk in ("psnr", "miou", "pq")), "non-finite KITTI scores")
    check(ev["views"] == eval_views and a1 == len(eval_views),
          f"run_evaluate rendered {ev['views']} with A1 {a1}, expected {eval_views}")

    zero()
    t0 = time.perf_counter()
    files = cli(export_label_transfer.main, "--out", f"{tmp}/export", *args,
                "train.eval_step", str(KITTI_STEPS))
    secs, a1 = time.perf_counter() - t0, counts()["A1"]
    check(len(files) == 2 * KITTI_FRAMES and a1 == KITTI_FRAMES,
          f"the export wrote {len(files)} files with A1 {a1}")
    shutil.rmtree(f"{tmp}/tree/data_2d_semantics")
    shutil.copytree(f"{tmp}/export", f"{tmp}/tree/data_2d_semantics")
    back, _, _ = make_dataset(cfg, "cpu")
    exact = True
    for i in range(KITTI_FRAMES):
        sem = read_png(files[2 * i]).astype(np.int32)
        enc = read_png(files[2 * i + 1]).astype(np.int32)
        exact = (exact and np.array_equal(back.gt_sem[2 * i].numpy(), L.ids_to_trainids(sem))
                 and np.array_equal(back.gt_inst[2 * i].numpy(), enc % 1000)
                 and np.array_equal(enc // 1000, sem))
    print(f"  export_label_transfer: {len(files)} PNGs in {secs:.2f} s (A1 {a1}); read back "
          f"by the loader as data_2d_semantics bit for bit: {exact}")
    check(exact, "the export's round trip through the loader is not exact")
    del back

    res["args"], res["cfg"] = args, cfg
    return res


def stream_phase(dev, engine, tmp):
    """13 (a) configs/kitti360_360.yaml as shipped, streaming on; (b) the
    panorama on its checkpoint (see the module docstring)."""
    from panopticnerf_tpu_torch import run, train_net
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import stream as stream_mod
    from panopticnerf_tpu_torch.data import view_primitives
    from panopticnerf_tpu_torch.data.dataset import train_test_split
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.ops import intersect_cuda
    from panopticnerf_tpu_torch.ops.intersect import intersect_rays_plain
    from panopticnerf_tpu_torch.render import panorama_rays, render_panorama
    from panopticnerf_tpu_torch.train import eval_state_dict
    from panopticnerf_tpu_torch.train import step as step_module

    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    seqs = list(load_config(K360_CFG, []).data.sequences)
    t0 = time.perf_counter()
    for i, sq in enumerate(seqs):
        write_demo_tree(f"{tmp}/tree360", n_frames=K360_FRAMES, hw=KITTI_HW, n_boxes=8, seed=i,
                        seq=sq, fisheye=True, n_concave=2, frame_start=3353, device=dev)
    tree_s = time.perf_counter() - t0
    base = ["data.root", f"{tmp}/tree360", "data.frame_num", str(K360_FRAMES),
            "data.stream_refresh_steps", str(K360_REFRESH), "train.pretrain_steps",
            str(K360_PRETRAIN), "record_dir", f"{tmp}/rec360", "result_dir", f"{tmp}/res360"]
    args = lambda run_dir, *extra: ["--cfg_file", K360_CFG, "--device", str(dev), *base,
                                    "model_dir", f"{tmp}/{run_dir}", *extra]
    cfg = load_config(K360_CFG, base + ["model_dir", f"{tmp}/m360"])
    w, g, n = cfg.data.stream_window, cfg.data.views_per_batch, cfg.data.n_rays
    check(w == 64, f"configs/kitti360_360.yaml ships data.stream_window {w}")
    n_views = 3 * K360_FRAMES * len(seqs)
    train_ids, test_ids = train_test_split(n_views, cfg.data.test_every)
    print(f"stream (a): {len(seqs)} fisheye trees of {K360_FRAMES} frames ({n_views} views of "
          f"{KITTI_HW[0] // 2}x{KITTI_HW[1] // 2}, {len(train_ids)} for training) in "
          f"{tree_s:.2f} s; "
          f"configs/kitti360_360.yaml: window {w}, refreshed every {K360_REFRESH} steps, {n} rays "
          f"in G = {g} groups, semantic losses from step {K360_PRETRAIN}")
    check(len(train_ids) >= 2 * w, f"a training pool of {len(train_ids)} views for a window of {w}")

    made, equal, groups = [], [], []

    class Checked(stream_mod.ViewWindowStreamer):
        """The port's streamer, remembered; with `compare`, each window it
        swaps in is held against a synchronous upload of its host slice."""
        compare = False

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
            self._check(self.current())

        def advance(self):
            out = super().advance()
            self._check(out)
            return out

        def _check(self, win):
            if Checked.compare:
                ref = self.host.window(win[1])
                equal.append(all((a is None and b is None) or torch.equal(a, b)
                                 for a, b in zip(win[0], ref)))

    batch_intervals_of_step = step_module.batch_intervals

    def observed(ds_, batch, *a, **kw):  # each A2 group's view and camera model
        gv = batch.view.reshape(g, -1)[:, 0]
        groups.append((made[-1].current()[0] is ds_, ds_.images.shape[0], int(gv.max()),
                       ds_.cam_model[gv]))
        return batch_intervals_of_step(ds_, batch, *a, **kw)

    def train(run_dir, steps, *extra, out=None, observe=True):
        if observe:
            step_module.batch_intervals, engine.ViewWindowStreamer = observed, Checked
        try:
            return cli(train_net.main, *args(run_dir, *extra), "--max_steps", str(steps), out=out)
        finally:
            step_module.batch_intervals = batch_intervals_of_step
            engine.ViewWindowStreamer = stream_mod.ViewWindowStreamer

    want = {"A1": 0, "A2": K360_STEPS, "B": 2 * K360_STEPS, "B'": 2 * K360_STEPS, "C": 0, "C'": 0}
    ms_of = lambda tr: [1000.0 * s / k for k, s in tr["windows"][1:]]  # the first warms up

    # the streamed run, clean
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    logs = []
    tr = train("m360", K360_STEPS, out=logs)
    peak = torch.cuda.max_memory_allocated(dev) - before
    launches = launch_counts()
    st = tr["stream"]
    host = made[-1].host.ds  # the pool, on the host
    pool_bytes = nbytes(*host)
    view_bytes = sum(t[0].numel() * t.element_size() for name, t in host._asdict().items()
                     if t is not None and name in stream_mod.PER_VIEW)
    ms = ms_of(tr)
    refresh_lines = [ln for ln in logs[0].splitlines() if ln.startswith("stream window refresh")]
    for line in refresh_lines:
        print(f"  {line}")
    print(f"  windows (first step, views): {[(s_, len(ids)) for s_, ids in st['windows']]}; each "
          f"advance() blocked {[round(1e3 * b, 3) for b in st['blocked']]} ms, its copy already "
          f"done on the device: {st['ready']}")
    live = [x[0] for x in groups]
    in_window = all(live) and max(x[2] for x in groups) < w and {x[1] for x in groups} == {w}
    models = torch.cat([x[3] for x in groups]).tolist()
    print(f"  A2 groups: {len(groups)} steps x {g}, every group's view in the resident window "
          f"of {w}: {in_window}; "
          f"{models.count(1)} fisheye / {models.count(0)} perspective groups")
    print(f"  streamed: median {np.median(ms):.3f} ms/step over {len(ms)} windows of "
          f"{cfg.train.log_interval} after the first ({' '.join(f'{v:.3f}' for v in ms)}); "
          f"peak device memory {peak / 2**20:.1f} MiB above the "
          f"{before / 2**20:.1f} MiB allocated before; the host pool "
          f"{pool_bytes / 2**20:.1f} MiB, one view {view_bytes / 2**20:.3f} MiB, one window "
          f"{w * view_bytes / 2**20:.1f} MiB; launches {launches}; {card}")
    check(len(refresh_lines) == 3 and [s_ for s_, _ in st["windows"]] == [0, 25, 50, 75],
          f"refreshes {refresh_lines}, windows at {[s_ for s_, _ in st['windows']]}")
    check(in_window, "an A2 group read a view outside the resident window")
    check(models.count(1) > 0 and models.count(0) > 0, "the groups did not mix camera models")
    check(launches == want, f"streamed launches {launches}, expected {want}")
    check(bool(np.isfinite(tr["losses"]).all()), "non-finite streamed loss")

    # the same seed again, stopped at 60 and resumed, each window held against its host slice
    Checked.compare = True
    zero_counts()
    first = train("m360b", 60)
    again = train("m360b", K360_STEPS)
    Checked.compare = False
    losses = np.concatenate([first["losses"], again["losses"]])
    params_equal = all(torch.equal(v, again["state"].model.state_dict()[k])
                       for k, v in tr["state"].model.state_dict().items())
    print(f"  the same seed, stopped at 60 and resumed to {K360_STEPS}: losses equal bit for bit "
          f"{np.array_equal(losses, tr['losses'])}, parameters {params_equal}; windows after "
          f"the resume at {[s_ for s_, _ in again['stream']['windows']]}; {len(equal)} resident "
          f"windows equal to their host slice bit for bit: {all(equal)}; launches "
          f"{launch_counts()}")
    check(np.array_equal(losses, tr["losses"]) and params_equal,
          "two streamed runs of one seed (one resumed) differ")
    check(len(equal) == 5 and all(equal), f"resident windows vs host slices: {equal}")
    check(launch_counts() == want, f"launches of the resumed pair {launch_counts()}")
    del first, again
    made.clear()  # their resident windows, so that the next run starts from an empty card

    # the same run with the pool on the device
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before_flat = torch.cuda.memory_allocated(dev)
    flat = train("m360u", K360_STEPS, "data.stream_window", "0", observe=False)
    peak_flat = torch.cuda.max_memory_allocated(dev) - before_flat
    ms_flat = ms_of(flat)
    print(f"  data.stream_window 0: median {np.median(ms_flat):.3f} ms/step "
          f"({' '.join(f'{v:.3f}' for v in ms_flat)}); peak device memory "
          f"{peak_flat / 2**20:.1f} MiB "
          f"above the {before_flat / 2**20:.1f} MiB allocated before, against {peak / 2**20:.1f} "
          f"streamed; launches {launch_counts()}; {card}")
    check(launch_counts() == want and bool(np.isfinite(flat["losses"]).all()),
          f"unstreamed launches {launch_counts()}")
    del flat

    # run --type evaluate streamed and not: the same scores bit for bit
    evs = {}
    for window in ("64", "0"):
        zero_counts()
        evs[window] = cli(run.main, "--type", "evaluate", *args("m360"), "data.stream_window",
                          window, "train.eval_step", str(K360_STEPS))
        a1 = launch_counts()["A1"]
        ev = evs[window]
        print(f"  run --type evaluate at data.stream_window {window}: {len(ev['views'])} views, "
              f"render s/view median {np.median(ev['render_seconds']):.3f}; PSNR "
              f"{ev['psnr']:.4f}, mIoU {ev['miou']:.4f}, PQ {ev['pq']:.4f}; A1 {a1}")
        check(a1 == len(ev["views"]) and all(np.isfinite(ev[k]) for k in ("psnr", "miou", "pq")),
              f"evaluation at stream_window {window}: A1 {a1}")
    cams = host.cam_model.tolist()
    fe = [v for v in evs["64"]["views"] if cams[v] == 1]
    masked = [v for v in fe if not bool(engine._truth(host, v)["valid"].all())]
    print(f"  equal bit for bit: {same_scores(evs['64'], evs['0'])}; {len(fe)} fisheye views "
          f"evaluated, each with its valid mask ({len(masked)} mask pixels out)")
    check(same_scores(evs["64"], evs["0"]), "evaluation differs between stream_window 64 and 0")
    check(fe and masked == fe, f"fisheye views {fe}, masked {masked}")

    # (b) the panorama on (a)'s checkpoint
    zero_counts()
    t0 = time.perf_counter()
    files = cli(run.main, "--type", "visualize", "--panorama", ",".join(map(str, PANO_HW)),
                *args("m360"), "train.eval_step", str(K360_STEPS))
    secs = time.perf_counter() - t0
    a1 = launch_counts()["A1"]
    view = int(test_ids[len(test_ids) // 2])
    pano = sorted(os.path.basename(f) for f in files
                  if os.path.basename(f).startswith(f"{1_000_000 + view}_"))
    print(f"stream (b): run --type visualize --panorama {PANO_HW[0]},{PANO_HW[1]}: {len(files)} "
          f"files in {secs:.2f} s, panorama of view {view}: {pano}; A1 {a1} = {len(test_ids)} "
          f"test views + 1")
    check(a1 == len(test_ids) + 1, f"visualize launched A1 {a1} times")
    check(pano == [f"{1_000_000 + view}_{k}.png" for k in ("depth", "panoptic", "rgb", "semantic")],
          f"panorama files {pano}")
    model = make_network(cfg, dev).eval()
    model.load_state_dict(eval_state_dict(tr["state"]))
    pds, pv = engine._view_on(host, view, dev)
    c2w = pds.c2w[pv]
    o, d = panorama_rays(c2w[:, 3], c2w[:, :3], *PANO_HW)
    prims = view_primitives(pds, pv)
    near, far, k = cfg.render.near, cfg.render.far, cfg.data.max_intervals
    out = intersect_cuda.intersect_rays_cuda(o, d, prims, near, far, k)
    ref = intersect_rays_plain(o, d, prims, near, far, k)
    same = all(torch.equal(a, b) for a, b in zip(out, ref))
    t = {"a1": time_ms(lambda: intersect_cuda.intersect_rays_cuda(o, d, prims, near, far, k)),
         "plain": time_ms(lambda: intersect_rays_plain(o, d, prims, near, far, k), reps=5)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_panorama(model, pds, pv, PANO_HW, cfg)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    f, p_all = prims.cut_planes.shape[1], prims.world_to_prim.shape[0]
    p_val = int(prims.valid.sum())
    a1_bound = bound(o.shape[0] * p_val * (SLAB_OPS + f * PLANE_OPS),
                     intersect_cuda.intersect_plan_bytes(1, o.shape[0], p_all, f, k), PEAK_F32)
    print(f"  the panorama's A1 at N = {o.shape[0]}, P = {p_all} ({p_val} valid), F = {f}, K = "
          f"{k}: bit for bit with its plain version {same} ({int(out.mask.sum())} hit slots); "
          f"kernel {t['a1']:.4f} ms, plain {t['plain']:.4f} ms (events around the call); bound "
          f"{a1_bound[0]:.5f} ms ({a1_bound[1]}); render_panorama {render_s:.3f} s; {card}")
    check(same, "A1 differs from its plain version on the panorama's rays")
    small = (32, 64)
    gpu = render_panorama(model, pds, pv, small, cfg)
    cpu_model = make_network(cfg, "cpu").eval()
    cpu_model.load_state_dict({kk: v.cpu() for kk, v in model.state_dict().items()})
    cpu = render_panorama(cpu_model, stream_mod.views_to(host, [view], "cpu"), 0, small, cfg)
    gap = render_gap(gpu, cpu)
    print(f"  a {small[0]}x{small[1]} panorama, card against the CPU (plain versions): rgb max |d| "
          f"{gap[0]:.3e}, mean |d| {gap[1]:.3e}; depth max |d| / max depth {gap[2]:.3e}; learned "
          f"semantic argmax agrees on {100 * gap[3]:.2f} % of rays (tolerance {RENDER_GAP})")
    check(gap[0] <= RENDER_GAP["rgb max"] and gap[1] <= RENDER_GAP["rgb mean"]
          and gap[2] <= RENDER_GAP["depth"] and gap[3] >= RENDER_GAP["agree"],
          f"the card's panorama is off the CPU's: {gap}")
    return {"ms": float(np.median(ms)), "ms_flat": float(np.median(ms_flat))}


def mixed_phase(dev, kitti):
    """13 (c) fully mixed batches on phase 12's tree (see the module docstring)."""
    from panopticnerf_tpu_torch import train_net
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.data.dataset import batch_intervals, sample_ray_batch
    from panopticnerf_tpu_torch.ops.intersect import Primitives, intersect_rays_per_ray

    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    args = [*kitti["args"], "data.views_per_batch", "0"]
    args[args.index("model_dir") + 1] += "_mixed"
    zero_counts()
    tr = cli(train_net.main, *args, "--max_steps", str(MIXED_STEPS))
    launches = launch_counts()
    ms = [1000.0 * s / k for k, s in tr["windows"][1:]]
    losses = tr["losses"]
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    print(f"mixed (c): configs/kitti360_panoptic.yaml with data.views_per_batch 0, {MIXED_STEPS} "
          f"steps: median {np.median(ms):.3f} ms/step (range {min(ms):.3f}-{max(ms):.3f}) against "
          f"{kitti['ms_step']:.3f} grouped (phase 12 (b)); loss_total first 10 {first:.4f}, last "
          f"10 {last:.4f}; launches {launches}; {card}")
    want = {"A1": 0, "A2": 0, "B": MIXED_STEPS, "B'": MIXED_STEPS, "C": 0, "C'": 0}
    check(launches == want, f"mixed launches {launches}, expected {want}")
    check(bool(np.isfinite(losses).all()) and last < first,
          f"mixed loss not finite and falling ({first} -> {last})")
    # the whole-field kernels on mixed batches (the 4x64 coarse stays plain)
    zero_counts()
    args[args.index("model_dir") + 1] += "_field"
    fr = cli(train_net.main, *args, "model.pallas_mode", "field", "--max_steps",
             str(MIXED_FIELD_STEPS))
    launches = launch_counts()
    print(f"  model.pallas_mode field, {MIXED_FIELD_STEPS} steps: loss_total first 5 "
          f"{float(fr['losses'][:5].mean()):.4f}, last 5 {float(fr['losses'][-5:].mean()):.4f}; "
          f"launches {launches}")
    want = {"A1": 0, "A2": 0, "B": 0, "B'": 0, "C": MIXED_FIELD_STEPS, "C'": MIXED_FIELD_STEPS}
    check(launches == want and bool(np.isfinite(fr["losses"]).all()),
          f"mixed field-mode launches {launches}, expected {want}")

    cfg = load_config(KITTI_CFG, args[args.index("--device") + 2:])
    near, far, k, n = cfg.render.near, cfg.render.far, cfg.data.max_intervals, cfg.data.n_rays
    ds, train_ids, _ = make_dataset(cfg, dev)
    gen = torch.Generator(dev).manual_seed(99)
    batch = sample_ray_batch(ds, torch.as_tensor(train_ids, device=dev), n, 0, gen)
    out = batch_intervals(ds, batch, near, far, k, 0)
    vi = batch.view.cpu()
    cpu = intersect_rays_per_ray(
        batch.rays_o.cpu(), batch.rays_d.cpu(),
        Primitives(ds.prim_w2p.cpu()[vi], ds.prim_sem.cpu()[vi], ds.prim_inst.cpu()[vi],
                   ds.prim_valid.cpu()[vi], ds.prim_planes.cpu()[vi]), near, far, k)
    labels = all(torch.equal(a.cpu(), b) for a, b in
                 ((out.mask, cpu.mask), (out.semantic, cpu.semantic), (out.instance, cpu.instance)))
    hit = cpu.mask
    dt = max(float((out.t_in.cpu() - cpu.t_in)[hit].abs().max()),
             float((out.t_out.cpu() - cpu.t_out)[hit].abs().max())) if bool(hit.any()) else 0.0
    per_ray_ms = time_ms(lambda: batch_intervals(ds, batch, near, far, k, 0))
    print(f"  intersect_rays_per_ray on one batch of {n} rays (P = {ds.prim_w2p.shape[1]}, F = "
          f"{ds.prim_planes.shape[2]}, K = {k}), card against the CPU: masks and ids equal "
          f"{labels} ({int(hit.sum())} hit slots), max |dt| {dt:.3e} (tolerance {PER_RAY_DT}); "
          f"{per_ray_ms:.4f} ms on the card (batch_intervals, the per-ray gathers included); "
          f"{card}")
    check(labels and dt <= PER_RAY_DT, "the per-ray intersection differs between card and CPU")


def keep_phase(cfg, dev, engine, ds, model, full):
    """13 (d) keep-M evaluation of the flagship checkpoint (see the module
    docstring); `full` is phase 5's untruncated run_evaluate."""
    import dataclasses

    from panopticnerf_tpu_torch.data import view_primitives, view_rays
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.ops.intersect import intersect_rays
    from panopticnerf_tpu_torch.render import SceneBounds, eval_render_cfg, render_image_rays

    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    keep = lambda m: dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, eval_keep_samples=m))
    zero_counts()
    res = engine.run_evaluate(keep(KEEP_M), dev, log=lambda *a: None)
    a1 = launch_counts()["A1"]
    sv, sv_full = np.median(res["render_seconds"][1:]), np.median(full["render_seconds"][1:])
    print(f"keep (d): run_evaluate of the flagship checkpoint with render.eval_keep_samples "
          f"{KEEP_M}: PSNR {res['psnr']:.4f} / mIoU {res['miou']:.4f} / PQ {res['pq']:.4f} against "
          f"{full['psnr']:.4f} / {full['miou']:.4f} / {full['pq']:.4f} untruncated; {sv:.4f} "
          f"s/view "
          f"against {sv_full:.4f} (medians after the first view); A1 {a1}; {card}")
    check(a1 == len(res["views"]) and all(np.isfinite(res[k]) for k in ("psnr", "miou", "pq")),
          f"keep-M evaluation: A1 {a1} for {len(res['views'])} views")
    rc = eval_render_cfg(cfg).render
    s_all = rc.n_samples + rc.n_importance
    v = int(res["views"][0])
    untruncated = engine._render_view(cfg, model, ds, v)
    at_s = engine._render_view(keep(s_all), model, ds, v)
    same = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(untruncated, at_s))
    print(f"  render.eval_keep_samples {s_all} (= S) on view {v} equals the untruncated render "
          f"bit for bit: {same}")
    check(same, "keep-M at m = S changed the render")
    o, d = view_rays(ds, v)
    o, d = o[:4096], d[:4096]
    prims = view_primitives(ds, v)
    kc = keep(KEEP_M)
    near, far, k = cfg.render.near, cfg.render.far, cfg.data.max_intervals
    gpu = render_image_rays(model, o, d, SceneBounds(ds.bounds_center, ds.bounds_scale), kc,
                            iv=intersect_rays(o, d, prims, near, far, k))
    cpu_model = make_network(cfg, "cpu").eval()
    cpu_model.load_state_dict({kk: t.cpu() for kk, t in model.state_dict().items()})
    cprims = type(prims)(*[None if t is None else t.cpu() for t in prims])
    oc, dc = o.cpu(), d.cpu()
    cpu = render_image_rays(cpu_model, oc, dc,
                            SceneBounds(ds.bounds_center.cpu(), ds.bounds_scale.cpu()), kc,
                            iv=intersect_rays(oc, dc, cprims, near, far, k))
    gap = render_gap(gpu, cpu)
    print(f"  the first 4096 rays of view {v} at keep {KEEP_M}, card against the CPU: rgb max |d| "
          f"{gap[0]:.3e}, mean |d| {gap[1]:.3e}; depth max |d| / max depth {gap[2]:.3e}; "
          f"learned semantic argmax agrees on {100 * gap[3]:.2f} % (tolerance {RENDER_GAP})")
    check(gap[0] <= RENDER_GAP["rgb max"] and gap[1] <= RENDER_GAP["rgb mean"]
          and gap[2] <= RENDER_GAP["depth"] and gap[3] >= RENDER_GAP["agree"],
          f"the card's keep-M render is off the CPU's: {gap}")


def torchrun(nproc, kind, out, *args, on_line=None):
    """This script's child `kind` under `torchrun --standalone` on `nproc`
    ranks of this machine -> (exit code, console). `on_line(line)` sees each
    console line as it comes. The whole process group is killed after
    DP_TIMEOUT seconds and whenever the call ends, so no rank outlives it."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), os.path.abspath(__file__), "--child", kind, out, *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=REPO, env=dict(os.environ, PYTHONUNBUFFERED="1"),
                            start_new_session=True)

    def kill():
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)

    timer = threading.Timer(DP_TIMEOUT, kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if on_line is not None:
                on_line(line)
        rc = proc.wait()
    finally:
        timer.cancel()
        kill()
        proc.wait()
    return rc, "".join(lines)


def child_result(out, rank=0):
    return torch.load(os.path.join(out, f"rank{rank}.pt"), weights_only=False)


def time_collectives(world, n_params, reps=30):
    """Median ms (synchronised, host clock) of the step's collectives on
    `world`: the loss denominators' and the stats' stacks (16 floats stand
    for their 8-10), the flat gradient buffer, and the host group's SIGTERM
    flag."""
    out = {}
    for name, n in (("small", 16), ("gradients", n_params)):
        buf = torch.zeros(n, device=world.device)
        ts = []
        for i in range(reps + 3):
            torch.cuda.synchronize(world.device)
            t0 = time.perf_counter()
            world.all_reduce_(buf)
            torch.cuda.synchronize(world.device)
            ts.append(1000.0 * (time.perf_counter() - t0))
        out[name] = float(np.median(ts[3:]))
    ts = []
    for i in range(reps + 3):
        t0 = time.perf_counter()
        world.agree(False)
        ts.append(1000.0 * (time.perf_counter() - t0))
    out["flag"] = float(np.median(ts[3:]))
    out["per_step"] = 2 * out["small"] + out["gradients"] + out["flag"]
    return out


def child(kind, out, args):
    """A rank of phase 14 under torchrun: `train` runs `train_net.main(args)`
    (a `train_timed` run then times the collectives of a world of one over
    NCCL); `gloo2` joins two ranks sharing cuda:0 over gloo and runs (b) and
    (d) of phase 14. Each writes what the parent compares to <out>/rank<r>.pt."""
    rank = int(os.environ["RANK"])
    print(f"child pid {os.getpid()} rank {rank}", flush=True)
    if kind in ("train", "train_timed"):
        from panopticnerf_tpu_torch import train_net
        from panopticnerf_tpu_torch.parallel import maybe_init_distributed

        zero_counts()
        res = train_net.main(args)
        result = {"losses": res["losses"], "launches": launch_counts(), "steps": res["steps"],
                  "preempted": res["preempted"], "windows": res["windows"],
                  "checkpoint": res["checkpoint"]}
        if kind == "train_timed":
            from panopticnerf_tpu_torch import engine
            from panopticnerf_tpu_torch.config import load_config

            world = maybe_init_distributed("cuda", backend="nccl", rank=0, world_size=1,
                                           init_method=f"file://{out}/nccl_rendezvous")
            try:
                n = sum(p.numel() for p in res["state"].model.parameters())
                result["collectives"] = time_collectives(world, n)
                zero_counts()  # the tile-sharded render's NCCL gather, at one rank
                cfg = load_config(CFG_FILE, ["model_dir", os.path.join(REPO, "artifacts")])
                result["evaluate"] = engine.run_evaluate(cfg, world.device, log=lambda *a: None,
                                                         world=world)
                result["evaluate_launches"] = launch_counts()
            finally:
                world.close()
    elif kind == "gloo2":
        result = gloo2_child()
    else:
        raise SystemExit(f"chip_smoke: unknown child {kind!r}")
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def gloo2_child():
    """14 (b) and (d) on one rank of two sharing cuda:0 over gloo."""
    import hashlib

    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.models import init_params, make_network
    from panopticnerf_tpu_torch.parallel import (
        broadcast_state,
        make_parallel_train_step,
        maybe_init_distributed,
    )
    from panopticnerf_tpu_torch.train import make_train_state, make_train_step

    world = maybe_init_distributed("cuda:0", backend="gloo")
    dev = world.device
    try:
        cfg = load_config(CFG_FILE, ["model_dir", os.path.join(REPO, "artifacts")])
        ds, train_ids, _ = make_dataset(cfg, dev)
        view_ids = torch.as_tensor(np.asarray(train_ids), device=dev)
        result = {"modes": {}}

        def fresh(mcfg):
            model = make_network(mcfg, dev)
            init_params(model, torch.Generator(dev).manual_seed(0))
            return model, make_train_state(mcfg, model), torch.Generator(dev).manual_seed(1)

        for mode, n_steps in DP_GLOO_STEPS.items():
            mcfg = with_mode(cfg, mode)
            model, state, gen = fresh(mcfg)   # one process, on this rank alone
            single = {k: float(v) for k, v in
                      make_train_step(mcfg, model)(state, ds, view_ids, gen).items()}
            single_grads = {n: p.grad.detach().double() for n, p in model.named_parameters()
                            if p.grad is not None}
            del model, state
            model, state, gen = fresh(mcfg)
            broadcast_state(state, gen, world)
            step = make_parallel_train_step(mcfg, model, world)
            zero_counts()
            digests, ms = [], []
            for i in range(n_steps):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                stats = step(state, ds, view_ids, gen)
                torch.cuda.synchronize(dev)
                ms.append(1000.0 * (time.perf_counter() - t0))
                if i == 0:
                    first = {k: float(v) for k, v in stats.items()}
                    cos = {}
                    for n, p in model.named_parameters():
                        if p.grad is not None:
                            a, b = p.grad.detach().double().ravel(), single_grads[n].ravel()
                            na, nb = float(a.norm()), float(b.norm())  # a leaf no loss reaches: 0
                            cos[n] = 1.0 if na == nb == 0 else float(a @ b) / max(na * nb, 1e-30)
                digests.append(hashlib.sha256(b"".join(
                    v.detach().cpu().numpy().tobytes() for v in model.state_dict().values()
                )).hexdigest())
            result["modes"][mode] = {
                "launches": launch_counts(), "first": first, "single": single, "cos": cos,
                "digests": digests, "ms": ms,
                "n_params": sum(p.numel() for p in model.parameters())}
        result["collectives"] = time_collectives(world, result["modes"]["trunk"]["n_params"])

        zero_counts()
        result["evaluate"] = engine.run_evaluate(cfg, dev, log=lambda *a: None, world=world)
        result["evaluate_launches"] = launch_counts()
        return result
    finally:
        world.close()


def parallel_phase(phase10, phase5):
    """14. Data parallelism through torchrun (see the module docstring):
    (a) one NCCL rank against phase 10's trunk run, (b) two gloo ranks on
    the card against one process, (c) SIGTERM and resume against (a), (d)
    the two-rank evaluation against phase 5."""
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.engine import port_roots

    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    steps = TRAIN_STEPS["trunk"]
    with tempfile.TemporaryDirectory() as tmp:
        def train_args(name):
            return ["--cfg_file", CFG_FILE, "--max_steps", str(steps), "model_dir",
                    f"{tmp}/{name}", "record_dir", f"{tmp}/{name}_rec",
                    "model.pallas_mode", "trunk"]

        def final_params(name):
            cfg = load_config(CFG_FILE, train_args(name)[4:])
            ck = torch.load(os.path.join(port_roots(cfg).steps, f"{steps}.pt"),
                            map_location="cpu", weights_only=True)
            return ck["params"]

        # (a) torchrun, one rank over NCCL, against phase 10's non-distributed run
        os.makedirs(f"{tmp}/a_out")
        t0 = time.perf_counter()
        rc, log = torchrun(1, "train_timed", f"{tmp}/a_out", *train_args("a"))
        wall = time.perf_counter() - t0
        check(rc == 0, f"torchrun train_net (one NCCL rank): rc {rc}\n{log[-4000:]}")
        a = child_result(f"{tmp}/a_out")
        pa = final_params("a")
        same_losses = np.array_equal(a["losses"], phase10["losses"])
        same_params = all(torch.equal(pa[k], v) for k, v in phase10["params"].items())
        ms = [1000.0 * s / k for k, s in a["windows"][1:]]
        want = {"A1": 0, "A2": steps, "B": 2 * steps, "B'": 2 * steps, "C": 0, "C'": 0}
        col = a["collectives"]
        print(f"parallel (a): torchrun --nproc_per_node 1 train_net, NCCL, {steps} steps of "
              f"mode trunk in {wall:.2f} s of child wall time: median {np.median(ms):.3f} "
              f"ms/step (phase 10, not distributed: {phase10['ms_step']:.3f}); losses equal to "
              f"phase 10 bit for bit: {same_losses}, final parameters: {same_params}; launches "
              f"{a['launches']}; NCCL world-of-one collectives, median ms: 16 floats "
              f"{col['small']:.4f}, the {phase10['n_params']} gradients {col['gradients']:.4f}, "
              f"the gloo SIGTERM flag {col['flag']:.4f}, {col['per_step']:.4f} per step; {card}")
        check(same_losses and same_params, "one NCCL rank differs from the non-distributed run")
        check(a["launches"] == want, f"(a) launch counts {a['launches']}, expected {want}")
        ev = a["evaluate"]
        same = all(np.array_equal(ev[k], phase5[k]) for k in ("psnr", "miou", "pq"))
        print(f"  run_evaluate over the same NCCL world of one (tiles gathered by NCCL): PSNR "
              f"{ev['psnr']:.6f}, mIoU {ev['miou']:.6f}, PQ {ev['pq']:.6f}; equal to phase 5 "
              f"bit for bit: {same}; A1 launches {a['evaluate_launches']['A1']}")
        check(same, "(a) the NCCL world-of-one evaluation differs from phase 5")
        check(a["evaluate_launches"]["A1"] == len(phase5["views"]), "(a) evaluation A1 launches")

        # (c) SIGTERM to the rank, then a resume to the end, against (a)
        os.makedirs(f"{tmp}/c_out")
        pid, sent = [], []

        def on_line(line):
            if line.startswith("child pid "):
                pid.append(int(line.split()[2]))
            elif line.startswith("step ") and pid and not sent:
                os.kill(pid[0], signal.SIGTERM)
                sent.append(line.strip())

        rc, log = torchrun(1, "train", f"{tmp}/c_out", *train_args("c"), on_line=on_line)
        m = re.search(r"SIGTERM received: checkpointing at step (\d+) and exiting", log)
        check(rc == 0 and sent and m is not None, f"(c) SIGTERM run: rc {rc}\n{log[-4000:]}")
        k = int(m.group(1))
        stopped = child_result(f"{tmp}/c_out")
        rc, log = torchrun(1, "train", f"{tmp}/c_out", *train_args("c"), "train.resume", "true")
        check(rc == 0, f"(c) resumed run: rc {rc}\n{log[-4000:]}")
        resumed = child_result(f"{tmp}/c_out")
        pc = final_params("c")
        same = (stopped["preempted"] and np.array_equal(resumed["losses"], a["losses"][k:])
                and all(torch.equal(pc[n], v) for n, v in pa.items()))
        print(f"parallel (c): SIGTERM after '{sent[0][:40]}...': checkpointed at step {k}; "
              f"resumed to {steps} under torchrun: losses from {k} and final parameters equal "
              f"to (a) bit for bit: {same}")
        check(same, "(c) SIGTERM + resume under torchrun differs from (a)")

        # (b) and (d): two gloo ranks sharing the card
        os.makedirs(f"{tmp}/b_out")
        t0 = time.perf_counter()
        rc, log = torchrun(2, "gloo2", f"{tmp}/b_out")
        wall = time.perf_counter() - t0
        check(rc == 0, f"torchrun gloo2: rc {rc}\n{log[-4000:]}")
        r0, r1 = child_result(f"{tmp}/b_out", 0), child_result(f"{tmp}/b_out", 1)
        for mode, n_steps in DP_GLOO_STEPS.items():
            m0, m1 = r0["modes"][mode], r1["modes"][mode]
            rel = {k: abs(m0["first"][k] - v) / max(abs(v), 1e-12)
                   for k, v in m0["single"].items() if k.startswith("loss_")}
            cos = min(min(m0["cos"].values()), min(m1["cos"].values()))
            per = {"trunk": {"B": 2, "B'": 2}, "field": {"C": 2, "C'": 2}}[mode]
            want = {k: n_steps if k == "A2" else per.get(k, 0) * n_steps
                    for k in KERNELS}
            print(f"parallel (b) {mode}: 2 gloo ranks on one card, {n_steps} steps: median "
                  f"{np.median(m0['ms'][1:]):.3f} ms/step (rank 0; synchronised each step); "
                  f"ranks bit-equal after every step: {m0['digests'] == m1['digests']}; step 1 "
                  f"against one process: loss terms rel <= {max(rel.values()):.2e}, min "
                  f"per-leaf gradient cosine {cos:.6f}; launches per rank {m0['launches']} / "
                  f"{m1['launches']}; {card}")
            check(m0["digests"] == m1["digests"], f"(b) {mode}: the ranks' parameters differ")
            check(max(rel.values()) <= DP_STEP_REL, f"(b) {mode}: loss terms off one process {rel}")
            check(cos >= DP_MIN_COSINE, f"(b) {mode}: gradient cosine {cos} < {DP_MIN_COSINE}")
            check(m0["launches"] == want and m1["launches"] == want,
                  f"(b) {mode}: launches {m0['launches']} / {m1['launches']}, expected {want}")
        col = r0["collectives"]
        print(f"  gloo collectives on CUDA tensors (host-staged), median ms: 16 floats "
              f"{col['small']:.4f}, the gradients {col['gradients']:.4f}, the SIGTERM flag "
              f"{col['flag']:.4f}, {col['per_step']:.4f} per step; child wall {wall:.2f} s")
        ev, n_views = r0["evaluate"], len(phase5["views"])
        same = all(np.array_equal(ev[k], phase5[k]) for k in ("psnr", "miou", "pq"))
        print(f"parallel (d): run_evaluate on 2 gloo ranks: PSNR {ev['psnr']:.6f}, mIoU "
              f"{ev['miou']:.6f}, PQ {ev['pq']:.6f}; equal to phase 5 bit for bit: {same}; "
              f"A1 launches per rank {r0['evaluate_launches']['A1']} / "
              f"{r1['evaluate_launches']['A1']} for {n_views} views; rank 1 returned "
              f"{r1['evaluate']!r}")
        check(same, "(d) the two-rank evaluation differs from phase 5")
        check(r1["evaluate"] is None, "(d) rank 1 scored")
        check(r0["evaluate_launches"]["A1"] == r1["evaluate_launches"]["A1"] == n_views,
              "(d) A1 launches per rank differ from the views rendered")


def lpips_weights(path, seed=0):
    """A seeded random-weight .npz in tools/convert_lpips_weights.py's layout."""
    from panopticnerf_tpu_torch.eval.lpips import _ALEX_LAYERS

    rng = np.random.default_rng(seed)
    arrays, in_ch = {}, 3
    for i, (out_ch, k, _, _, _) in enumerate(_ALEX_LAYERS):
        arrays[f"conv{i}_w"] = rng.normal(0, 0.1, (out_ch, in_ch, k, k)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(0, 0.01, (out_ch,)).astype(np.float32)
        arrays[f"lin{i}"] = np.abs(rng.normal(0, 1, (out_ch,))).astype(np.float32)
        in_ch = out_ch
    np.savez(path, **arrays)
    return path


def staged_phase(dev, tmp):
    """15 (a) the staged chain through run_staged (see the module docstring);
    returns the stages' records and the options the chain ran with."""
    import warnings

    from panopticnerf_tpu_torch import run_staged

    argv = ["--synthesize-tree", f"{tmp}/tree", "--steps", str(STAGED_STEPS), "--device",
            str(dev), "model.use_pallas", "True", "render.use_pallas_intersect", "True",
            "model_dir", f"{tmp}/m", "record_dir", f"{tmp}/rec", "result_dir", f"{tmp}/res"]
    args = run_staged.parse_args(argv)
    logs, recs = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        chain = run_staged.run_chain(args, log=logs.append)
        while True:
            zero_counts()
            n_logs, n_warn = len(logs), len(caught)
            rec = next(chain, None)
            if rec is None:
                break
            rec.update(launches=launch_counts(), logs=logs[n_logs:],
                       warnings=[str(w.message) for w in caught[n_warn:]])
            recs.append(rec)
    check([r["name"] for r in recs] == run_staged.STAGES, "the chain ran other stages")
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    for i, rec in enumerate(recs):
        name, ev, text = rec["name"], rec["eval"], "\n".join(rec["logs"])
        ms = [1000.0 * s / k for k, s in rec["train"]["windows"][1:]]
        metrics = {k: v for k, v in ev.items() if isinstance(v, float)}
        cfg = rec["cfg"]
        want = {"A1": len(ev["views"]) if cfg.render.use_primitives else 0,
                "A2": STAGED_STEPS if cfg.render.use_primitives else 0,
                "B": STAGED_B[name] * STAGED_STEPS, "B'": STAGED_B[name] * STAGED_STEPS,
                "C": 0, "C'": 0}
        warm = "warm-started params from" in text
        gate = "warm-chained: in-run pretrain gate dropped" in text
        mismatch = [w for w in rec["warnings"] if "shape mismatch" in w]
        print(f"staged (a) {name}: train {rec['train_seconds']:.2f} s ({STAGED_STEPS} steps, "
              f"median {np.median(ms):.3f} ms/step over {len(ms)} windows after the first), "
              f"evaluate {rec['eval_seconds']:.2f} s ({len(ev['views'])} views); warm start "
              f"{warm}, pretrain gate dropped {gate}, shape mismatches warned "
              f"{len(mismatch)}; launches {rec['launches']}; "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())))
        check(warm == (i > 0), f"{name}: warm start logged {warm}")
        check(gate == (name in STAGED_GATED),
              f"{name}: pretrain gate dropped {gate}")
        check(rec["launches"] == want, f"{name}: launches {rec['launches']}, expected {want}")
        check(all(np.isfinite(v) for v in metrics.values()) and bool(metrics),
              f"{name}: non-finite metrics {metrics}")
        check(bool(np.isfinite(rec["train"]["losses"]).all()), f"{name}: non-finite loss")
    check(any("coarse." in w for w in recs[3]["warnings"] if "shape mismatch" in w),
          "kitti360_semantic's 8x256 coarse into the panoptic 4x64 coarse was not warned about")
    final = recs[3]["eval"]
    for key, floor in STAGED_FLOORS.items():
        check(final[key] > floor, f"kitti360_panoptic {key} {final[key]:.4f} <= {floor}")
    print(f"  {card}")
    return recs, args


def lpips_phase(cfg, dev, engine, ds, model, full, tmp):
    """15 (b) LPIPS on the flagship checkpoint (see the module docstring);
    `full` is phase 5's run_evaluate."""
    import dataclasses

    from panopticnerf_tpu_torch.eval.lpips import LPIPS

    path = lpips_weights(f"{tmp}/lpips.npz")
    with_w = lambda p: dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval,
                                                                         lpips_weights=p))
    scored = lambda a: {k: v for k, v in a.items() if k not in ("render_seconds", "lpips")}
    res = engine.run_evaluate(with_w(path), dev, log=lambda *a: None)
    same = same_scores(scored(res), scored(full))
    with open(REF_JSON) as fh:
        view = int(json.load(fh)["psnr_views"][0])
    h, w = ds.images.shape[1:3]
    pred = engine._render_view(cfg, model, ds, view).rgb.reshape(h, w, 3)
    gt = ds.images[view].float() / 255.0
    fn = LPIPS(path).to(dev)
    d_gpu, d_cpu = float(fn(pred, gt)), float(LPIPS(path)(pred.cpu(), gt.cpu()))
    gap = abs(d_gpu - d_cpu) / abs(d_cpu)
    ms = time_ms(lambda: fn(pred, gt))
    print(f"lpips (b): run_evaluate with eval.lpips_weights (random weights): LPIPS "
          f"{res.get('lpips', float('nan')):.6f} (the mean over the PSNR views); PSNR / mIoU / "
          f"PQ and every other score equal to phase 5 bit for bit: {same}; "
          f"render s/view {np.median(res['render_seconds']):.3f} (phase 5: "
          f"{np.median(full['render_seconds']):.3f}); one view ({h}x{w}) on the card "
          f"{d_gpu:.7f}, on the CPU {d_cpu:.7f}, relative gap {gap:.2e} (tol {LPIPS_RTOL}); "
          f"LPIPS {ms:.3f} ms per view on the card (events, median of 20)")
    check(same, "the evaluation with LPIPS moved the other scores")
    check("lpips" in res and np.isfinite(res["lpips"]), "no finite lpips score")
    check(gap <= LPIPS_RTOL, f"LPIPS on the card is {gap:.2e} off the CPU")
    cut = f"{tmp}/cut.npz"
    with open(path, "rb") as src, open(cut, "wb") as dst:
        dst.write(src.read()[:4096])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bad = engine.run_evaluate(with_w(cut), dev, log=lambda *a: None)
    disabled = "LPIPS disabled" in buf.getvalue()
    same = same_scores(scored(bad), scored(full)) and "lpips" not in bad
    print(f"  a truncated weights file: 'LPIPS disabled' printed: {disabled}; the scores equal "
          f"phase 5 bit for bit, no lpips: {same}")
    check(disabled and same, "a truncated weights file did not disable LPIPS cleanly")


def sweep_phase(dev, recs, args, tmp):
    """15 (c) landing_sweep and pq_analysis on (a)'s final checkpoint."""
    from panopticnerf_tpu_torch import engine, run_staged
    from panopticnerf_tpu_torch.tools import landing_sweep, pq_analysis

    final = recs[3]
    cfg = final["cfg"]
    common = ["--cfg_file", KITTI_CFG, "--device", str(dev),
              *run_staged.common_options(args)]
    logs = []
    zero_counts()
    out = landing_sweep.main([*common, "--ckpts", f"final={engine.port_roots(cfg).steps}",
                              "--blends", "0,0.25,0.5,0.75,1", "--sky_rules", "off",
                              "--out", f"{tmp}/ls.json"], log=logs.append)
    a1 = launch_counts()["A1"]
    n_views = int(re.search(r"rendered (\d+) GT views", logs[0]).group(1))
    secs = [float(re.search(r"in ([\d.]+) s", logs[i]).group(1)) for i in (0, 1)]
    row = [r for r in out["rows"] if r["rule"] == cfg.eval.fusion_rule
           and r["blend"] == cfg.loss.eval_fixed_blend and r["sky_rule"] == cfg.eval.sky_rule]
    ev = final["eval"]
    print(f"sweep (c): landing_sweep on the final checkpoint: {len(out['rows'])} variants "
          f"(blends 0-1 x rules match, raw), {n_views} GT views rendered once, A1 launches "
          f"{a1}; cache {secs[0]:.3f} s, grid {secs[1]:.3f} s; pick {out['pick']['rule']} "
          f"blend {out['pick']['blend']}; the shipped row {row} against run_evaluate mIoU "
          f"{ev['miou']:.6f}, PQ {ev['pq']:.6f}")
    check(len(out["rows"]) == 10 and a1 == n_views, f"the sweep rendered {a1} times")
    check(len(row) == 1 and row[0]["miou"] == round(ev["miou"], 4)
          and row[0]["pq"] == round(ev["pq"], 4), "the shipped row differs from run_evaluate")
    rep = pq_analysis.main([*common, "--out", f"{tmp}/pq"], log=logs.append)
    pngs = [f for f in os.listdir(f"{tmp}/pq") if f.startswith("errmap_view")]
    print(f"  pq_analysis: report.json with {len(rep['sweep'])} sweep rows and "
          f"{len(rep['misses'])} unmatched thing segments, {len(pngs)} error maps")
    check(os.path.exists(f"{tmp}/pq/report.json") and len(pngs) == n_views,
          f"pq_analysis wrote {len(pngs)} error maps for {n_views} views")


def host_tools_phase(dev, recs, args, tmp):
    """15 (d) compute_visible_ids and xview_diag on (a)'s tree."""
    import dataclasses
    import shutil

    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.data.demo_tree import SEQ
    from panopticnerf_tpu_torch.tools import compute_visible_ids, xview_diag

    tree, copy = args.synthesize_tree, f"{tmp}/vtree"
    shutil.copytree(tree, copy)
    shutil.rmtree(f"{copy}/visible_id")
    t0 = time.perf_counter()
    out = compute_visible_ids.main(["--root", copy, "--sequence", SEQ], log=lambda *a: None)
    secs = time.perf_counter() - t0
    cfg = recs[3]["cfg"]
    ds, train_ids, _ = make_dataset(cfg, dev)
    ds2, train_ids2, _ = make_dataset(
        dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, root=copy)), dev)
    diff = [k for k in ds._fields if getattr(ds, k) is not None
            and not torch.equal(getattr(ds, k), getattr(ds2, k))]
    valid, valid2 = int(ds.prim_valid.sum()), int(ds2.prim_valid.sum())
    print(f"host (d): compute_visible_ids wrote {len(os.listdir(out))} frames in {secs:.3f} s; "
          f"the training set from its files against the tree's own: fields that differ {diff}, "
          f"valid (view, primitive) pairs {valid2} against {valid} (the tree lists every "
          f"annotation in every frame, the tool those in the frustum within 120 m or around "
          f"the camera), the same training views: {np.array_equal(train_ids, train_ids2)}")
    check(set(diff) <= {"prim_w2p", "prim_sem", "prim_inst", "prim_valid", "prim_planes"}
          and 0 < valid2 <= valid, f"the loader read the tool's files into another set: {diff}")
    noisy = f"{tmp}/noisy"
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "corrupt_pseudo.py"), "--src",
                    tree, "--dst", noisy, "--frac", "0.15", "--seed", "0"], check=True,
                   capture_output=True)
    t0 = time.perf_counter()
    rep = xview_diag.main(["--clean", tree, "--noisy", noisy, "--grid", "splat:2:0.1:2:0",
                           "--cfg_file", KITTI_CFG, "--out", f"{tmp}/xv.json", "--device",
                           str(dev)], log=lambda *a: None)
    row = rep["grid"][0]
    print(f"  xview_diag (clean tree against its tools/corrupt_pseudo.py clone, one row) in "
          f"{time.perf_counter() - t0:.2f} s: pre-clean noise {rep['pre_clean_noise']}, {row}")
    check(rep["pre_clean_noise"] > 0 and all(np.isfinite(row[k]) for k in
                                              ("caught", "erosion", "residual")),
          f"xview_diag: {rep}")


def profiling_phase(cfg, dev, engine, trunk_ms, tmp):
    """15 (e) trace() around three flagship steps, timed() on one step."""
    from panopticnerf_tpu_torch.train import make_train_step
    from panopticnerf_tpu_torch.utils import timed, trace

    tcfg = with_mode(cfg, "trunk")
    ds, train_ids, _, model, state = engine._build(tcfg, dev)
    step = make_train_step(tcfg, model)
    view_ids = torch.as_tensor(np.asarray(train_ids), device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    for _ in range(3):
        step(state, ds, view_ids, gen)
    path = f"{tmp}/trace/trace.json"
    for attempt in range(1, PROFILE_ATTEMPTS + 1):  # as device_ms: CUPTI may drop a session
        t0 = time.perf_counter()
        with trace(f"{tmp}/trace"):
            for _ in range(3):
                step(state, ds, view_ids, gen)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with open(path) as fh:
            names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
        found = {k: any(pat in n for n in names) for k, pat in (
            ("A2", "intersect_kernel"), ("B", "trunk_fwd_kernel"),
            ("B'", "trunk_bwd_data_kernel"), ("B' weights", "wgrad_kernel"))}
        if all(found.values()):
            break
        print(f"profiling (e): trace {attempt} of {PROFILE_ATTEMPTS} names {found}")
    # as phase 10's windows: the first 20 steps warm up, 20 are timed
    ms = 1000.0 * timed(step, state, ds, view_ids, gen, iters=20, warmup=20)
    print(f"profiling (e): trace() around 3 flagship steps: {os.path.getsize(path) / 2**20:.1f} "
          f"MiB Chrome trace in {secs:.2f} s, kernels named: {found}; timed(): {ms:.3f} ms/step "
          f"(20 steps after 20) beside phase 10's {trunk_ms:.3f} ms/step (mode trunk)")
    check(all(found.values()), f"the trace does not name every kernel: {found}")


def fullres_phase(dev, tmp):
    """17. the full-resolution protocol's tree, a short run (see the module docstring)."""
    from panopticnerf_tpu_torch import export_label_transfer, run, train_net
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import labels as L
    from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
    from panopticnerf_tpu_torch.data.kitti360 import _load_gt_sem_inst
    from panopticnerf_tpu_torch.ops import intersect_cuda
    from panopticnerf_tpu_torch.ops.intersect import intersect_rays_plain
    from panopticnerf_tpu_torch.run_staged import tree_presets
    from panopticnerf_tpu_torch.tools import check_data
    from panopticnerf_tpu_torch.viz.png import read_png

    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    tree = f"{tmp}/fulltree"
    t0 = time.perf_counter()
    seq = write_demo_tree(tree, n_frames=FULL_FRAMES, hw=KITTI_HW, n_boxes=FULL_BOXES,
                          n_concave=FULL_CONCAVE, fisheye=True, device=dev)
    secs = time.perf_counter() - t0
    print(f"fullres (a): write_demo_tree {FULL_FRAMES} stereo frames of {KITTI_HW[0]}x"
          f"{KITTI_HW[1]} with fisheye, {FULL_BOXES} boxes + {FULL_CONCAVE} concave buildings in "
          f"{secs:.2f} s; {card}")

    # (b) the layout checker on it, with the fisheye streams required
    presets = tree_presets(tree, FULL_FRAMES, KITTI_HW, FULL_BOXES, FULL_CONCAVE)
    lines = []
    rc = check_data.main(["--cfg_file", KITTI_CFG, *presets, "data.use_fisheye", "true"],
                         log=lines.append)
    rep = check_data.check_tree(tree, seq, list(range(FULL_FRAMES)), use_fisheye=True)
    width = max(len(k) for k in rep)
    want = [f" {'+' if st == 'ok' else '!' if req else '~'} {name:<{width}}  {st:<8} "
            f"{'required' if req else 'optional':<9} {detail}"
            for name, (st, req, detail) in rep.items()]
    units = lines[len(rep)]
    required_ok = all(st == "ok" for st, req, _ in rep.values() if req)
    print(f"  check_data: exit code {rc}, {len(rep)} streams "
          f"({sum(req for _, req, _ in rep.values())} required, all ok: {required_ok}; optional "
          f"not ok: {[k for k, (st, req, _) in rep.items() if not req and st != 'ok']}), the "
          f"printed report equal to check_tree's: {lines[:len(rep)] == want}; {units.strip()}")
    check(rc == 0 and required_ok and lines[:len(rep)] == want and " + depth/units" in units
          and lines[-1].startswith("\nOK"), f"check_data on the full-resolution tree: {lines}")

    # (c) the training main path at full resolution, then its evaluation
    opts = [*presets, "train.pretrain_steps", str(FULL_STEPS // 2), "model_dir", f"{tmp}/fm",
            "record_dir", f"{tmp}/frec", "result_dir", f"{tmp}/fres"]
    cfg = load_config(KITTI_CFG, opts)
    args = ["--cfg_file", KITTI_CFG, "--device", str(dev), *opts]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    tr = cli(train_net.main, *args, "--max_steps", str(FULL_STEPS))
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = [1000.0 * s / kk for kk, s in tr["windows"][1:]]
    losses = tr["losses"]
    print(f"  train_net (ratio 1.0: {2 * FULL_FRAMES} views of {KITTI_HW[0] * KITTI_HW[1]:,} "
          f"rays, P = {cfg.data.max_primitives}, K = {cfg.data.max_intervals}): {FULL_STEPS} "
          f"steps in {wall:.2f} s, median {np.median(ms):.3f} ms/step over {len(ms)} windows "
          f"after the first; loss_total first 10 {float(losses[:10].mean()):.4f}, last 10 "
          f"{float(losses[-10:].mean()):.4f}; peak device memory {peak:.2f} GiB; launches "
          f"{launches}")
    want = {"A1": 0, "A2": FULL_STEPS, "B": FULL_STEPS, "B'": FULL_STEPS, "C": 0, "C'": 0}
    check(bool(np.isfinite(losses).all()) and launches == want and not tr["evals"],
          f"full-resolution training: launches {launches}, expected {want}")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    ev = cli(run.main, "--type", "evaluate", *args)
    a1 = launch_counts()["A1"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    secs = ev["render_seconds"]
    print(f"  run --type evaluate at {KITTI_HW[0]}x{KITTI_HW[1]}: {len(ev['views'])} views, "
          f"render s/view median {np.median(secs):.3f} (range {min(secs):.3f}-{max(secs):.3f}); "
          f"PSNR {ev['psnr']:.4f}, mIoU {ev['miou']:.4f}, PQ {ev['pq']:.4f}; A1 launches {a1}; "
          f"peak device memory {peak:.2f} GiB")
    check(all(np.isfinite(ev[kk]) for kk in ("psnr", "miou", "pq")) and ev["step"] == FULL_STEPS
          and a1 == len(ev["views"]) > 0, f"full-resolution evaluation: {a1} A1 launches, {ev}")

    # (d) A1 on one full view against the plain version
    t0 = time.perf_counter()
    ds, _, test_ids = make_dataset(cfg, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(tuple(ds.images.shape[1:3]) == KITTI_HW, f"images {tuple(ds.images.shape)}")
    near, far, k = cfg.render.near, cfg.render.far, cfg.data.max_intervals
    o, d = view_rays(ds, int(test_ids[0]))
    prims = view_primitives(ds, int(test_ids[0]))
    n, p_all, f = o.shape[0], prims.world_to_prim.shape[0], prims.cut_planes.shape[1]
    p_val = int(prims.valid.sum())
    run_k = lambda: intersect_cuda.intersect_rays_cuda(o, d, prims, near, far, k)
    run_p = lambda: intersect_rays_plain(o, d, prims, near, far, k)
    out, ref = run_k(), run_p()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(out, ref))
    _, bad, _ = compare(out, ref)
    t = {"plain_ms": time_ms(run_p), "ms": time_ms(run_k)}
    t["plain_ms2"], t["ms2"] = time_ms(run_p), time_ms(run_k)
    t["dev"], t["host"] = device_ms(run_k, "intersect_kernel", reps=20), host_ms(run_k)
    t["bound"] = bound(n * p_val * (SLAB_OPS + f * PLANE_OPS),
                       intersect_cuda.intersect_plan_bytes(1, n, p_all, f, k), PEAK_F32)
    print(f"  A1 on test view {int(test_ids[0])} (make_dataset {build_s:.2f} s): N = {n}, P = "
          f"{p_all} ({p_val} valid), F = {f}, K = {k}: {bad} entries differ from the plain "
          f"version, bit for bit: {same} ({int(out.mask.sum())} hit slots); kernel {t['ms']:.4f} / "
          f"{t['ms2']:.4f} ms, plain {t['plain_ms']:.4f} / {t['plain_ms2']:.4f} ms (events, "
          f"median of 20, P K P K); device {t['dev']:.5f} ms, the wrapper's host time "
          f"{t['host']:.4f} ms; bound {t['bound'][0]:.5f} ms ({t['bound'][1]}); {card}")
    check(n == KITTI_HW[0] * KITTI_HW[1] and same and int(out.mask.sum()) > 0,
          "A1 differs from its plain version on the full-resolution view")
    del ds

    # (e) the label-transfer export, one view read back by the loader
    zero_counts()
    t0 = time.perf_counter()
    files = cli(export_label_transfer.main, "--out", f"{tmp}/fexport", *args)
    secs, a1 = time.perf_counter() - t0, launch_counts()["A1"]
    check(len(files) == 2 * FULL_FRAMES and a1 == FULL_FRAMES,
          f"the export wrote {len(files)} files with A1 {a1}")
    frame = FULL_FRAMES // 2  # the tree's frames are numbered from 0
    os.makedirs(f"{tmp}/fback")
    os.symlink(f"{tmp}/fexport", f"{tmp}/fback/data_2d_semantics")
    sem, inst = _load_gt_sem_inst(f"{tmp}/fback", seq, frame, KITTI_HW)
    raw = read_png(files[2 * frame]).astype(np.int32)
    enc = read_png(files[2 * frame + 1]).astype(np.int32)
    exact = (np.array_equal(L.ids_to_trainids(sem), L.ids_to_trainids(raw))
             and np.array_equal(inst, enc % 1000) and np.array_equal(enc // 1000, raw))
    print(f"  export_label_transfer: {len(files)} PNGs of {KITTI_HW[0]}x{KITTI_HW[1]} in "
          f"{secs:.2f} s (A1 {a1}); frame {frame} read back by the loader bit for bit: {exact}")
    check(exact, "the full-resolution export's round trip is not exact")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import view_primitives, view_rays
    from panopticnerf_tpu_torch.ops import (
        _nvcc,
        composite_cuda,
        field_eval_cuda,
        field_train_cuda,
        hash_grid_cuda,
        intersect_cuda,
        mlp_train_cuda,
        sampling_cuda,
    )
    from panopticnerf_tpu_torch.ops.intersect import intersect_rays_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. card and versions
    print(sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{sh([_nvcc.nvcc_path(), '--version']).splitlines()[-1]}")

    # 2. build: one nvcc per source, run together
    libs = {name: _nvcc.library_path(name)
            for name in ("intersect", "mlp_train", "field_train", "field_eval", "hash_grid",
                         "composite", "sample")}
    existed = {name: os.path.exists(path) for name, path in libs.items()}
    t0 = time.perf_counter()
    _nvcc.build_all(libs)
    secs = time.perf_counter() - t0
    for name, path in libs.items():
        print(f"build: {name}.cu -> {os.path.relpath(path, REPO)}: "
              + ("an existing build, loaded" if existed[name]
                 else f"compiled with nvcc in {secs:.2f} s (all sources together)"))
    intersect_cuda.load()
    mlp_train_cuda.load()
    field_train_cuda.load()
    field_eval_cuda.load()
    hash_grid_cuda.load()
    composite_cuda.load()
    sampling_cuda.load()
    for name, kernel in (("composite", "V"), ("sample", "Z")):
        for line in ptxas_summary(libs[name][:-3] + ".log"):
            print(f"  ptxas {name}: {line}")
            check(line.endswith("spills 0/0 B"), f"{kernel} spills: {line}")
    for name in ("mlp_train", "field_train", "field_eval"):
        for line in ptxas_summary(libs[name][:-3] + ".log"):
            print(f"  ptxas {name}: {line}")
            if re.match(r"(trunk|field)_fwd_kernel|field_bwd_heads_kernel|field_eval_kernel", line):
                check(line.endswith("spills 0/0 B"), f"a wgmma kernel spills: {line}")
        for line in open(libs[name][:-3] + ".log"):  # ptxas: a chain waited out product by product
            check(not ("serialized" in line and ("_fwd_kernel" in line or "heads_kernel" in line
                                                 or re.search(r"eval_kernelILi(128|256)", line))),
                  f"ptxas serializes a kernel's wgmma chains: {line.strip()}")

    # 3. kernel vs plain at the slice's shape
    cfg = load_config(CFG_FILE, ["model_dir", os.path.join(REPO, "artifacts")])
    near, far, k = cfg.render.near, cfg.render.far, cfg.data.max_intervals
    ds, _, model, _ = engine._restore_for_eval(cfg, dev)
    n_views = ds.images.shape[0]
    max_dt = 0.0
    for case, f in (("F=0", 0), ("F=8", 8)):
        total = bad = 0
        same = True
        for v in range(n_views):
            o, d = view_rays(ds, v)
            prims = view_primitives(ds, v)
            if f:
                p = prims.world_to_prim.shape[0]
                prims = prims._replace(cut_planes=torch.from_numpy(cut_planes(p, f, v)).to(dev))
            out = intersect_cuda.intersect_rays_cuda(o, d, prims, near, far, k)
            ref = intersect_rays_plain(o, d, prims, near, far, k)
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, b) for a, b in zip(out, ref))
            n, nb, dt = compare(out, ref)
            total, bad, max_dt = total + n, bad + nb, max(max_dt, dt)
            hits = int(out.mask.sum())
        share = bad / total
        print(f"kernel vs plain, {case}: {n_views} views x {o.shape[0]} rays x K={k} "
              f"(P={prims.world_to_prim.shape[0]}): {bad} of {total} entries differ "
              f"({share:.2e}), max |dt| where they agree {max_dt:.3e} "
              f"(last view: {hits} hit slots); bit for bit: {same}")
        check(same, f"A1 {case}: the kernel differs from its plain version")

    # 4. times at the view shape
    o, d = view_rays(ds, 0)
    prims = view_primitives(ds, 0)
    run_k = lambda: intersect_cuda.intersect_rays_cuda(o, d, prims, near, far, k)
    run_p = lambda: intersect_rays_plain(o, d, prims, near, far, k)
    plain_ms, kernel_ms = time_ms(run_p), time_ms(run_k)
    plain_ms2, kernel_ms2 = time_ms(run_p), time_ms(run_k)
    a1_dev, a1_host = device_ms(run_k, "intersect_kernel", reps=20), host_ms(run_k)
    p = prims.world_to_prim.shape[0]
    a1_bound = bound(o.shape[0] * p * SLAB_OPS,
                     intersect_cuda.intersect_plan_bytes(1, o.shape[0], p, 0, k), PEAK_F32)
    print(f"intersect at N={o.shape[0]}, P={p}, K={k}: "
          f"kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms, "
          f"plain {plain_ms:.4f} / {plain_ms2:.4f} ms (events around the call, median of 20, "
          f"plain-kernel-plain-kernel); device time {a1_dev:.5f} ms (torch.profiler, mean of "
          f"20), the wrapper's host time {a1_host:.4f} ms per call; "
          f"bound {a1_bound[0]:.5f} ms ({a1_bound[1]})")

    # 5. the main path
    zero_counts()
    res = engine.run_evaluate(cfg, dev, log=lambda *a: None)
    launches, e_launches = launch_counts()["A1"], launch_counts(("E",))["E"]
    v_launches, z_launches = launch_counts(("V",))["V"], launch_counts(("Z",))["Z"]
    secs = res["render_seconds"]
    tiles = -(-ds.images.shape[1] * ds.images.shape[2] // cfg.render.ray_tile)
    print(f"run_evaluate: {len(res['views'])} views, render s/view "
          + " ".join(f"{s:.3f}" for s in secs)
          + f" (median {np.median(secs):.3f}, first view includes warm-up); "
          f"kernel launches A1 {launches}, E {e_launches}, V {v_launches}, Z {z_launches} "
          f"({tiles} tiles x 2 levels a view)")
    check(launches == len(res["views"]),
          f"kernel launched {launches} times for {len(res['views'])} views")
    check(e_launches == v_launches == z_launches == 2 * tiles * len(res["views"]),
          f"E / V / Z launched {e_launches} / {v_launches} / {z_launches} times for "
          f"{len(res['views'])} views of {tiles} tiles")
    with open(REF_JSON) as fh:
        ref = json.load(fh)
    check(sorted(ref["views"]) == sorted(res["views"]),
          f"reference covers views {ref['views']}, the port rendered {res['views']}")
    for key, tol in TOL.items():
        a, b = res[key], ref["overall"][key]
        print(f"  {key}: port {a:.6f}  JAX reference {b:.6f}  |d| {abs(a - b):.6f} (tol {tol})")
        check(np.isfinite(a) and abs(a - b) <= tol, f"{key} off the reference")
    view = int(ref["psnr_views"][0])
    out = engine._render_view(cfg, model, ds, view)
    h, w = ds.images.shape[1:3]
    check(tuple(out.rgb.shape) == (h * w, 3) and bool(torch.isfinite(out.rgb).all())
          and bool(torch.isfinite(out.sem_logits).all()), "non-finite or misshaped render")
    ev_field = eval_field_phase(cfg, ds, model)
    ev_grid = grid_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ev_comp = composite_phase(dev, tmp)
        ev_sample = sampling_phase(dev, tmp)

    # 6-10. the training slice
    from panopticnerf_tpu_torch.data import make_dataset

    ds_t, train_ids, _ = make_dataset(cfg, dev)
    a2_dt, a2_ms, a2_plain_ms, a2_bound = a2_phase(cfg, ds_t, train_ids, dev, intersect_cuda)
    enc = sample_encodings(cfg, ds_t, train_ids, model, dev)
    trunk = trunk_phase(cfg, enc, model, dev)
    field = field_phase(cfg, enc, model, dev)
    del enc
    for mode in MODES:
        step_phase(cfg, ds_t, dev, mode)
    del ds_t
    torch.cuda.empty_cache()
    runs = {mode: train_phase(cfg, dev, engine, mode) for mode in MODES}
    train = {mode: run[0] for mode, run in runs.items()}

    # 11. the engine around the step
    from panopticnerf_tpu_torch import run

    engine_phase(dev, engine, run)

    # 12. KITTI-360 on a demo tree; 13 (a)-(c) streaming, the panorama, mixed batches
    with tempfile.TemporaryDirectory() as tmp:
        kitti = kitti_phase(dev, engine, tmp)
        stream_phase(dev, engine, tmp)
        mixed_phase(dev, kitti)
    # 13 (d) keep-M on the flagship checkpoint, beside phase 5's full render
    keep_phase(cfg, dev, engine, ds, model, res)

    # 14. data parallelism: torchrun children against phases 10 and 5
    _, trunk_ms, trunk_run = runs["trunk"]
    parallel_phase({**trunk_run, "ms_step": trunk_ms,
                    "n_params": sum(v.numel() for v in trunk_run["params"].values())}, res)

    # 15. the rest of the JAX package: the staged chain, LPIPS, the fusion sweep,
    # the host tools, the profiling helpers
    with tempfile.TemporaryDirectory() as tmp:
        recs, staged_args = staged_phase(dev, tmp)
        lpips_phase(cfg, dev, engine, ds, model, res, tmp)
        sweep_phase(dev, recs, staged_args, tmp)
        host_tools_phase(dev, recs, staged_args, tmp)
        profiling_phase(cfg, dev, engine, trunk_ms, tmp)

    # 16. the plain path against each kernel mode over many steps
    trajectory_phase(cfg, dev, engine, runs)

    # 17. the full-resolution protocol's tree: check_data, a short run, A1 on a full view
    with tempfile.TemporaryDirectory() as tmp:
        fullres_phase(dev, tmp)

    # one entry per kernel; times at the fine field's N = 262,144 for B / B' / C / C'
    # (C' on C's saved activations, as mode field runs it). No single PyTorch
    # call computes any of these functions: library_ms is null.
    tf, ff = trunk[("fine", "t")], field["fine"]
    fe, ft_ = ff["errs"], ff["t"]
    entry = lambda name, src, rep, launches, err, ms, plain, bnd: {
        "name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
        "library_ms": None}
    print(json.dumps({"kernels": [
        entry("intersect_rays", KERNEL_SOURCE, KERNEL_REPLACES, launches, max_dt, kernel_ms,
              plain_ms, a1_bound),
        entry("intersect_groups", KERNEL_SOURCE, A2_REPLACES, train["trunk"]["A2"], a2_dt, a2_ms,
              a2_plain_ms, a2_bound),
        entry("trunk_forward", TRUNK_SOURCE, B_REPLACES, train["trunk"]["B"],
              trunk[("fine", "out")][0], tf["fwd"], tf["fwd_plain"], tf["fwd_bound"]),
        entry("trunk_backward", TRUNK_SOURCE, B2_REPLACES, train["trunk"]["B'"],
              trunk[("fine", "dW")][0], tf["bwd"], tf["bwd_plain"], tf["bwd_bound"]),
        entry("field_forward", FIELD_SOURCE, C_REPLACES, train["field"]["C"],
              max(fe[k][0] for k in ("sigma", "rgb", "sem")), ft_["fwd"], ft_["fwd_plain"],
              ft_["fwd_bound"]),
        entry("field_backward", FIELD_SOURCE, C2_REPLACES, train["field"]["C'"],
              max(v[0] for k, v in fe.items() if k.startswith("d") and k.endswith("/bf16")),
              ft_["bwd"], ft_["bwd_plain"], ft_["bwd_bound"]),
        entry("field_eval", EVAL_SOURCE, EVAL_REPLACES, e_launches, ev_field["fine"]["err"],
              ev_field["fine"]["ms"], ev_field["fine"]["plain_ms"], ev_field["fine"]["bound"]),
        entry("field_eval_grid", EVAL_SOURCE, EVAL_REPLACES, ev_grid["launches"]["E"],
              ev_grid["E"]["err"], ev_grid["E"]["ms"], ev_grid["E"]["plain_ms"],
              ev_grid["E"]["bound"]),
        entry("hash_grid_encode", GRID_SOURCE, GRID_REPLACES, ev_grid["launches"]["G"],
              ev_grid["G"]["err"], ev_grid["G"]["ms"], ev_grid["G"]["plain_ms"],
              ev_grid["G"]["bound"]),
        entry("volume_composite", COMPOSITE_SOURCE, COMPOSITE_REPLACES, v_launches,
              ev_comp["err"], ev_comp["ms"], ev_comp["plain_ms"], ev_comp["bound"]),
        entry("sample", SAMPLE_SOURCE, SAMPLE_REPLACES, z_launches, ev_sample["err"],
              ev_sample["ms"], ev_sample["plain_ms"], ev_sample["bound"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:  # a rank of phase 14, started by torchrun
        child(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        main()
