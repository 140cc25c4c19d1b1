#!/bin/bash
# docs/DRESS_REHEARSAL.md §1-6 through the PyTorch port, at KITTI-360's full
# 376x1408 on a demo tree, with the training cut short (a check that every
# command runs, and its wall time; tools/fullres_protocol_torch.py runs the
# protocol in full). The commands are README.md's.
#
#   bash tools/dress_rehearsal_torch.sh DIR [STEPS]       # on the card
#   HW=24,32 D="--device cpu" X="model.trunk_width 16 model.trunk_depth 2 \
#     model.color_width 8 render.n_samples 8 render.n_importance 8 data.n_rays 64" \
#     bash tools/dress_rehearsal_torch.sh DIR 2   # on the CPU, small (~45 s)
#
# STEPS (default 100) is each chain stage's; the continuation runs 10 x STEPS
# steps with an evaluation every 5 x STEPS. Logs: DIR/<n>_<step>.log.
set -e
R=${1:?usage: dress_rehearsal_torch.sh DIR [STEPS]}
S=${2:-100}
HW=${HW:-376,1408}; D=${D:-}; X=${X:-}
T=$R/tree; O=$R/out
mkdir -p "$R"
t() {  # t LOG COMMAND...: run the command into DIR/LOG, print its wall time
    local log=$R/$1 s; shift
    s=$(date +%s%N)
    "$@" > "$log" 2>&1
    echo "  $(( ($(date +%s%N) - s) / 1000000 )) ms: ${*:1:3} (log $log)"
}
F="data.root $T data.frame_start 0 data.frame_num 8 data.test_every 4 data.max_primitives 32
   data.max_intervals 12 data.ratio 1.0 render.far 40.0"
P="--cfg_file configs/kitti360_panoptic.yaml $D $F $X model_dir $O exp_name kitti360_panoptic_10k"

echo "1. the tree"
t 1_tree.log python -m panopticnerf_tpu_torch.data.demo_tree $T --frames 8 --hw $HW --boxes 16 \
    --concave 4 --fisheye $D
echo "2. check_data"
t 2_check.log python -m panopticnerf_tpu_torch.tools.check_data \
    --cfg_file configs/kitti360_panoptic.yaml $F
tail -n 1 "$R/2_check.log"
echo "3. the staged chain, then the panoptic stage"
t 3_staged.log python -m panopticnerf_tpu_torch.run_staged --root $T --steps $S --stages 3 \
    --proposal 4,64 $D $F $X model_dir $O
t 3_train.log python -m panopticnerf_tpu_torch.train_net $P \
    train.init_from $O/torch/panopticnerf/kitti360_semantic train.pretrain "" \
    train.ep_iter $((5 * S)) train.epochs 2 train.eval_ep 1 train.eval_views 8
grep "eval@" "$R/3_train.log" | cut -c1-120
echo "4. evaluate the best checkpoint, and the fusion pick"
t 4_eval.log python -m panopticnerf_tpu_torch.run --type evaluate $P train.eval_step -1
t 4_sweep.log python -m panopticnerf_tpu_torch.tools.landing_sweep $P \
    --ckpts best=$O/torch/panopticnerf/kitti360_panoptic_10k_best --out $O/sweep.json
echo "5. visualize and export"
t 5_vis.log python -m panopticnerf_tpu_torch.run --type visualize $P
t 5_export.log python -m panopticnerf_tpu_torch.export_label_transfer $P --out $O/export
echo "6. the throughput probe"
t 6_network.log python -m panopticnerf_tpu_torch.run --type network $P
tail -n 1 "$R/6_network.log"
