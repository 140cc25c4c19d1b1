"""The benchmark's own tests: on the CPU, at small sizes (the card-only one
is marked `cuda` and skips without a card)."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

# a size a CPU test can hold: a 2-frame tree at 24x88, 256 rays, narrow fields
SMALL = {"scene": {"frames": 2, "hw": [24, 88]},
         "program": {"data": {"n_rays": 256, "synthetic_image_hw": [24, 88]},
                     "model": {"trunk_width": 32, "color_width": 16},
                     "render": {"n_samples": 16, "n_importance": 16, "ray_tile": 512},
                     "train": {"log_interval": 4}}}
