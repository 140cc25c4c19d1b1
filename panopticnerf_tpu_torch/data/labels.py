"""KITTI-360 semantic taxonomy.

The reference vendors kitti360scripts' ``labels.py`` ([pn] lib/utils or
lib/datasets/kitti360, unverified — SURVEY.md §2.2). The table below is the
public KITTI-360 label definition (factual dataset metadata): 45 semantic
classes extending the Cityscapes taxonomy, with trainId mapping (19 eval
classes, 255 = ignore), instance-ness flags, and the official palette.

TPU note: the palette / id maps are exported as dense numpy lookup tables so
colorization and trainId remapping are single gathers (device- or host-side),
never Python loops over pixels.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

Label = namedtuple(
    "Label",
    ["name", "id", "trainId", "category", "categoryId", "hasInstances", "ignoreInEval", "color"],
)

# fmt: off
LABELS = [
    #     name                     id  trainId  category       catId  hasInst  ignore  color
    Label("unlabeled",              0,    255, "void",            0,  False,   True,  (  0,   0,   0)),
    Label("ego vehicle",            1,    255, "void",            0,  False,   True,  (  0,   0,   0)),
    Label("rectification border",   2,    255, "void",            0,  False,   True,  (  0,   0,   0)),
    Label("out of roi",             3,    255, "void",            0,  False,   True,  (  0,   0,   0)),
    Label("static",                 4,    255, "void",            0,  False,   True,  (  0,   0,   0)),
    Label("dynamic",                5,    255, "void",            0,  False,   True,  (111,  74,   0)),
    Label("ground",                 6,    255, "void",            0,  False,   True,  ( 81,   0,  81)),
    Label("road",                   7,      0, "flat",            1,  False,   False, (128,  64, 128)),
    Label("sidewalk",               8,      1, "flat",            1,  False,   False, (244,  35, 232)),
    Label("parking",                9,    255, "flat",            1,  False,   True,  (250, 170, 160)),
    Label("rail track",            10,    255, "flat",            1,  False,   True,  (230, 150, 140)),
    Label("building",              11,      2, "construction",    2,  True,    False, ( 70,  70,  70)),
    Label("wall",                  12,      3, "construction",    2,  False,   False, (102, 102, 156)),
    Label("fence",                 13,      4, "construction",    2,  False,   False, (190, 153, 153)),
    Label("guard rail",            14,    255, "construction",    2,  False,   True,  (180, 165, 180)),
    Label("bridge",                15,    255, "construction",    2,  False,   True,  (150, 100, 100)),
    Label("tunnel",                16,    255, "construction",    2,  False,   True,  (150, 120,  90)),
    Label("pole",                  17,      5, "object",          3,  True,    False, (153, 153, 153)),
    Label("polegroup",             18,    255, "object",          3,  False,   True,  (153, 153, 153)),
    Label("traffic light",         19,      6, "object",          3,  True,    False, (250, 170,  30)),
    Label("traffic sign",          20,      7, "object",          3,  True,    False, (220, 220,   0)),
    Label("vegetation",            21,      8, "nature",          4,  False,   False, (107, 142,  35)),
    Label("terrain",               22,      9, "nature",          4,  False,   False, (152, 251, 152)),
    Label("sky",                   23,     10, "sky",             5,  False,   False, ( 70, 130, 180)),
    Label("person",                24,     11, "human",           6,  True,    False, (220,  20,  60)),
    Label("rider",                 25,     12, "human",           6,  True,    False, (255,   0,   0)),
    Label("car",                   26,     13, "vehicle",         7,  True,    False, (  0,   0, 142)),
    Label("truck",                 27,     14, "vehicle",         7,  True,    False, (  0,   0,  70)),
    Label("bus",                   28,     15, "vehicle",         7,  True,    False, (  0,  60, 100)),
    Label("caravan",               29,    255, "vehicle",         7,  True,    True,  (  0,   0,  90)),
    Label("trailer",               30,    255, "vehicle",         7,  True,    True,  (  0,   0, 110)),
    Label("train",                 31,     16, "vehicle",         7,  True,    False, (  0,  80, 100)),
    Label("motorcycle",            32,     17, "vehicle",         7,  True,    False, (  0,   0, 230)),
    Label("bicycle",               33,     18, "vehicle",         7,  True,    False, (119,  11,  32)),
    Label("garage",                34,      2, "construction",    2,  True,    True,  ( 64, 128, 128)),
    Label("gate",                  35,      4, "construction",    2,  False,   True,  (190, 153, 153)),
    Label("stop",                  36,    255, "construction",    2,  True,    True,  (150, 120,  90)),
    Label("smallpole",             37,      5, "object",          3,  True,    True,  (153, 153, 153)),
    Label("lamp",                  38,    255, "object",          3,  True,    True,  (  0,  64,  64)),
    Label("trash bin",             39,    255, "object",          3,  True,    True,  (  0, 128, 192)),
    Label("vending machine",       40,    255, "object",          3,  True,    True,  (128,  64,   0)),
    Label("box",                   41,    255, "object",          3,  True,    True,  ( 64,  64, 128)),
    Label("unknown construction",  42,    255, "void",            0,  False,   True,  (102,   0,   0)),
    Label("unknown vehicle",       43,    255, "void",            0,  False,   True,  ( 51,   0,  51)),
    Label("unknown object",        44,    255, "void",            0,  False,   True,  ( 32,  32,  32)),
]
# fmt: on

NUM_IDS = 45            # dense KITTI-360 semantic ids: 0..44
NUM_TRAIN_IDS = 19      # Cityscapes-style eval classes: trainId 0..18
IGNORE_TRAIN_ID = 255

name2label = {l.name: l for l in LABELS}
id2label = {l.id: l for l in LABELS}
trainId2label = {l.trainId: l for l in reversed(LABELS)}  # first (canonical) wins


def _build_tables():
    id_to_train = np.full((NUM_IDS,), IGNORE_TRAIN_ID, dtype=np.int32)
    id_color = np.zeros((NUM_IDS, 3), dtype=np.uint8)
    id_has_inst = np.zeros((NUM_IDS,), dtype=bool)
    for l in LABELS:
        id_to_train[l.id] = l.trainId
        id_color[l.id] = l.color
        id_has_inst[l.id] = l.hasInstances
    train_color = np.zeros((NUM_TRAIN_IDS + 1, 3), dtype=np.uint8)  # [-1] = ignore
    train_has_inst = np.zeros((NUM_TRAIN_IDS,), dtype=bool)
    train_name = [""] * NUM_TRAIN_IDS
    for l in LABELS:
        if l.trainId != IGNORE_TRAIN_ID and not train_name[l.trainId]:
            train_color[l.trainId] = l.color
            train_has_inst[l.trainId] = l.hasInstances
            train_name[l.trainId] = l.name
    return id_to_train, id_color, id_has_inst, train_color, train_has_inst, train_name


(
    ID_TO_TRAINID,       # (45,) int32, 255 where ignored
    ID_COLOR,            # (45, 3) uint8 palette by raw id
    ID_HAS_INSTANCES,    # (45,) bool
    TRAINID_COLOR,       # (20, 3) uint8 palette by trainId (last row = ignore/black)
    TRAINID_HAS_INSTANCES,  # (19,) bool — "thing" classes for panoptic eval
    TRAINID_NAME,        # list[str] of 19 class names
) = _build_tables()


def sky_train_id(num_classes: int) -> int:
    """Class id carrying the 'empty space is sky' prior (eval.sky_rule /
    loss.empty_sky_filter): the labels-table sky trainId when num_classes
    matches the KITTI-360 table, else class 0 (the synthetic fixtures'
    sky/stuff convention)."""
    if num_classes == NUM_TRAIN_IDS:
        return TRAINID_NAME.index("sky")
    return 0


def ids_to_trainids(sem_ids: np.ndarray) -> np.ndarray:
    """Remap raw KITTI-360 ids -> trainIds (vectorized gather; 255 = ignore)."""
    sem_ids = np.asarray(sem_ids)
    out = np.full(sem_ids.shape, IGNORE_TRAIN_ID, dtype=np.int32)
    valid = (sem_ids >= 0) & (sem_ids < NUM_IDS)
    out[valid] = ID_TO_TRAINID[sem_ids[valid]]
    return out


def colorize_trainids(train_ids: np.ndarray) -> np.ndarray:
    """trainId map -> uint8 RGB via the official palette (single gather)."""
    t = np.asarray(train_ids)
    idx = np.where((t >= 0) & (t < NUM_TRAIN_IDS), t, NUM_TRAIN_IDS)
    return TRAINID_COLOR[idx]


def colorize_ids(sem_ids: np.ndarray) -> np.ndarray:
    s = np.asarray(sem_ids)
    idx = np.clip(s, 0, NUM_IDS - 1)
    out = ID_COLOR[idx]
    out[(s < 0) | (s >= NUM_IDS)] = 0
    return out
