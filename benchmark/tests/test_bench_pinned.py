"""What the existing cells read, pinned bit for bit on the CPU: the seeded draw of every
parameter that both sides get, and the reference's maps of one small view. A change to a
configuration's reference module or to the pipeline it shares that alters either fails here,
so a second field architecture can be added beside them without moving these numbers."""

import hashlib

import pytest
import torch

from conftest import BENCH_DIR, SMALL
from harness import core

WEIGHTS = {("kitti360_panoptic", 0): "38c27046a1742c4eff2027d10682f9fc7fc89c4520e6e77b88477cd6d00371db",
           ("kitti360_panoptic", 7): "6f95e497c91972d727ec4e024bdf865e812b2e072a6f724d3c6829cb1734d41d",
           ("synthetic_flagship", 0): "38affd5f3f04c34f256644b73d3a1c7e7bb622f1ed7d2177453895cddd9a580e",
           ("synthetic_flagship", 7): "252f818581de706ee81505a67bebdb1a292ea667b482eccd65375dafe4ce70ef"}
VIEW = "88cf90a556ccfdccc34c43ae544950561aa49c2fb531a1ac469fdb2fb564af8d"
# The view's bits pass through ATen's CPU kernels (exp, logaddexp, sort, softmax, sin / cos),
# whose results can differ with the vector path the host dispatches to and with the torch
# version: VIEW was recorded on these.
VIEW_RECORDED_ON = ("2.13.0+cpu", "AVX512")


def digest(tensors: dict) -> str:
    """SHA-256 over the name, shape, dtype and bytes of every tensor, in key order."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().cpu().contiguous()
        h.update(f"{k}{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def conf_file(name: str) -> dict:
    return core.load_json(f"{BENCH_DIR}/configs/{name}.json")


def small_scene() -> dict:
    """One 6x10 view looking down +z at three boxes, the first cut by a plane (the second
    plane of every box is 0.x <= 1, which never cuts); 23 of its 60 rays hit a box."""
    h, w = 6, 10
    centers = torch.tensor([[0.0, 0.0, 4.0], [1.0, 0.3, 6.0], [-1.2, -0.2, 5.0]])
    halves = torch.tensor([[0.8, 0.6, 0.7], [0.9, 0.9, 1.2], [0.5, 0.7, 0.6]])
    w2p = torch.zeros(3, 3, 4)
    w2p[:, range(3), range(3)] = 1.0 / halves
    w2p[:, :, 3] = -centers / halves
    planes = torch.zeros(3, 2, 4)
    planes[:, :, 3] = 1.0
    planes[0, 0] = torch.tensor([0.6, 0.0, 0.8, 0.3])
    K = torch.tensor([[8.0, 0.0, w / 2], [0.0, 8.0, h / 2], [0.0, 0.0, 1.0]])
    c2w = torch.cat([torch.eye(3), torch.zeros(3, 1)], 1)
    return {"images": torch.zeros(1, h, w, 3, dtype=torch.uint8), "K": K[None], "c2w": c2w[None],
            "prim_w2p": w2p[None], "prim_planes": planes[None],
            "prim_sem": torch.tensor([[11, 13, 7]]), "prim_inst": torch.tensor([[1, 2, 3]]),
            "prim_valid": torch.tensor([[True, True, True]]),
            "bounds_center": torch.tensor([0.0, 0.0, 5.0]), "bounds_scale": torch.tensor(0.125)}


@pytest.mark.parametrize("name,seed", sorted(WEIGHTS))
def test_the_seeded_draw_is_pinned(name, seed):
    conf = conf_file(name)
    assert digest(core.reference(conf).make_weights(conf["program"], seed, "cpu")) \
        == WEIGHTS[(name, seed)]


def test_the_reference_view_is_pinned():
    conf = core.merged(conf_file("kitti360_panoptic"), SMALL)
    ref = core.reference(conf)
    weights = ref.make_weights(conf["program"], 7, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        maps = ref.render_view(weights, conf["program"], small_scene(), 0)
    finally:
        torch.set_num_threads(threads)
    host = (torch.__version__, torch.backends.cpu.get_cpu_capability())
    assert digest(maps) == VIEW, (
        f"the reference's view changed; recorded on torch {VIEW_RECORDED_ON[0]} with "
        f"{VIEW_RECORDED_ON[1]}, run on torch {host[0]} with {host[1]}"
        + ("" if host == VIEW_RECORDED_ON else ": the host differs, so rerun the digest on "
           "the parent commit here before suspecting the reference"))
