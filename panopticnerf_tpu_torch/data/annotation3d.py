"""KITTI-360 3D bounding-primitive annotation parsing (port of
`panopticnerf_tpu/data/annotation3d.py`, numpy and xml.etree, the same
code).

The reference vendors kitti360scripts' `annotation.py` (`KITTI360Bbox3D`) to read
`data_3d_bboxes/train/<sequence>.xml` ([pn], unverified — SURVEY.md §2.2).
The XML (an opencv_storage document) stores one node per object with:

  - ``transform``: 4x4 row-major matrix; R = transform[:3,:3] carries
    rotation*scale, T = transform[:3,3]
  - ``vertices`` / ``faces``: the template mesh in the object's local frame
    (a +-0.5 unit cube for cuboids; extruded polygons have more vertices)
  - ``semanticId`` / ``instanceId`` (newer exports) or a ``label`` name
  - ``start_frame`` / ``end_frame`` (visibility window), ``timestamp``
    (-1 = static), ``dynamic`` flag

Mapping: every object becomes one or more world->unit-cube affines.
Cuboids map exactly over the template AABB: x_unit = D (R^-1 (x - T) - m),
D = diag(2/ext), m = template-AABB center. Extruded polygons are decomposed
into CONVEX pieces (ear clipping + Hertel-Mehlhorn merging of the
cross-section ring), each piece a primitive over its own tighter AABB with
half-space cut planes — exact for concave footprints (common for KITTI-360
buildings), where a single convex hull would leak the fixed semantic field
into the concavity. All pieces of one annotation share its semantic and
instance ids, so downstream compositing is unchanged (interval union).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from panopticnerf_tpu_torch.data.labels import name2label
from panopticnerf_tpu_torch.utils.profiling import span


@dataclass
class Bbox3D:
    index: int
    semantic_id: int          # raw KITTI-360 id
    instance_id: int          # global instance id (semantic*1000 + local)
    label: str
    world_to_prim: np.ndarray  # (3, 4) world -> [-1,1]^3 local
    start_frame: int
    end_frame: int
    dynamic: bool
    timestamp: int
    vertices_world: np.ndarray = field(repr=False, default=None)  # (V, 3)
    is_cuboid: bool = True
    # Convex refinement for extruded polygons: half-spaces n.x <= b in the
    # primitive's [-1,1]^3 local frame (None for cuboids). See
    # `convex_cut_planes`.
    cut_planes: Optional[np.ndarray] = field(repr=False, default=None)  # (F, 4)
    # Position of the source annotation in the XML file. Concave extrusions
    # emit several Bbox3D records (convex pieces) sharing one ordinal, so
    # positional visible-id files resolve to ALL pieces of an annotation.
    ordinal: int = -1


def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    """Scalar z-component of the 2-D cross product (np.cross on 2-vectors
    is deprecated since NumPy 2.0)."""
    return float(a[0] * b[1] - a[1] * b[0])


def _monotone_chain_hull(pts: np.ndarray) -> np.ndarray:
    """2D convex hull (CCW) via Andrew's monotone chain; pts (M, 2)."""
    pts = np.unique(np.round(pts, 9), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    cross = lambda o, a, b: (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])
    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(tuple(p))
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(tuple(p))
    return np.asarray(lower[:-1] + upper[:-1])


def _extrusion_axis_and_ring(v: np.ndarray):
    """(axis, lower-ring cross-section coords in file order) for a clean
    two-ring extrusion, else (None, None)."""
    for a in range(3):
        vals = np.unique(np.round(v[:, a], 6))
        if len(vals) != 2:
            continue
        oth = [x for x in range(3) if x != a]
        sel_lo = np.round(v[:, a], 6) == vals[0]
        lo = v[sel_lo][:, oth]
        hi = v[~sel_lo][:, oth]
        if len(lo) != len(hi):
            continue
        key = lambda r: np.lexsort((r[:, 1], r[:, 0]))
        if np.allclose(lo[key(lo)], hi[key(hi)], atol=1e-6):
            return a, lo
    return None, None


def _is_aabb_rect(poly: np.ndarray) -> bool:
    """True iff the 4-gon IS its own axis-aligned bounding rectangle (then
    the OBB slab test is already exact and no cut planes are needed)."""
    if len(poly) != 4:
        return False
    lo2, hi2 = poly.min(0), poly.max(0)
    corners = ((lo2[0], lo2[1]), (lo2[0], hi2[1]), (hi2[0], lo2[1]), (hi2[0], hi2[1]))
    return all(any(np.allclose(p, c, atol=1e-6) for c in corners) for p in poly)


def _reduce_hull_circumscribe(hull: np.ndarray, max_sides: int) -> np.ndarray:
    """Reduce a CCW convex polygon to <= max_sides sides by REMOVING edges.

    Dropping edge i extends its two neighbouring edges to their intersection
    point, so the region only ever GROWS (it circumscribes the input) —
    annotated geometry is never excluded, unlike vertex dropping which cuts
    off the triangle at each removed vertex. Picks the edge whose removal
    adds the least area. If no edge can be removed with a finite
    circumscribing point (parallel neighbours), the polygon is returned
    as-is and the caller drops the excess half-space constraints outright
    (also growth-only).
    """
    hull = [np.asarray(p, np.float64) for p in hull]
    while len(hull) > max_sides:
        m = len(hull)
        best, best_cost, best_x = None, np.inf, None
        for i in range(m):
            a0, a1 = hull[i - 1], hull[i]              # edge before
            b0, b1 = hull[(i + 1) % m], hull[(i + 2) % m]  # edge after
            da, db = a1 - a0, b1 - b0
            denom = _cross2(da, db)
            if denom < 1e-12:
                continue  # neighbours parallel: no finite extension point
            r = b0 - a0
            t = _cross2(r, db) / denom
            s = _cross2(r, da) / denom
            if t < 1.0 - 1e-9 or s > 1e-9:
                continue  # intersection does not extend both edges outward
            x = a0 + t * da
            cost = abs(_cross2(x - a1, b0 - a1)) / 2.0
            if cost < best_cost:
                best, best_cost, best_x = i, cost, x
        if best is None:
            break
        j = (best + 1) % m
        hull = [best_x if k == best else hull[k] for k in range(m) if k != j]
    return np.asarray(hull)


def _poly_planes(poly: np.ndarray, others: list[int], max_planes: int) -> np.ndarray:
    """(max_planes, 4) half-spaces n.x <= b from a CCW convex 2D polygon in
    the primitive's normalized local frame, padded with all-pass planes.

    If the polygon has more sides than max_planes it is first circumscribed
    down (see _reduce_hull_circumscribe); any still-excess constraints are
    dropped, so the represented region always CONTAINS the polygon.
    """
    if len(poly) > max_planes:
        poly = _reduce_hull_circumscribe(poly, max_planes)
    planes = np.zeros((max_planes, 4), np.float32)
    planes[:, 3] = 1.0  # all-pass padding: 0.x <= 1
    k = 0
    for i in range(len(poly)):
        a, b = poly[i], poly[(i + 1) % len(poly)]
        e = b - a
        n2 = np.array([e[1], -e[0]])  # outward for a CCW polygon
        norm = np.linalg.norm(n2)
        if norm < 1e-12:
            continue
        n2 /= norm
        n3 = np.zeros(3)
        n3[others[0]], n3[others[1]] = n2
        planes[k, :3] = n3
        planes[k, 3] = float(n2 @ a)
        k += 1
        if k == max_planes:
            break
    return planes


def convex_cut_planes(local_verts: np.ndarray, max_planes: int) -> Optional[np.ndarray]:
    """Side planes of an extruded polygon, in the [-1,1]^3 local frame.

    The extrusion axis is the local axis whose vertex coordinates cluster
    into two identical rings; the cross-section's convex hull provides side
    half-spaces n.x <= b. Hulls with more than `max_planes` sides are
    reduced by edge removal (growth-only — see _reduce_hull_circumscribe).
    Returns (max_planes, 4) padded with all-pass planes, or None when the
    shape is effectively a box. For exact CONCAVE cross-sections use
    `decompose_extrusion` instead; this is the conservative fallback.
    """
    v = np.asarray(local_verts, np.float64)
    axis, _ = _extrusion_axis_and_ring(v)
    if axis is None:
        # Not a clean two-ring extrusion: keep the conservative OBB.
        return None
    others = [a for a in range(3) if a != axis]
    hull = _monotone_chain_hull(v[:, others])
    if len(hull) < 3:
        return None  # degenerate cross-section
    if _is_aabb_rect(hull):
        return None
    return _poly_planes(np.asarray(hull, np.float64), others, max_planes)


# --------------------------------------------------------------------------
# Exact concave cross-sections: ring recovery + convex decomposition.
# --------------------------------------------------------------------------

def _clean_ring(ring: np.ndarray) -> np.ndarray:
    """Drop consecutive duplicates and a repeated closing vertex."""
    out: list[np.ndarray] = []
    for p in ring:
        if not out or np.linalg.norm(p - out[-1]) > 1e-9:
            out.append(np.asarray(p, np.float64))
    if len(out) > 1 and np.linalg.norm(out[0] - out[-1]) < 1e-9:
        out.pop()
    return np.asarray(out)


def _signed_area(ring: np.ndarray) -> float:
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _is_simple_polygon(ring: np.ndarray) -> bool:
    """No two non-adjacent edges properly intersect (O(n^2), n is tiny)."""
    n = len(ring)

    def _proper(p1, p2, p3, p4) -> bool:
        d1 = _cross2(p4 - p3, p1 - p3)
        d2 = _cross2(p4 - p3, p2 - p3)
        d3 = _cross2(p2 - p1, p3 - p1)
        d4 = _cross2(p2 - p1, p4 - p1)
        return bool(((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0)))

    for i in range(n):
        for j in range(i + 1, n):
            if j == i + 1 or (i == 0 and j == n - 1):
                continue  # adjacent edges share a vertex
            if _proper(ring[i], ring[(i + 1) % n], ring[j], ring[(j + 1) % n]):
                return False
    return True


def _is_convex_ccw(ring: np.ndarray, eps: float = 1e-9) -> bool:
    n = len(ring)
    for i in range(n):
        a, b, c = ring[i - 1], ring[i], ring[(i + 1) % n]
        if _cross2(b - a, c - b) < -eps:
            return False
    return True


def _point_in_tri(p, a, b, c, eps: float = 1e-12) -> bool:
    """Strict interior (plus boundary within eps) test for a CCW triangle."""
    return (
        _cross2(b - a, p - a) > -eps
        and _cross2(c - b, p - b) > -eps
        and _cross2(a - c, p - c) > -eps
    )


def _ear_clip(ring: np.ndarray) -> Optional[list[tuple[int, int, int]]]:
    """Triangulate a simple CCW polygon by ear clipping; None if degenerate."""
    idx = list(range(len(ring)))
    tris: list[tuple[int, int, int]] = []
    while len(idx) > 3:
        m = len(idx)
        for k in range(m):
            i0, i1, i2 = idx[k - 1], idx[k], idx[(k + 1) % m]
            a, b, c = ring[i0], ring[i1], ring[i2]
            if _cross2(b - a, c - b) <= 1e-12:
                continue  # reflex or collinear: not an ear
            if any(
                _point_in_tri(ring[j], a, b, c)
                for j in idx
                if j not in (i0, i1, i2)
            ):
                continue
            tris.append((i0, i1, i2))
            idx.pop(k)
            break
        else:
            return None  # no ear found: degenerate input
    tris.append((idx[0], idx[1], idx[2]))
    return tris


def _merge_convex_pieces(ring: np.ndarray, pieces: list[list[int]]) -> list[list[int]]:
    """Hertel-Mehlhorn style merging: greedily fuse pieces across shared
    diagonals whenever the union stays convex. Fewer pieces => fewer
    primitives => cheaper intersection."""

    def _try_merge(A: list[int], B: list[int]) -> Optional[list[int]]:
        nA, nB = len(A), len(B)
        for i in range(nA):
            a0, a1 = A[i], A[(i + 1) % nA]
            for j in range(nB):
                if B[j] == a1 and B[(j + 1) % nB] == a0:
                    merged = [A[(i + 1 + k) % nA] for k in range(nA)]
                    merged += [B[(j + 2 + k) % nB] for k in range(nB - 2)]
                    if _is_convex_ccw(ring[np.asarray(merged)]):
                        return merged
        return None

    changed = True
    while changed:
        changed = False
        for ai in range(len(pieces)):
            for bi in range(ai + 1, len(pieces)):
                merged = _try_merge(pieces[ai], pieces[bi])
                if merged is not None:
                    pieces[ai] = merged
                    pieces.pop(bi)
                    changed = True
                    break
            if changed:
                break
    # Drop straight-through (collinear) vertices: they only waste planes.
    out = []
    for piece in pieces:
        poly = ring[np.asarray(piece)]
        keep = [
            k
            for k in range(len(piece))
            if abs(_cross2(poly[k] - poly[k - 1], poly[(k + 1) % len(piece)] - poly[k]))
            > 1e-12
        ]
        out.append([piece[k] for k in keep] if len(keep) >= 3 else piece)
    return out


def decompose_extrusion(verts: np.ndarray, max_planes: int):
    """Convex decomposition of an extruded polygon, in template coordinates.

    Recovers the cross-section ring from the lower vertex ring in FILE ORDER
    (kitti360scripts' extrusion templates store the polygon boundary in
    order, duplicated at two heights), then ear-clips concave rings into
    triangles and merges them back into maximal convex pieces.

    Returns a list of pieces [(lo(3,), hi(3,), poly(Mi,2) CCW, others)] —
    each piece's own template-coord AABB plus its cross-section polygon —
    or None when the shape is not a recoverable simple extrusion (caller
    falls back to the convex-hull path, which is conservative).
    """
    v = np.asarray(verts, np.float64)
    axis, ring = _extrusion_axis_and_ring(v)
    if axis is None:
        return None
    ring = _clean_ring(ring)
    if len(ring) < 3:
        return None
    area = _signed_area(ring)
    if abs(area) < 1e-12:
        return None
    if area < 0:
        ring = ring[::-1].copy()
    if not _is_simple_polygon(ring):
        return None  # file order is not a boundary walk: fall back
    others = [a for a in range(3) if a != axis]
    zlo, zhi = float(v[:, axis].min()), float(v[:, axis].max())

    if _is_convex_ccw(ring):
        polys = [ring]
    else:
        tris = _ear_clip(ring)
        if tris is None:
            return None
        pieces_idx = _merge_convex_pieces(ring, [list(t) for t in tris])
        polys = [ring[np.asarray(p)] for p in pieces_idx]

    out = []
    for poly in polys:
        lo = np.zeros(3)
        hi = np.zeros(3)
        lo[axis], hi[axis] = zlo, zhi
        lo2, hi2 = poly.min(0), poly.max(0)
        lo[others[0]], hi[others[0]] = lo2[0], hi2[0]
        lo[others[1]], hi[others[1]] = lo2[1], hi2[1]
        out.append((lo, hi, poly, others))
    return out


def _parse_matrix(node) -> np.ndarray:
    rows = int(node.find("rows").text)
    cols = int(node.find("cols").text)
    data = np.array(node.find("data").text.split(), dtype=np.float64)
    return data.reshape(rows, cols)


def _text(node, name, default=None):
    c = node.find(name)
    return c.text.strip() if c is not None and c.text is not None else default


@span("data.boxes")
def parse_bbox_xml(path: str, max_cut_planes: int = 8) -> list[Bbox3D]:
    """Parse one sequence's 3D-annotation XML into Bbox3D records.

    One annotation may yield SEVERAL records: concave extruded polygons are
    decomposed into convex pieces (see `decompose_extrusion`), each with its
    own tighter world->unit-cube affine and cut planes, all sharing the
    annotation's index/ordinal/semantic/instance ids.
    """
    tree = ET.parse(path)
    root = tree.getroot()
    out = []
    ordinal = -1
    for child in root:
        if child.find("transform") is None or child.find("vertices") is None:
            continue
        ordinal += 1
        transform = _parse_matrix(child.find("transform"))
        verts = _parse_matrix(child.find("vertices"))
        R = transform[:3, :3]
        T = transform[:3, 3]

        label = _text(child, "label", "unknown object")
        sem_txt = _text(child, "semanticId")
        if sem_txt is not None:
            semantic_id = int(float(sem_txt))
        elif label in name2label:
            semantic_id = name2label[label].id
        else:
            semantic_id = name2label["unknown object"].id
        inst_local = int(float(_text(child, "instanceId", "0") or 0))
        index = int(float(_text(child, "index", "-1") or -1))

        R_inv = np.linalg.inv(R)

        def _affine(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
            """World -> [-1,1]^3 over the template-coord AABB [lo, hi]."""
            ext = np.maximum(hi - lo, 1e-6)
            mid = (hi + lo) / 2.0
            D = np.diag(2.0 / ext)
            lin = D @ R_inv
            trans = D @ (-R_inv @ T - mid)
            return np.concatenate([lin, trans[:, None]], axis=1).astype(np.float32)

        lo_all = verts.min(0)
        hi_all = verts.max(0)
        verts_world = (R @ verts.T).T + T

        is_cuboid = verts.shape[0] <= 10
        # Each record: (world_to_prim, cut_planes).
        records: list[tuple[np.ndarray, Optional[np.ndarray]]] = []
        if is_cuboid or max_cut_planes <= 0:
            records.append((_affine(lo_all, hi_all), None))
        else:
            pieces = decompose_extrusion(verts, max_cut_planes)
            if pieces is None:
                # Not a recoverable simple extrusion: conservative hull path.
                ext = np.maximum(hi_all - lo_all, 1e-6)
                mid = (hi_all + lo_all) / 2.0
                local_template = (verts - mid) * (2.0 / ext)
                records.append(
                    (_affine(lo_all, hi_all),
                     convex_cut_planes(local_template, max_cut_planes))
                )
            else:
                for plo, phi, poly, others in pieces:
                    pext = np.maximum(phi - plo, 1e-6)
                    pmid = (phi + plo) / 2.0
                    mid2 = np.array([pmid[others[0]], pmid[others[1]]])
                    ext2 = np.array([pext[others[0]], pext[others[1]]])
                    norm_poly = (poly - mid2) * (2.0 / ext2)
                    cut = (
                        None
                        if _is_aabb_rect(norm_poly)
                        else _poly_planes(norm_poly, others, max_cut_planes)
                    )
                    records.append((_affine(plo, phi), cut))

        for w2p, cut in records:
            out.append(
                Bbox3D(
                    index=index,
                    semantic_id=semantic_id,
                    instance_id=semantic_id * 1000 + inst_local,
                    label=label,
                    world_to_prim=w2p,
                    start_frame=int(float(_text(child, "start_frame", "-1") or -1)),
                    end_frame=int(float(_text(child, "end_frame", "-1") or -1)),
                    dynamic=bool(int(float(_text(child, "dynamic", "0") or 0))),
                    timestamp=int(float(_text(child, "timestamp", "-1") or -1)),
                    vertices_world=verts_world.astype(np.float32),
                    is_cuboid=is_cuboid,
                    cut_planes=cut,
                    ordinal=ordinal,
                )
            )
    return out


@span("data.boxes")
def load_visible_ids(visible_dir: str, frame: int) -> Optional[np.ndarray]:
    """Per-frame visible-primitive index list (PanopticNeRF preprocessing).

    Accepts `<frame:010d>.txt` (whitespace ints) or `.npy`. Returns None when
    no file exists (caller falls back to window-based visibility).
    """
    base = os.path.join(visible_dir, f"{frame:010d}")
    if os.path.exists(base + ".txt"):
        arr = np.loadtxt(base + ".txt", dtype=np.int64, ndmin=1)
        return arr.astype(np.int64)
    if os.path.exists(base + ".npy"):
        return np.load(base + ".npy").astype(np.int64)
    return None


@span("data.boxes")
def boxes_visible_in_frame(boxes: list[Bbox3D], frame: int) -> list[int]:
    """Window-based visibility fallback: static boxes whose [start, end]
    window covers `frame` (end == -1 means open-ended)."""
    out = []
    for i, b in enumerate(boxes):
        if b.dynamic and b.timestamp not in (-1, frame):
            continue
        s = b.start_frame if b.start_frame >= 0 else -(10**9)
        e = b.end_frame if b.end_frame >= 0 else 10**9
        if s <= frame <= e:
            out.append(i)
    return out
