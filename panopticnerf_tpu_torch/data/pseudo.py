"""Pseudo-label cleaning (the -360 branch's refined filtering, rebuilt;
port of `panopticnerf_tpu/data/pseudo.py`, numpy, the same code).

The in-loss consistency filter (train/loss.py, reference `pseudo_filter`/
`weight_th`) can only judge pixels whose rays cross 3D primitives; rays
with NO primitive evidence (sky, unannotated geometry) pass their pseudo-
labels through wholesale, and a wrong label whose class ALSO has primitive
mass on the ray (overlapping road/sidewalk boxes) passes it too —
BASELINE.md's round-4 structured-noise ablation pins the residual PQ^St
gap on exactly that ambiguity.

PanopticNeRF-360 describes improved label filtering ([pn360], unverified —
SURVEY.md §1 "improved filtering/losses"); two load-time reconstructions
live here, both host-side numpy on the cold path:

  * `majority_clean` — spatial agreement: a pseudo-label that agrees with
    fewer than k of its 8 neighbors is demoted to ignore. Removes
    segmenter speckle (isolated flips); coherent blob errors survive by
    construction. `data.pseudo_clean_neighbors` (0 = off).
  * `cross_view_clean` — multi-view agreement: unproject each labeled
    pixel through its stereo (SGM) depth, reproject into nearby views,
    depth-verify the correspondence against the TARGET view's depth
    (occlusion test), and demote labels that LOSE the majority vote among
    verified voters. Coherent per-view blobs are exactly what this
    catches: a segmenter hallucination in one view is contradicted by the
    same 3D surface seen clean from neighboring frames and the stereo
    pair. `data.pseudo_cross_view` (frame window, 0 = off).
"""

from __future__ import annotations

import numpy as np

IGNORE = 255


def majority_clean(labels: np.ndarray, k: int, ignore: int = IGNORE) -> np.ndarray:
    """Demote labels with < k agreeing 8-neighbors to `ignore`.

    labels: (H, W) int map. Border pixels see out-of-image neighbors as
    disagreeing (conservative). Ignore-labeled pixels stay ignored and never
    count as agreement.
    """
    if k <= 0:
        return labels
    h, w = labels.shape
    pad = np.full((h + 2, w + 2), ignore, labels.dtype)
    pad[1:-1, 1:-1] = labels
    agree = np.zeros((h, w), np.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = pad[1 + dy : h + 1 + dy, 1 + dx : w + 1 + dx]
            agree += ((nb == labels) & (labels != ignore)).astype(np.int32)
    return np.where((labels != ignore) & (agree < k), ignore, labels)


def _unit_dirs(K: np.ndarray, H: int, W: int) -> np.ndarray:
    """(HW, 3) unit camera-frame ray directions for a pinhole K."""
    us, vs = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    uv1 = np.stack([us, vs, np.ones_like(us)], axis=-1).reshape(-1, 3)
    d_cam = uv1 @ np.linalg.inv(K).T                  # (HW, 3), z=1 rays
    return d_cam / np.linalg.norm(d_cam, axis=-1, keepdims=True)


def cross_view_clean(
    labels: np.ndarray,
    depths: np.ndarray,
    Ks: np.ndarray,
    c2ws: np.ndarray,
    view_frames: np.ndarray,
    persp: np.ndarray,
    window: int,
    tol: float = 0.1,
    min_voters: int = 2,
    ignore: int = IGNORE,
    mode: str = "splat",
    repaint: float = 0.0,
) -> np.ndarray:
    """Demote (or repaint) pseudo-labels that lose a depth-verified
    cross-view vote.

    labels: (V, H, W) int pseudo-label maps (modified copies returned);
    depths: (V, H, W) RAY-distance depth (0 = invalid); Ks: (V, 3, 3);
    c2ws: (V, 3, 4) cam->world; view_frames: (V,) source frame index per
    view; persp: (V,) bool perspective-camera mask (the pinhole projection
    does not apply to MEI fisheye views); window: vote across views within
    +-window frames. Voters must carry a depth stream: on real KITTI-360
    only image_00 has SGM, so the voters are the neighboring-frame left
    views (the same-frame stereo pair votes only on layouts that ship a
    right-camera depth stream).

    mode="pull" (the original form): unproject each SOURCE pixel through
    its OWN depth and read the voter at the reprojected pixel, verifying
    against the target view's depth (occlusion test). A pixel without
    depth can neither vote nor be cleaned — on the KITTI-360 layout that
    excludes all of image_01 and the ~half of image_00 where SGM is
    invalid, capping coverage at ~25% (the round-4 neutral result).

    mode="splat" (round-5 redesign): z-buffer every depth-carrying view's
    labeled points INTO each target view (two passes: min-depth z-buffer,
    then vote accumulation for points within tol of the visible surface).
    Occlusion is tested against the SPLATTED z-buffer, not the target's
    own depth, so no-depth views and no-depth pixels are cleaned too.

    A pixel is demoted to `ignore` when at least `min_voters` verified
    votes exist and strictly more disagree than agree with its label. With
    repaint > 0, a demoted pixel whose voters concentrate >= repaint of
    their votes on ONE class is repainted to that class instead of ignored
    (recovers supervision density where a wrong label REPLACED the truth);
    repaint=0 keeps demote-only semantics — never trusting reprojection to
    author labels at thin structures.
    """
    V, H, W = labels.shape
    out = labels.copy()
    if window < 0:
        return out
    if mode not in ("pull", "splat"):
        raise ValueError(f"unknown pseudo_xview_mode {mode!r}")

    # Per-unique-K unit-direction cache (rectified views share one K;
    # computing (V, HW, 3) eagerly is multi-GB at full res x many views).
    _dir_cache: dict[bytes, np.ndarray] = {}

    def dirs_for(i: int) -> np.ndarray:
        key = Ks[i].tobytes()
        if key not in _dir_cache:
            _dir_cache[key] = _unit_dirs(Ks[i], H, W)
        return _dir_cache[key]

    def world_points(i: int, sel: np.ndarray) -> np.ndarray:
        d_i = depths[i].reshape(-1)
        R_i, t_i = c2ws[i, :, :3], c2ws[i, :, 3]
        return (dirs_for(i)[sel] * d_i[sel, None]) @ R_i.T + t_i

    def project(j: int, X: np.ndarray):
        """World points -> (flat pixel idx, ray distance, in-image mask)."""
        R_j, t_j = c2ws[j, :, :3], c2ws[j, :, 3]
        x_cam = (X - t_j) @ R_j                        # R_j^T (X - t) rowwise
        d_proj = np.linalg.norm(x_cam, axis=-1)
        uvw = x_cam @ Ks[j].T
        with np.errstate(divide="ignore", invalid="ignore"):
            u = uvw[:, 0] / uvw[:, 2]
            v = uvw[:, 1] / uvw[:, 2]
        ui = np.rint(u).astype(np.int64)
        vi = np.rint(v).astype(np.int64)
        ok = (uvw[:, 2] > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        ui, vi = np.clip(ui, 0, W - 1), np.clip(vi, 0, H - 1)
        return vi * W + ui, d_proj, ok

    def sources_for(j: int):
        for i in range(V):
            if i == j or not persp[i]:
                continue
            if abs(int(view_frames[i]) - int(view_frames[j])) > window:
                continue
            if not (depths[i] > 0).any():
                continue
            yield i

    flat = out.reshape(V, -1)

    if mode == "pull":
        for i in range(V):
            if not persp[i]:
                continue
            d_i = depths[i].reshape(-1)
            lab_i = labels[i].reshape(-1)
            src = (d_i > 0) & (lab_i != ignore)
            if not src.any():
                continue
            agree = np.zeros(H * W, np.int32)
            disagree = np.zeros(H * W, np.int32)
            X = world_points(i, src)
            idx = np.flatnonzero(src)
            for j in sources_for(i):   # symmetric window: j votes on i
                pix, d_proj, ok = project(j, X)
                d_j = depths[j].reshape(-1)[pix]
                lab_j = labels[j].reshape(-1)[pix]
                verified = ok & (d_j > 0) & (lab_j != ignore) & (
                    np.abs(d_j - d_proj) < tol * d_proj)
                same = lab_j == lab_i[src]
                np.add.at(agree, idx[verified & same], 1)
                np.add.at(disagree, idx[verified & ~same], 1)
            votes = agree + disagree
            demote = (votes >= min_voters) & (disagree > agree)
            flat[i, demote] = ignore
        return flat.reshape(V, H, W)

    # --- splat mode ---
    real = labels[labels != ignore]
    n_classes = int(real.max()) + 1 if real.size else 1
    for j in range(V):
        if not persp[j]:
            continue
        lab_t = labels[j].reshape(-1)
        if not (lab_t != ignore).any():
            continue
        # Pass 1: z-buffer of all splatted source points.
        zbuf = np.full(H * W, np.inf, np.float32)
        splats = []                     # (pix, d_proj, lab) per source view
        for i in sources_for(j):
            d_i = depths[i].reshape(-1)
            lab_i = labels[i].reshape(-1)
            src = (d_i > 0) & (lab_i != ignore)
            if not src.any():
                continue
            pix, d_proj, ok = project(j, world_points(i, src))
            pix, d_proj, lab = pix[ok], d_proj[ok], lab_i[src][ok]
            np.minimum.at(zbuf, pix, d_proj)
            splats.append((pix, d_proj, lab))
        if not splats:
            continue
        # Pass 2: points within tol of the visible surface vote on their
        # landing pixel.
        agree = np.zeros(H * W, np.int32)
        disagree = np.zeros(H * W, np.int32)
        class_votes = (np.zeros((H * W, n_classes), np.int32)
                       if repaint > 0 else None)
        for pix, d_proj, lab in splats:
            vis = d_proj < zbuf[pix] * (1.0 + tol)
            pix, lab = pix[vis], lab[vis]
            same = lab == lab_t[pix]
            np.add.at(agree, pix[same], 1)
            np.add.at(disagree, pix[~same], 1)
            if class_votes is not None:
                np.add.at(class_votes, (pix, lab), 1)
        votes = agree + disagree
        lose = (votes >= min_voters) & (disagree > agree) & (lab_t != ignore)
        if class_votes is not None:
            top = np.argmax(class_votes, axis=-1)
            top_n = np.take_along_axis(class_votes, top[:, None], -1)[:, 0]
            do_paint = lose & (top_n >= repaint * np.maximum(votes, 1))
            flat[j, do_paint] = top[do_paint].astype(flat.dtype)
            flat[j, lose & ~do_paint] = ignore
        else:
            flat[j, lose] = ignore
    return flat.reshape(V, H, W)
