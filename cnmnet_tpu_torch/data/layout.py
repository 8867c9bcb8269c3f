"""Room-layout extraction from plane annotations (offline, numpy).

Counterpart of the PlaneRCNN-lineage layout/structure heuristics in the
reference's `data_prepare/utils.py:687-1086` (`getLayout`/`getStructures`,
SURVEY.md §2.20): given a per-pixel plane segmentation, plane parameters and
a depth map, recover (a) the room-layout decomposition — the floor/wall/
ceiling planes that jointly explain the scene hull, with their pairwise
convex/concave boundaries — and (b) structure groupings of annotated
coplanar-adjacent plane sets.

Re-derived, not translated: points live in the STANDARD camera frame
(``ray = K_inv @ [u, v, 1]``, ``point = ray * depth``) like the rest of
this package (`data/prep.py:plane_depth_map`), everything pairwise is
vectorized, and two index-space inconsistencies of the reference are fixed
(consistency is scored in one candidate ordering; mixed-relation structures
emit the connected GROUP, not the whole structure). Plane params are
``offset * unit_normal`` with ``n . p = offset`` (PlaneRCNN convention,
see `data/plane_tools.py`).

The port's copy of ``cnmnet_tpu/data/layout.py``.
"""

from __future__ import annotations

from itertools import combinations as _combinations
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cnmnet_tpu_torch.data.prep import plane_depth_map

# Pairwise relation codes (reference `utils.py:732-760`). With the
# normal-away-from-camera param convention (n . p = d > 0), REL_CONVEX
# means each plane's visible anchor lies on the CAMERA side of the other
# plane — a room-interior corner, where the nearer plane owns the pixel;
# REL_CONCAVE is the box-corner-from-outside case (farther plane owns).
REL_NONE = 0
REL_CONVEX = 1
REL_CONCAVE = 2

_PARALLEL_COS = float(np.cos(np.deg2rad(30.0)))
_FAR_DEPTH = 10.0


def _unit_normals(planes: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(planes, axis=-1, keepdims=True)
    return planes / np.maximum(n, 1e-4)


def _anchor_points(
    plane_indices: Sequence[int],
    segmentation: np.ndarray,
    depth_source: np.ndarray,
    K_inv: np.ndarray,
) -> np.ndarray:
    """3D anchor per plane: the back-projection of its mask centroid.

    depth_source: [N_all, H, W] per-plane depths (layout path) or a shared
    [H, W] observed depth (structures path, `utils.py:950-956`).
    """
    pts = np.zeros((len(plane_indices), 3))
    for row, idx in enumerate(plane_indices):
        ys, xs = np.nonzero(segmentation == idx)
        u, v = int(round(xs.mean())), int(round(ys.mean()))
        d = (
            depth_source[row, v, u]
            if depth_source.ndim == 3
            else depth_source[v, u]
        )
        pts[row] = (K_inv @ np.array([u, v, 1.0])) * d
    return pts


def pairwise_plane_relations(
    planes: np.ndarray, anchor_points: np.ndarray
) -> np.ndarray:
    """Classify every plane pair as none/convex/concave
    (`utils.py:732-760`, vectorized).

    planes: [M, 3] params in the camera frame; anchor_points: [M, 3] one
    visible 3D point per plane. REL_CONVEX when each anchor lies on the
    camera side of the other plane (room-interior corner), REL_CONCAVE
    otherwise; near-parallel pairs (< 30 deg apart) are unrelated.
    """
    normals = _unit_normals(np.asarray(planes, dtype=np.float64))
    m = len(normals)
    rel = np.full((m, m), REL_NONE, dtype=np.int32)
    if m < 2:
        return rel
    cosang = np.abs(normals @ normals.T)
    diff = anchor_points[None, :, :] - anchor_points[:, None, :]  # p_j - p_i
    side = np.einsum("ik,ijk->ij", normals, diff)  # n_i . (p_j - p_i)
    convex = (side <= 0) & (side.T < 0)
    tested = ~np.eye(m, dtype=bool) & (cosang <= _PARALLEL_COS)
    rel[tested] = np.where(convex | convex.T, REL_CONVEX, REL_CONCAVE)[tested]
    return rel


def _morph_gradient(mask: np.ndarray) -> np.ndarray:
    """3x3 dilation minus erosion of a boolean mask (boundary band),
    shift-based numpy (replaces the reference's cv2 calls,
    `utils.py:822-824`)."""
    pad = np.pad(mask, 1, mode="edge")
    shifts = [
        pad[1 + dy : pad.shape[0] - 1 + dy, 1 + dx : pad.shape[1] - 1 + dx]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
    ]
    stack = np.stack(shifts)
    return stack.any(axis=0) & ~stack.all(axis=0)


def extract_layout(
    planes: np.ndarray,
    depth: np.ndarray,
    segmentation: np.ndarray,
    K_inv: np.ndarray,
    plane_labels: Sequence[int],
    layout_labels: Sequence[int],
    plane_depths: Optional[np.ndarray] = None,
    min_area_frac: float = 0.02,
    depth_margin: float = 0.2,
    consistency_frac: float = 0.9,
) -> Tuple[np.ndarray, Dict[Tuple[int, int], Tuple[np.ndarray, int]]]:
    """Room-layout decomposition (`getLayout`, `utils.py:687-835` live path).

    Searches plane combinations (largest joint visible area first) for one
    whose mutual convex/concave depth partition (a) never undercuts the
    observed depth by more than ``depth_margin`` on > 10% of valid pixels
    and (b) agrees with the visible layout segmentation on >=
    ``consistency_frac`` of its area — i.e. the walls/floor/ceiling that
    together form the room hull.

    Args:
      planes: [N, 3] camera-frame params; depth: [H, W] observed;
      segmentation: [H, W] plane index per pixel (-1 = none);
      plane_labels: [N] semantic label per plane (the reference reads
      ``plane_info[i][0][1]``); layout_labels: labels that may form layout
      (floor/wall/ceiling ids); plane_depths: optional precomputed
      [N, H, W] analytic plane depths.

    Returns ``(layout, boundaries)``: layout is [H, W] int32 of ORIGINAL
    plane indices (-1 = not layout); boundaries maps original-index pairs
    to ``(boundary_mask, relation)`` bands along their intersection.
    """
    h, w = depth.shape
    segmentation = np.asarray(segmentation)
    layout = np.full((h, w), -1, dtype=np.int32)
    layout_set = set(int(l) for l in layout_labels)

    if plane_depths is None:
        plane_depths = plane_depth_map(np.asarray(planes), K_inv, h, w)

    # Candidates: layout-labeled planes covering >= min_area_frac, largest
    # first. (The reference builds its visible map pre-sort and compares it
    # against post-sort indices — fixed here: one ordering throughout.)
    cand = [
        (int(i), int((segmentation == i).sum()))
        for i in range(len(planes))
        if int(plane_labels[i]) in layout_set
    ]
    cand = [(i, a) for i, a in cand if a >= h * w * min_area_frac]
    cand.sort(key=lambda t: -t[1])
    if not cand:
        return layout, {}
    indices = np.array([i for i, _ in cand])
    areas = np.array([a for _, a in cand])
    masks = np.stack([segmentation == i for i in indices])  # [M, H, W]
    depths = plane_depths[indices].copy()  # [M, H, W]
    depths[depths < 1e-4] = _FAR_DEPTH

    anchors = _anchor_points(indices, segmentation, plane_depths[indices], K_inv)
    rel = pairwise_plane_relations(planes[indices], anchors)

    visible = np.full((h, w), -1, dtype=np.int32)  # candidate-row space
    for row in range(len(indices) - 1, -1, -1):
        visible[masks[row]] = row

    # Pair ownership: pixels where row i beats row j (`utils.py:786-800`).
    def pair_mask(i: int, j: int) -> np.ndarray:
        if rel[i, j] == REL_NONE:
            return ~masks[j]
        if rel[i, j] == REL_CONVEX:
            return depths[i] < depths[j]
        return depths[i] > depths[j]

    valid = depth > 1e-4
    valid_area = int(valid.sum())

    combos = [
        (c, int(areas[list(c)].sum()))
        for k in range(2, len(indices) + 1)
        for c in _combinations(range(len(indices)), k)
    ]
    combos = [(c, a) for c, a in combos if a > areas[0]]
    combos.sort(key=lambda t: -t[1])

    for combo, area in combos:
        combo = list(combo)
        combo_depth = np.zeros((h, w))
        for i in combo:
            own = np.ones((h, w), dtype=bool)
            for j in combo:
                if j != i:
                    own &= pair_mask(i, j)
            combo_depth[own] = depths[i][own]
        # The layout hull must not sit in front of observed geometry.
        if ((combo_depth < depth - depth_margin) & valid).sum() > valid_area * 0.1:
            continue
        combo_seg = np.array(combo)[depths[combo].argmin(axis=0)]
        combo_seg[combo_depth >= _FAR_DEPTH] = -1
        if (combo_seg == visible).sum() < area * consistency_frac:
            continue
        layout = np.where(combo_seg >= 0, indices[np.maximum(combo_seg, 0)], -1)
        boundaries: Dict[Tuple[int, int], Tuple[np.ndarray, int]] = {}
        for ii, i in enumerate(combo):
            for j in combo[ii + 1 :]:
                if rel[i, j] == REL_NONE:
                    continue
                a, b = sorted((int(indices[i]), int(indices[j])))
                boundaries[(a, b)] = (
                    _morph_gradient(pair_mask(i, j)),
                    int(rel[i, j]),
                )
        return layout.astype(np.int32), boundaries

    # Fallback (`utils.py:833-835`): the largest candidate's plane, where it
    # has positive analytic depth, over the visible candidate regions.
    for row in range(len(indices) - 1, -1, -1):
        layout[masks[row]] = indices[row]
    layout[plane_depths[indices[0]] > 1e-4] = indices[0]
    return layout, {}


def group_structures(
    planes: np.ndarray,
    plane_info: Sequence[Sequence],
    segmentation: np.ndarray,
    depth: np.ndarray,
    K_inv: np.ndarray,
    depth_tolerance: float = 0.1,
    outlier_frac: float = 0.2,
) -> Dict[int, List[Tuple[np.ndarray, np.ndarray]]]:
    """Structure grouping (`getStructures`, `utils.py:893-1086`).

    plane_info follows the ScanNet annotation format: per plane,
    ``info[0] = (plane_id, semantic_label)`` and ``info[1:]`` are
    ``(structure_index, ...)`` memberships. Planes sharing a structure are
    classified jointly convex/concave by majority pairwise relation (mixed
    structures split into connected components of the majority graph — the
    reference emits the whole structure there; the component is the
    intent). Each surviving k-plane structure is validated against the
    observed depth (its min/max plane-depth envelope must match within
    ``depth_tolerance`` on >= 1 - ``outlier_frac`` of valid pixels).

    Returns ``{label: [(params, union_mask), ...]}`` with label 0 =
    individual planes and ``(k - 2) * 2 + {1: convex, 2: concave}`` for
    k-plane structures; 3-plane structures order the most-horizontal plane
    first (`utils.py:1067-1072`).
    """
    planes = np.asarray(planes, dtype=np.float64)
    n = len(planes)
    seg_masks = [segmentation == i for i in range(n)]
    empty = [not m.any() for m in seg_masks]

    anchor_rows = [i for i in range(n) if not empty[i]]
    anchors_all = np.zeros((n, 3))
    if anchor_rows:
        anchors_all[anchor_rows] = _anchor_points(
            anchor_rows, segmentation, np.asarray(depth, dtype=np.float64), K_inv
        )

    structure_members: Dict[int, List[int]] = {}
    individual: List[int] = []
    for i, info in enumerate(plane_info):
        if empty[i]:
            continue
        if len(info) == 1:
            individual.append(i)
            continue
        for membership in info[1:]:
            structure_members.setdefault(int(membership[0]), []).append(i)

    structures: List[Tuple[List[int], int]] = []  # (indices, 0=convex/1=concave)
    for members in structure_members.values():
        members = sorted(set(members))
        if len(members) == 1:
            if members[0] not in individual:
                individual.append(members[0])
            continue
        rel = pairwise_plane_relations(planes[members], anchors_all[members])
        iu = np.triu_indices(len(members), k=1)
        pair_rel = rel[iu]
        n_convex = int((pair_rel == REL_CONVEX).sum())
        n_concave = int((pair_rel == REL_CONCAVE).sum())
        if n_convex == 0 and n_concave == 0:
            individual.extend(m for m in members if m not in individual)
        elif n_concave == 0:
            structures.append((members, 0))
        elif n_convex == 0:
            structures.append((members, 1))
        else:
            target = REL_CONVEX if n_convex > n_concave else REL_CONCAVE
            adj = rel == target
            unvisited = set(range(len(members)))
            while unvisited:
                seed = unvisited.pop()
                comp, frontier = {seed}, [seed]
                while frontier:
                    node = frontier.pop()
                    for nb in np.nonzero(adj[node])[0]:
                        if nb in unvisited:
                            unvisited.discard(int(nb))
                            comp.add(int(nb))
                            frontier.append(int(nb))
                comp_idx = sorted(members[c] for c in comp)
                if len(comp_idx) == 1:
                    if comp_idx[0] not in individual:
                        individual.append(comp_idx[0])
                else:
                    structures.append((comp_idx, target - 1))

    structures += [([i], 0) for i in individual]

    h, w = np.asarray(depth).shape
    out: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    for members, concave_flag in structures:
        if len(members) == 1:
            out.setdefault(0, []).append(
                (planes[members[0]], seg_masks[members[0]])
            )
            continue
        union = np.any(np.stack([seg_masks[m] for m in members]), axis=0)
        pd = plane_depth_map(planes[members], K_inv, h, w)
        if concave_flag == 0:  # convex: nearest face wins
            pd = pd.copy()
            pd[pd < 1e-4] = _FAR_DEPTH
            envelope = pd.min(axis=0)
        else:
            envelope = pd.max(axis=0)
        vis = depth[union]
        env = envelope[union]
        ok = vis > 1e-4
        if (np.abs(env[ok] - vis[ok]) > depth_tolerance).sum() > ok.sum() * outlier_frac:
            for m in members:
                out.setdefault(0, []).append((planes[m], seg_masks[m]))
            continue
        params = sorted((planes[m] for m in members), key=lambda p: p[0])
        if len(members) == 3:
            # Most-horizontal plane first. This module uses the standard
            # camera frame (y down, z forward), so gravity lives on index 1
            # — NOT index 2, which is the reference's axis-swapped
            # [x, forward, up] frame (`data_prepare/utils.py:1016-1020`);
            # abs(p[2]) here would pick the most fronto-parallel wall.
            horiz = np.argmax(
                [abs(p[1]) / max(np.linalg.norm(p), 1e-4) for p in params]
            )
            params = [params[horiz]] + params[:horiz] + params[horiz + 1 :]
        label = (len(members) - 2) * 2 + (1 if concave_flag == 0 else 2)
        out.setdefault(label, []).append((np.concatenate(params), union))
    return out
