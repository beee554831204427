"""3D reconstruction correction against a reference mesh (counterpart of
`spateo_tpu.alignment.methods.mesh_correction`; reference
spateo/alignment/methods/morpho_mesh_correction.py:39 `Mesh_correction` +
mesh_correction_utils.py).

The per-slice rigid drift left by sequential pairwise alignment is corrected
by registering slice contours to the iso-z sections of a whole-organ mesh: a
5-variable MRF (3 rotations, z-translation, scaling) over discretized labels,
solved by the host C++ solver `native.fastpd`, inside an annealed loop.

The JAX package fills each of the ten [L, L] pairwise cost tables of a step
with a host loop: per candidate transform, a numpy mesh transform, its iso-z
sections and one 10-iteration ICP (numpy + cKDTree) per slice. Here the
candidates of all ten tables go to `device` as one batch and the same
numbers come out:

- the 3x3 rotations are built on the host exactly as the JAX package builds
  them; the transforms of a chunk of candidates are one batched product;
- the sections are a batched edge-plane crossing. A section's points keep
  the reference's order (edges (0,1), (1,2), (2,0), each in face order), so
  a crossing's position is a running count over that order;
- `ICP` seeds ``default_rng(0)`` on every call and draws the contour's
  subsample, then the section's, so the indices depend only on the two
  lengths. They are drawn on the host, once a pair of lengths, after one
  read of every section's length;
- the ICPs run padded to [B, 200, 2] with masks, all `max_iter` iterations,
  each member stopping where the reference's loop breaks (fewer than 3
  inliers, or an error change under `error_threshold`); the nearest
  neighbour is the first argmin of a [B, 200, 200] float64 distance, and the
  rotation of a 2x2 cross-covariance the closed form of its SVD with the
  reflection fixed (the rotation by ``atan2(H01 - H10, H00 + H11)``);
- a step reads the device twice: every section's length, then every
  table's costs.

The reference's `perform_correction` calls an `_eliminate_shift` helper that
does not exist in its codebase; as in the JAX package, each slice contour is
ICP-registered to the corrected mesh's section at its height, all slices in
one batch, and the rigid transform is applied to the slice's cells.
"""

from __future__ import annotations

import functools
import itertools
import time
from typing import Dict, List, Literal, Optional, Tuple, Union

import numpy as np
import torch

from ...logging import logger_manager as lm
from ..utils import _iteration

EDGES = ((0, 1), (1, 2), (2, 0))
#: ICP members (candidate transforms x slices) one pass holds: each needs a
#: [200, 200] float64 distance and two of the same size for its operands.
ICP_MEMBERS = 2048


# ---------------------------------------------------------------------------
# geometry helpers (host)
# ---------------------------------------------------------------------------


def _rotation(rotation) -> np.ndarray:
    """Euler xyz rotation (degrees), ``Rz @ Ry @ Rx``, as `_transform_points`
    builds it."""
    rot = np.deg2rad(np.asarray(rotation, float).ravel())
    cx, cy, cz = np.cos(rot)
    sx, sy, sz = np.sin(rot)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _transform_points(
    points: np.ndarray,
    rotation: Union[np.ndarray, list],
    translation: Union[float, np.ndarray],
    scaling: float,
) -> np.ndarray:
    """Rotate (Euler xyz, degrees) about the centroid, scale, then shift z
    (parity: mesh_correction_utils.py:27). Host numpy."""
    points = np.asarray(points, float)
    R = _rotation(rotation)
    center = points.mean(0)
    out = (points - center) * float(scaling) @ R.T + center
    out[:, 2] += float(np.asarray(translation).ravel()[0] if np.ndim(translation) else translation)
    return out


def _extract_contour_alpha_shape(points: np.ndarray, alpha: float = 0.5) -> List[np.ndarray]:
    """Slice contour via the alpha-shape concave hull
    (parity: mesh_correction_utils.py:159)."""
    from ...io.bbs import alpha_shape

    pts = np.asarray(points, float)[:, :2]
    rings, _ = alpha_shape(pts[:, 0], pts[:, 1], alpha=alpha)
    return [np.asarray(r, float) for r in rings if len(r) >= 3]


def _extract_contour_opencv(points: np.ndarray, average_n: float = 0.2, kernel_size: Optional[int] = None) -> List[np.ndarray]:
    """Raster-based contour: bin points to a grid, close/open, trace the
    boundary (parity surface: mesh_correction_utils.py:95 without cv2 —
    boundary pixels of the filled mask are returned as an ordered ring)."""
    pts = np.asarray(points, float)[:, :2]
    mins, maxs = pts.min(0), pts.max(0)
    span = np.maximum(maxs - mins, 1e-9)
    n_px = int(np.sqrt(len(pts) / max(average_n, 1e-6)))
    n_px = max(min(n_px, 512), 16)
    ij = np.clip(((pts - mins) / span * (n_px - 1)).astype(int), 0, n_px - 1)
    grid = np.zeros((n_px, n_px), bool)
    grid[ij[:, 0], ij[:, 1]] = True
    k = kernel_size or max(n_px // 32, 3)
    from scipy import ndimage

    grid = ndimage.binary_closing(grid, structure=np.ones((k, k)))
    grid = ndimage.binary_fill_holes(grid)
    er = ndimage.binary_erosion(grid)
    boundary = grid & ~er
    by, bx = np.nonzero(boundary)
    if len(by) < 3:
        return []
    coords = np.stack([by, bx], 1).astype(float) / (n_px - 1) * span + mins
    c = coords.mean(0)
    order = np.argsort(np.arctan2(coords[:, 1] - c[1], coords[:, 0] - c[0]))
    return [coords[order]]


def _smooth_contours(vertex: List[np.ndarray], window_size: int = 5, iterations: int = 1) -> List[np.ndarray]:
    """Circular moving-average smoothing (parity:
    mesh_correction_utils.py:190)."""
    out = []
    for v in vertex:
        v = np.asarray(v, float)
        for _ in range(iterations):
            if len(v) < window_size:
                break
            pad = window_size // 2
            vp = np.concatenate([v[-pad:], v, v[:pad]])
            kern = np.ones(window_size) / window_size
            v = np.stack([np.convolve(vp[:, d], kern, mode="valid") for d in range(v.shape[1])], 1)
        out.append(v)
    return out


@functools.lru_cache(maxsize=None)
def _subsample_draws(n1: int, n2: int, subsample: int, seed: int = 0):
    """`ICP`'s subsample indices for inputs of `n1` and `n2` points: one
    ``default_rng(seed)``, the first set's draw before the second's; None
    where a set is kept whole."""
    rng = np.random.default_rng(seed)
    i1 = rng.choice(n1, subsample, replace=False) if subsample > 0 and n1 > subsample else None
    i2 = rng.choice(n2, subsample, replace=False) if subsample > 0 and n2 > subsample else None
    return i1, i2


def _padded(arrays: List[np.ndarray], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, 2] float64 and its [B, N] mask from ragged [n_i, 2] arrays."""
    N = max(max((len(a) for a in arrays), default=1), 1)
    out = np.zeros((len(arrays), N, 2))
    mask = np.zeros((len(arrays), N), bool)
    for i, a in enumerate(arrays):
        out[i, : len(a)] = a
        mask[i, : len(a)] = True
    return torch.from_numpy(out).to(device), torch.from_numpy(mask).to(device)


# ---------------------------------------------------------------------------
# batched device pieces
# ---------------------------------------------------------------------------


def _transform_batch(P: torch.Tensor, center: torch.Tensor, R: torch.Tensor, translation: torch.Tensor,
                     scaling: torch.Tensor) -> torch.Tensor:
    """[c, V, 3] images of the mesh points `P` [V, 3] under c transforms."""
    out = torch.matmul((P - center)[None] * scaling[:, None, None], R.transpose(1, 2)) + center
    out[..., 2] += translation[:, None]
    return out


def _crossings(tpz: torch.Tensor, faces: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """[c, S, 3F]: whether edge e of face f crosses plane s, in the reference
    order (edge-major, faces in order within an edge)."""
    zz = z[None, :, None]
    return torch.cat([
        ((tpz[:, faces[:, a]][:, None] - zz) * (tpz[:, faces[:, b]][:, None] - zz)) < 0 for a, b in EDGES
    ], -1)


def _crossing_points(tp: torch.Tensor, faces: torch.Tensor, z: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """The section points at crossing slots `flat` [c, S, K] (indices into
    3F): the edge's interpolated intersection with its plane, [c, S, K, 2]."""
    F = faces.shape[0]
    ea = torch.tensor([a for a, _ in EDGES], device=tp.device)[flat // F]
    eb = torch.tensor([b for _, b in EDGES], device=tp.device)[flat // F]
    f = flat % F
    rows = torch.arange(tp.shape[0], device=tp.device)[:, None, None]
    A = tp[rows, faces[f, ea]]
    B = tp[rows, faces[f, eb]]
    t = (z[None, :, None] - A[..., 2]) / (B[..., 2] - A[..., 2])
    return A[..., :2] + t[..., None] * (B[..., :2] - A[..., :2])


def _icp_batch(c1, mask1, c2, mask2, max_iter: int = 20, error_threshold: float = 1e-6,
               inlier_threshold: float = 0.1, allow_rotation: bool = False):
    """`ICP` of B padded problems at once: model points `c2` [B, N2, 2] onto
    data points `c1` [B, N1, 2] (masks [B, N]). Every member runs the
    reference loop with its own stops; no host read. Returns (gamma [B],
    translation [B, 2], aligned c2 [B, N2, 2], R [B, 2, 2])."""
    dt = c1.dtype
    n1 = mask1.sum(1).to(dt)
    n2 = mask2.sum(1).to(dt)

    def mid(c, m):
        mx = torch.where(m[..., None], c, -torch.inf).amax(1)
        mn = torch.where(m[..., None], c, torch.inf).amin(1)
        return (mx + mn) / 2

    m1, m2 = mid(c1, mask1), mid(c2, mask2)
    c1d = c1 - m1[:, None]
    c2d = c2 - m2[:, None]
    rms1 = torch.sqrt(torch.where(mask1[..., None], c1d**2, 0.0).sum((1, 2)) / n1)
    rms2 = torch.sqrt(torch.where(mask2[..., None], c2d**2, 0.0).sum((1, 2)) / n2)
    scale = ((rms1 + rms2) / 2).clamp_min(1e-12)
    c1d = c1d / scale[:, None, None]
    T2 = c2d / scale[:, None, None]
    B = c1.shape[0]
    R_total = torch.eye(2, dtype=dt, device=c1.device).expand(B, 2, 2)
    t_total = torch.zeros(B, 2, dtype=dt, device=c1.device)
    prev_err = torch.full((B,), torch.inf, dtype=dt, device=c1.device)
    active = torch.ones(B, dtype=torch.bool, device=c1.device)
    pad1 = ~mask1[:, None, :]

    def nearest(T):
        dx = T[:, :, None, 0] - c1d[:, None, :, 0]
        dy = T[:, :, None, 1] - c1d[:, None, :, 1]
        d2, idx = (dx * dx + dy * dy).masked_fill_(pad1, torch.inf).min(2)
        return torch.sqrt(d2), idx

    for _ in range(max_iter):
        dist, idx = nearest(T2)
        inl = (dist < inlier_threshold) & mask2
        n_inl = inl.sum(1)
        go = active & (n_inl >= 3)
        w = inl.to(dt)[..., None]
        cnt = n_inl.clamp_min(1).to(dt)[:, None]
        dst = torch.gather(c1d, 1, idx[..., None].expand(-1, -1, 2))
        sm = (T2 * w).sum(1) / cnt
        dm = (dst * w).sum(1) / cnt
        if allow_rotation:
            H = torch.einsum("bni,bnj->bij", (T2 - sm[:, None]) * w, dst - dm[:, None])
            th = torch.atan2(H[:, 0, 1] - H[:, 1, 0], H[:, 0, 0] + H[:, 1, 1])
            c, s = torch.cos(th), torch.sin(th)
            R = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
            t = dm - torch.einsum("bij,bj->bi", R, sm)
        else:
            R = torch.eye(2, dtype=dt, device=c1.device).expand(B, 2, 2)
            t = dm - sm
        err = (dist * w[..., 0]).sum(1) / cnt[:, 0]
        g = go[:, None]
        T2 = torch.where(g[..., None], torch.einsum("bnj,bij->bni", T2, R) + t[:, None], T2)
        R_total = torch.where(g[..., None], R @ R_total, R_total)
        t_total = torch.where(g, torch.einsum("bij,bj->bi", R, t_total) + t, t_total)
        active = go & ~((prev_err - err).abs() < error_threshold)
        prev_err = torch.where(go, err, prev_err)
    dist, _ = nearest(T2)
    gamma = ((dist < 0.05) & mask2).sum(1).to(dt) / n2
    aligned = scale[:, None, None] * T2 + m1[:, None]
    return gamma, t_total * scale[:, None] + m1 - m2, aligned, R_total


# ---------------------------------------------------------------------------
# the reference's helpers, on the batched pieces
# ---------------------------------------------------------------------------


def ICP(
    contour_1: np.ndarray,
    contour_2: np.ndarray,
    max_iter: int = 20,
    error_threshold: float = 1e-6,
    inlier_threshold: float = 0.1,
    subsample: int = 500,
    allow_rotation: bool = False,
    seed: int = 0,
    device="cuda",
) -> Tuple[float, float, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """2D ICP of model points (contour_2) onto data points (contour_1) on
    `device`; returns (gamma, 0, translation, contour_1, aligned_contour_2,
    R) with gamma the fraction of model points within 0.05 of a data point
    in the normalized frame (parity: mesh_correction_utils.py:404)."""
    c1 = np.asarray(contour_1, float)
    c2 = np.asarray(contour_2, float)
    i1, i2 = _subsample_draws(len(c1), len(c2), subsample, seed)
    c1 = c1 if i1 is None else c1[i1]
    c2 = c2 if i2 is None else c2[i2]
    a, ma = _padded([c1], device)
    b, mb = _padded([c2], device)
    gamma, t, aligned, R = _icp_batch(a, ma, b, mb, max_iter, error_threshold, inlier_threshold, allow_rotation)
    return float(gamma[0]), 0.0, t[0].cpu().numpy(), c1, aligned[0].cpu().numpy(), R[0].cpu().numpy()


def _mesh_sections(tp: torch.Tensor, faces: torch.Tensor, z: torch.Tensor) -> List[torch.Tensor]:
    """Every section of one transformed mesh `tp` [V, 3], in the reference's
    point order."""
    cross = _crossings(tp[None, :, 2], faces, z)[0]
    return [_crossing_points(tp[None], faces, z[s:s + 1], torch.nonzero(cross[s])[:, 0][None, None])[0, 0]
            for s in range(len(z))]


def _extract_contours_from_mesh(points: np.ndarray, faces: np.ndarray, z_values: np.ndarray,
                                device="cuda") -> Tuple[List[np.ndarray], bool]:
    """Iso-z sections of a triangle mesh on `device`: each triangle edge
    crossing the plane contributes its interpolated intersection point
    (parity: mesh_correction_utils.py:224)."""
    tp = torch.as_tensor(np.asarray(points, float), device=device)
    fd = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    zd = torch.as_tensor(np.asarray(z_values, float).ravel(), device=device)
    sections = [s.cpu().numpy() for s in _mesh_sections(tp, fd, zd)]
    return sections, all(len(s) for s in sections)


def _losses(contours: List[np.ndarray], mesh_points: np.ndarray, mesh_faces: np.ndarray, z_values: np.ndarray,
            params: np.ndarray, device="cuda", subsample: int = 200, max_iter: int = 10,
            stats: Optional[Dict] = None) -> torch.Tensor:
    """`_calculate_loss` of every transform in `params` [n, 5] at once, as a
    [n] float64 tensor on `device`: the average of 1 - gamma over the slices
    (ICP, rotation allowed, `subsample` points, `max_iter` iterations), 1e6
    where a plane misses the mesh. One host read, of every section's length;
    the result stays on `device`. With `stats`, adds the seconds to that read
    (`sections_s`) and the ICP count (`icps`)."""
    t0 = time.perf_counter()
    params = np.asarray(params, float).reshape(-1, 5)
    n, S = len(params), len(contours)
    P = np.asarray(mesh_points, float)
    Pd = torch.as_tensor(P, device=device)
    center = torch.as_tensor(P.mean(0), device=device)
    faces = torch.as_tensor(np.asarray(mesh_faces, np.int64), device=device)
    z = torch.as_tensor(np.asarray(z_values, float).ravel(), device=device)
    R = torch.as_tensor(np.stack([_rotation(p[:3]) for p in params]), device=device)
    tr = torch.as_tensor(params[:, 3].copy(), device=device)
    sc = torch.as_tensor(params[:, 4].copy(), device=device)
    chunk = max(1, ICP_MEMBERS // max(S, 1))

    def sections(r0, r1):
        tp = _transform_batch(Pd, center, R[r0:r1], tr[r0:r1], sc[r0:r1])
        return tp, _crossings(tp[..., 2], faces, z)

    counts = torch.cat([sections(r0, min(r0 + chunk, n))[1].sum(-1) for r0 in range(0, n, chunk)]).cpu().numpy()
    if stats is not None:
        stats["sections_s"] = stats.get("sections_s", 0.0) + time.perf_counter() - t0
        stats["icps"] = stats.get("icps", 0) + n * S

    # the subsample draws, once a (contour length, section length) pair
    n1 = [len(c) for c in contours]
    first = [_subsample_draws(k, 0, subsample)[0] for k in n1]
    c1 = [c if i1 is None else c[i1] for c, i1 in zip(contours, first)]
    K = int(min(max(counts.max(), 1), subsample if subsample > 0 else counts.max()))
    sel = np.zeros((n, S, K), np.int32)
    sel_mask = np.zeros((n, S, K), bool)
    for s in range(S):
        for u in np.unique(counts[:, s]):
            rows = counts[:, s] == u
            i2 = _subsample_draws(n1[s], int(u), subsample)[1]
            pos = np.arange(u) if i2 is None else i2
            sel[rows, s, : len(pos)] = pos
            sel_mask[rows, s, : len(pos)] = True
    sel_d = torch.as_tensor(sel, device=device)
    sel_mask_d = torch.as_tensor(sel_mask, device=device)
    c1_d, c1_mask = _padded(c1, device)
    ok = torch.as_tensor((counts > 0).all(1), device=device)

    costs = []
    for r0 in range(0, n, chunk):
        r1 = min(r0 + chunk, n)
        tp, cross = sections(r0, r1)
        run = torch.cumsum(cross, -1, dtype=torch.int32)
        flat = torch.searchsorted(run, sel_d[r0:r1] + 1).clamp_max_(cross.shape[-1] - 1)
        pts = _crossing_points(tp, faces, z, flat)
        c = r1 - r0
        gamma, *_ = _icp_batch(
            c1_d.expand(c, -1, -1, -1).reshape(c * S, -1, 2), c1_mask.expand(c, -1, -1).reshape(c * S, -1),
            pts.reshape(c * S, K, 2), sel_mask_d[r0:r1].reshape(c * S, K), max_iter=max_iter, allow_rotation=True,
        )
        gamma = gamma.reshape(c, S)
        cost = torch.zeros(c, dtype=gamma.dtype, device=gamma.device)
        for s in range(S):
            cost = cost + (1.0 - gamma[:, s])
        costs.append(cost / max(S, 1))
    return torch.where(ok, torch.cat(costs), 1e6)


def _calculate_loss(
    contours: List[np.ndarray],
    mesh_points: np.ndarray,
    mesh_faces: np.ndarray,
    transformation: np.ndarray,
    z_values: np.ndarray,
    method: Literal["CPD", "ICP"] = "ICP",
    device="cuda",
) -> float:
    """Average (1 - gamma) over slices, 1e6 when any z plane misses the mesh
    (parity: mesh_correction_utils.py:371)."""
    return float(_losses(contours, mesh_points, mesh_faces, z_values, np.asarray(transformation, float)[None],
                         device=device)[0])


# ---------------------------------------------------------------------------
# discrete optimization scaffolding
# ---------------------------------------------------------------------------


def _generate_labeling(max_value: float, number_of_steps: int, scale_type: str = "linear") -> np.ndarray:
    """Symmetric label ladder with 0 (or 1, in log scale) first
    (parity: mesh_correction_utils.py:246)."""
    if scale_type == "linear":
        vals = np.linspace(-max_value, max_value, number_of_steps)
        vals = np.concatenate([[0.0], vals[vals != 0]])[:number_of_steps]
    elif scale_type == "log":
        vals = np.exp(np.linspace(-np.log(max_value), np.log(max_value), number_of_steps))
        vals = np.concatenate([[1.0], vals[vals != 1.0]])[:number_of_steps]
    else:
        raise ValueError(f"Unknown scale_type: {scale_type}")
    return vals


def _update_parameter(transformation_labels: np.ndarray, parameters: Dict) -> np.ndarray:
    transformation_labels = np.asarray(transformation_labels, float).copy()
    transformation_labels[:, :3] += np.asarray(parameters["rotation"], float)
    transformation_labels[:, 3] += float(parameters["translation"])
    transformation_labels[:, 4] *= float(parameters["scaling"])
    return transformation_labels


def _make_pairs(nVars: int = 5) -> np.ndarray:
    return np.array(list(itertools.combinations(np.arange(nVars), 2)), np.int32)


def _getUnaries(L: int, N: int = 5) -> np.ndarray:
    return np.ones((L, N), np.float32)


def _pair_params(transformation_labels: np.ndarray, pair) -> np.ndarray:
    """The [L * L, 5] transforms of one pair's table, row a * L + b: the
    first label row with `pair`'s two parameters set to labels a and b."""
    L = transformation_labels.shape[0]
    out = np.repeat(transformation_labels[:1], L * L, axis=0)
    a, b = np.divmod(np.arange(L * L), L)
    out[:, pair[0]] = transformation_labels[a, pair[0]]
    out[:, pair[1]] = transformation_labels[b, pair[1]]
    return out


def _get_binary_values(contours, mesh_points, mesh_faces, z_values, pair, transformation_labels,
                       device="cuda") -> np.ndarray:
    """One pair's [L, L] cost table, every entry in one batch on `device`."""
    L = transformation_labels.shape[0]
    losses = _losses(contours, mesh_points, mesh_faces, z_values, _pair_params(transformation_labels, pair), device)
    return losses.cpu().numpy().astype(np.float32).reshape(L, L)


# ---------------------------------------------------------------------------
# the Mesh_correction class
# ---------------------------------------------------------------------------


class Mesh_correction:
    """Correct per-slice rigid drift in a 3D reconstruction using a
    reference mesh (parity surface: reference morpho_mesh_correction.py:39).

    `mesh` is a `tdr.models.mesh_core.Mesh` (points + faces). The cost tables
    and the ICPs run on `device` (default "cuda"); the MRF solve, the
    contours and the label ladders on the host. `step_stats` holds, for each
    discrete step, the seconds of its stages and its ICP count.
    """

    def __init__(
        self,
        slices: List,
        z_heights: Union[List, np.ndarray],
        mesh,
        spatial_key: str = "spatial",
        key_added: str = "align_spatial",
        normalize_spatial: bool = False,
        init_rotation: Optional[np.ndarray] = None,
        init_translation: float = 0.0,
        init_scaling: float = 1.0,
        max_rotation_angle: float = 180,
        max_translation_scale: float = 0.5,
        max_scaling: float = 1.5,
        min_rotation_angle: float = 10,
        min_translation_scale: float = 1,
        min_scaling: float = 1.1,
        label_num: int = 15,
        fastpd_iter: int = 100,
        max_iter: int = 10,
        anneal_rate: float = 0.7,
        multi_processing: bool = False,
        subsample_slices: Optional[int] = None,
        verbose: bool = False,
        device="cuda",
    ) -> None:
        self.device = torch.device(device)
        self.n_slices = len(slices)
        if not all(spatial_key in s.obsm for s in slices):
            raise ValueError("All slices must have the same spatial key in the '.obsm' attribute.")
        self.slices = slices
        self.spatial_key = spatial_key
        self.slices_spatial = [np.asarray(s.obsm[spatial_key], float)[:, :2] for s in slices]

        if z_heights is None:
            raise ValueError("z_heights must be provided.")
        self.z_heights = np.asarray(z_heights, float)
        if len(np.unique(self.z_heights)) != len(self.z_heights):
            raise ValueError("z_heights must be unique value.")
        if len(self.z_heights) != self.n_slices:
            raise ValueError("z_heights must have the same length as the number of slices.")

        self.mesh_points = np.asarray(mesh.points, float).copy()
        self.mesh_faces = np.asarray(mesh.faces, int).copy()
        self.key_added = key_added
        self.normalize_spatial = normalize_spatial
        self.set_init_parameters(init_rotation, init_translation, init_scaling)
        self.normalize_mesh_spatial_coordinates()

        self.max_rotation_angle = max_rotation_angle
        self.max_translation_scale = max_translation_scale
        self.max_scaling = max_scaling
        self.min_rotation_angle = min_rotation_angle
        self.min_translation_scale = min_translation_scale
        self.min_scaling = min_scaling
        self.label_num = label_num
        self.fastpd_iter = fastpd_iter
        self.max_iter = max_iter
        self.anneal_rate = anneal_rate
        self.subsample_slices = subsample_slices
        self.verbose = verbose
        self.contours: List[Optional[np.ndarray]] = [None] * self.n_slices
        self.step_stats: List[Dict] = []

    def set_init_parameters(self, init_rotation=None, init_translation=0.0, init_scaling=1.0):
        """Apply an initial guess transformation to the mesh
        (parity: morpho_mesh_correction.py:130)."""
        rot = np.zeros(3) if init_rotation is None else np.asarray(init_rotation, float)
        self.mesh_points = _transform_points(self.mesh_points, rot, init_translation, init_scaling)

    def normalize_mesh_spatial_coordinates(self):
        """Scale/center the mesh to the slices' z range
        (parity: morpho_mesh_correction.py:147)."""
        self.slices_scale = self.z_heights.max() - self.z_heights.min()
        if self.normalize_spatial:
            mesh_scale = self.mesh_points[:, 2].max() - self.mesh_points[:, 2].min()
            slices_mean_z = (self.z_heights.max() + self.z_heights.min()) / 2
            xy = np.concatenate(self.slices_spatial, axis=0)
            slices_mean_xy = (xy.max(0) + xy.min(0)) / 2
            mesh_mean = (self.mesh_points.max(0) + self.mesh_points.min(0)) / 2
            self.mesh_points = (self.mesh_points - mesh_mean) * self.slices_scale / max(mesh_scale, 1e-12)
            self.mesh_points[:, :2] += slices_mean_xy
            self.mesh_points[:, 2] += slices_mean_z

    def extract_contours(
        self,
        method: Literal["opencv", "alpha_shape"] = "alpha_shape",
        n_sampling: Optional[int] = None,
        smoothing: bool = True,
        window_size: int = 5,
        filter_contours: bool = True,
        contour_filter_threshold: int = 20,
        opencv_kwargs: Optional[Dict] = None,
        alpha_shape_kwargs: Optional[Dict] = None,
    ):
        """Extract each slice's outer contour on the host (parity:
        morpho_mesh_correction.py:185)."""
        opencv_kwargs = opencv_kwargs or {}
        alpha_shape_kwargs = alpha_shape_kwargs or {}
        rng = np.random.default_rng(0)
        for i in _iteration(n=self.n_slices, progress_name=f"Extract contours ({method})", verbose=self.verbose):
            pts = self.slices_spatial[i]
            if n_sampling and 0 < n_sampling < len(pts):
                pts = pts[rng.choice(len(pts), n_sampling, replace=False)]
            if method == "opencv":
                cur = _extract_contour_opencv(pts, **opencv_kwargs)
            elif method == "alpha_shape":
                cur = _extract_contour_alpha_shape(pts, **alpha_shape_kwargs)
            else:
                raise NotImplementedError(f"Method {method} is not implemented.")
            if filter_contours:
                cur = [c for c in cur if c.shape[0] >= contour_filter_threshold]
            if smoothing:
                cur = _smooth_contours(cur, window_size)
            self.contours[i] = np.concatenate(cur, axis=0) if cur else np.zeros((0, 2))

    def run_discrete_optimization(self) -> None:
        """Annealed discrete search over the 5 transform parameters
        (parity: morpho_mesh_correction.py:241)."""
        self.max_translation = self.max_translation_scale * self.slices_scale
        if self.subsample_slices and 0 < self.subsample_slices < self.n_slices:
            pick = np.random.default_rng(0).choice(self.n_slices, self.subsample_slices, replace=False)
            self.contours_subsample = [self.contours[i] for i in pick]
            self.z_heights_subsample = self.z_heights[pick]
        else:
            self.contours_subsample = self.contours
            self.z_heights_subsample = self.z_heights

        self.losses = []
        self.transformations = []
        self.best_loss = 1e8
        self.best_transformation = {"rotation": np.zeros(3), "translation": 0.0, "scaling": 1.0}
        lm.main_info(f"Run discrete optimization on {len(self.contours_subsample)} contours", indent_level=1)
        for i in _iteration(n=self.max_iter, progress_name="Discrete optimization", verbose=self.verbose, indent_level=1):
            cur_loss, cur_transformation = self.discrete_optimization_step()
            if self.verbose:
                lm.main_info(f"Iteration {i + 1}/{self.max_iter}, current loss: {cur_loss}", indent_level=2)
            if cur_loss < self.best_loss:
                self.best_loss = cur_loss
                self.best_transformation = cur_transformation
            self.losses.append(cur_loss)
            self.transformations.append(cur_transformation)
            self.max_rotation_angle = max(self.max_rotation_angle * self.anneal_rate, self.min_rotation_angle)
            self.max_translation = max(self.max_translation * self.anneal_rate, self.min_translation_scale * self.slices_scale)
            self.max_scaling = max(self.max_scaling * self.anneal_rate, self.min_scaling)
        lm.main_info(f"Optimization finished. Best loss: {self.best_loss}", indent_level=1)

    def binary_tables(self, transformation_labels: np.ndarray, pairs: np.ndarray, stats: Optional[Dict] = None):
        """The ten [L, L] cost tables of a step: all candidates in one batch
        on `device`, read back once."""
        L = transformation_labels.shape[0]
        params = np.concatenate([_pair_params(transformation_labels, p) for p in pairs])
        losses = _losses(self.contours_subsample, self.mesh_points, self.mesh_faces, self.z_heights_subsample,
                         params, self.device, stats=stats).cpu().numpy()
        return list(losses.astype(np.float32).reshape(len(pairs), L, L))

    def discrete_optimization_step(self) -> Tuple[float, Dict]:
        """One MRF solve over the current label ladder (parity:
        morpho_mesh_correction.py:291)."""
        from ...native import fastpd

        stats: Dict = {}
        t0 = time.perf_counter()
        transformation_labels = self.generate_labels()
        pairs = _make_pairs()
        u = _getUnaries(self.label_num)
        blist = self.binary_tables(transformation_labels, pairs, stats)
        t1 = time.perf_counter()
        labels = fastpd(u, blist, pairs, self.fastpd_iter)
        t2 = time.perf_counter()
        parameters = np.array([transformation_labels[labels[i], i] for i in range(len(labels))])
        loss = float(_losses(self.contours_subsample, self.mesh_points, self.mesh_faces, self.z_heights_subsample,
                             parameters[None], self.device)[0])
        t3 = time.perf_counter()
        stats.update(tables_s=t1 - t0, fastpd_s=t2 - t1, loss_s=t3 - t2, step_s=t3 - t0)
        self.step_stats.append(stats)
        return loss, {"rotation": parameters[:3], "translation": parameters[3], "scaling": parameters[4]}

    def generate_labels(self) -> np.ndarray:
        """Label ladders centered on the current best transform
        (parity: morpho_mesh_correction.py:330)."""
        rotation_labels = _generate_labeling(self.max_rotation_angle, self.label_num)
        translation_labels = _generate_labeling(self.max_translation, self.label_num)
        scaling_labels = _generate_labeling(self.max_scaling, self.label_num, "log")
        transformation_labels = np.array(
            [rotation_labels, rotation_labels, rotation_labels, translation_labels, scaling_labels]
        ).T
        return _update_parameter(transformation_labels, self.best_transformation)

    def perform_correction(self):
        """Apply the best mesh transform, then rigidly snap each slice onto
        its mesh section, all slices' ICPs in one batch (completes the
        reference's unfinished `perform_correction`,
        morpho_mesh_correction.py:349)."""
        self.mesh_points = _transform_points(
            self.mesh_points,
            self.best_transformation["rotation"],
            self.best_transformation["translation"],
            self.best_transformation["scaling"],
        )
        sections, _ = _extract_contours_from_mesh(self.mesh_points, self.mesh_faces, self.z_heights, self.device)
        todo = [i for i, (c, sec) in enumerate(zip(self.contours, sections))
                if c is not None and len(c) >= 3 and len(sec) >= 3]
        fits = {}
        if todo:
            c1, c2 = [], []
            for i in todo:
                i1, i2 = _subsample_draws(len(sections[i]), len(self.contours[i]), 500)
                c1.append(sections[i] if i1 is None else sections[i][i1])
                c2.append(self.contours[i] if i2 is None else self.contours[i][i2])
            _, t, _, R = _icp_batch(*_padded(c1, self.device), *_padded(c2, self.device), allow_rotation=True)
            t, R = t.cpu().numpy(), R.cpu().numpy()
            fits = {i: (t[k], R[k]) for k, i in enumerate(todo)}
        for i, s in enumerate(self.slices):
            pts = np.asarray(s.obsm[self.spatial_key], float)[:, :2]
            if i in fits:
                t, R = fits[i]
                center = (self.contours[i].max(0) + self.contours[i].min(0)) / 2
                corrected = (pts - center) @ R.T + center + t
            else:
                corrected = pts
            out = np.concatenate([corrected, np.full((len(corrected), 1), self.z_heights[i])], axis=1)
            s.obsm[self.key_added] = out
        return [np.asarray(s.obsm[self.key_added]) for s in self.slices]
