"""Pairwise alignment diagnostics (counterpart of
`spateo_tpu.plotting.three_d_plot.pairwise_align_plots`; reference
spateo/plotting/static/three_d_plot/pairwise_align_plots.py:29 `pi_heatmap`,
:89 `pairwise_mapping`, :540 `pairwise_iteration`, :813
`pairwise_iteration_panel`).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none. `pairwise_exp_similarity` computes its
distances with the port's `calc_distance` on `device`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ..utils import _pyplot, resolve_cmap, save_return_show_fig_utils


def _iter_frames(iter_added) -> List[np.ndarray]:
    """Normalize a Morpho iteration trace into an ordered list of [N, 2]
    frames. Accepts the reference iter_added dict ({key: {it: coords},
    "sigma2": {it: s2}}, morpho_class.py:1043) or a plain sequence."""
    if isinstance(iter_added, dict):
        coord_keys = [k for k in iter_added if k != "sigma2"]
        inner = iter_added[coord_keys[0]]
        frames = [np.asarray(inner[i], dtype=float)[:, :2] for i in sorted(inner)]
    else:
        frames = [np.asarray(f, dtype=float)[:, :2] for f in iter_added]
    return frames


def _lexsort_pi(pi: np.ndarray) -> np.ndarray:
    """Reorder the transport plan so its mass concentrates along the
    diagonal (reference pairwise_align_plots.py:59-60: lexsort columns by
    the rows read bottom-up, then rows by the columns read right-to-left)."""
    pi = np.asarray(pi, dtype=float)
    sort_pi = pi.T[np.lexsort(pi[::-1, :])].T
    sort_pi = sort_pi[np.lexsort(sort_pi[:, ::-1].T)]
    return sort_pi


def pi_heatmap(
    pi: np.ndarray,
    model1_name: str = "model1",
    model2_name: str = "model2",
    colormap: str = "hot_r",
    fig_height: float = 3,
    robust: bool = False,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    fontsize: int = 12,
    filename: Optional[str] = None,
    ax=None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Heatmap of the alignment transport plan / posterior P
    (parity: reference pairwise_align_plots.py:29 — same signature;
    rows/columns are lexsorted first and the figure keeps the matrix's
    aspect ratio)."""
    plt = _pyplot()

    sort_pi = _lexsort_pi(pi)
    if ax is None:
        aspect_ratio = sort_pi.shape[1] / sort_pi.shape[0]
        fig, ax = plt.subplots(figsize=(fig_height * aspect_ratio, fig_height))
    else:
        fig = ax.figure
    if robust and vmin is None and vmax is None:
        vmin, vmax = np.percentile(sort_pi, 2.0), np.percentile(sort_pi, 98.0)
    im = ax.imshow(sort_pi, cmap=resolve_cmap(colormap), aspect="auto", vmin=vmin, vmax=vmax, **kwargs)
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_xlabel(model2_name, labelpad=5, loc="center", fontsize=fontsize, fontweight="regular")
    ax.set_ylabel(model1_name, labelpad=5, loc="center", fontsize=fontsize, fontweight="regular")
    plt.colorbar(im, ax=ax, shrink=0.7)
    if filename:
        fig.savefig(filename, dpi=300, bbox_inches="tight")
    return save_return_show_fig_utils(save_show_or_return, False, None, "pi_heatmap", save_kwargs, 1, fig, ax)


def pairwise_mapping(
    idA: str = "sampleA",
    idB: str = "sampleB",
    adataA=None,
    adataB=None,
    pi: Optional[np.ndarray] = None,
    modelA=None,
    modelB=None,
    model_lines=None,
    layer: str = "X",
    group_key=None,
    spatial_key: str = "align_spatial",
    keep_all: bool = False,
    distance: Optional[float] = 300,
    direction: str = "z",
    filename: Optional[str] = None,
    modelA_cmap: str = "dodgerblue",
    modelB_cmap: str = "red",
    line_color: str = "gainsboro",
    line_alpha: float = 1.0,
    model_opacity: float = 1.0,
    line_opacity: float = 0.03,
    model_size: float = 6.0,
    line_size: float = 2.0,
    point_size: Optional[float] = None,
    **kwargs,
):
    """3D view of two aligned slices, model B offset by `distance` along
    `direction`, with one line per A-cell to its optimal B partner under
    the transport plan (parity: reference pairwise_align_plots.py:89 —
    pairs come from get_optimal_mapping_relationship, deduplicated to the
    highest-pi partner per A cell; cells are colored by `group_key`
    (obs column or gene) when given, else by sample id).

    Returns (fig, mapping_data) where mapping_data holds the drawn
    index_x/index_y/pi_value rows."""
    import pandas as pd

    from ...alignment.utils import get_optimal_mapping_relationship

    plt = _pyplot()

    if point_size is not None:  # back-compat alias
        model_size = point_size
    ptsA = np.asarray(adataA.obsm[spatial_key], dtype=float)
    ptsB = np.asarray(adataB.obsm[spatial_key], dtype=float)
    if ptsA.shape[1] == 2:
        ptsA = np.concatenate([ptsA, np.zeros((len(ptsA), 1))], 1)
    if ptsB.shape[1] == 2:
        ptsB = np.concatenate([ptsB, np.zeros((len(ptsB), 1))], 1)
    offset = {"x": np.array([-1.0, 0, 0]), "y": np.array([0, -1.0, 0]), "z": np.array([0, 0, -1.0])}[direction]
    models_distance = offset * (distance if distance is not None else 0.0)
    ptsB = ptsB + models_distance

    max_index, pi_value, _, _ = get_optimal_mapping_relationship(
        X=ptsA.copy(), Y=ptsB.copy(), pi=np.asarray(pi), keep_all=keep_all
    )
    mapping_data = pd.DataFrame(
        {
            "index_x": max_index[:, 0].astype(np.int64),
            "index_y": max_index[:, 1].astype(np.int64),
            "pi_value": pi_value[:, 0].astype(np.float64),
        }
    )
    mapping_data.sort_values(by=["index_x", "pi_value"], ascending=[True, False], inplace=True)
    mapping_data.drop_duplicates(subset=["index_x"], keep="first", inplace=True)

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")

    def _scatter_group(pts, adata, cmap_color, label):
        if group_key is not None and adata is not None and group_key in getattr(adata.obs, "columns", []):
            groups = np.asarray(adata.obs[group_key]).astype(str)
            for g in np.unique(groups):
                m = groups == g
                ax.scatter(pts[m, 0], pts[m, 1], pts[m, 2], s=model_size, alpha=model_opacity,
                           linewidths=0, label=f"{label}:{g}")
        elif group_key is not None and adata is not None and group_key in list(map(str, adata.var_names)):
            X = adata.layers[layer] if layer != "X" else adata.X
            X = X.toarray() if hasattr(X, "toarray") else np.asarray(X)
            vals = np.asarray(X)[:, list(map(str, adata.var_names)).index(group_key)].astype(float)
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=vals, cmap="viridis", s=model_size,
                       alpha=model_opacity, linewidths=0, label=label)
        else:
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=model_size, color=cmap_color,
                       alpha=model_opacity, linewidths=0, label=label)

    _scatter_group(ptsA, adataA, modelA_cmap, idA)
    _scatter_group(ptsB, adataB, modelB_cmap, idB)

    segs = mapping_data[["index_x", "index_y"]].values
    for i, j in segs:
        ax.plot([ptsA[i, 0], ptsB[j, 0]], [ptsA[i, 1], ptsB[j, 1]], [ptsA[i, 2], ptsB[j, 2]],
                color=line_color, alpha=max(line_opacity, line_alpha * line_opacity), lw=line_size * 0.25)
    ax.legend(frameon=False, fontsize=8)
    ax.set_title(f"Models id: {idA} & {idB}", fontsize=10)
    ax.set_axis_off()
    if filename:
        fig.savefig(filename, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return filename, mapping_data
    return fig, mapping_data


def pairwise_exp_similarity(
    adataA,
    adataB,
    cells: Union[int, str, list],
    layer: str = "X",
    spatial_key: str = "spatial",
    dissimilarity: str = "both",
    beta2: float = 0.5,
    colormap: str = "viridis",
    star_cell_color: str = "red",
    model_size: float = 5.0,
    star_cell_size: float = 40.0,
    filename: Optional[str] = None,
    device="cuda",
    **kwargs,
):
    """For chosen cells of slice A, color slice B by the expression-based
    assignment probability exp(-d/(2*beta2)) under each requested metric
    (parity: reference pairwise_align_plots.py:349 `pairwise_exp_similarity`;
    pyvista scenes become a matplotlib panel grid here). Returns the figure.
    The distances are the port's `calc_distance` on `device`, in float32."""
    from ...alignment.methods.math import as_tensor, calc_distance

    plt = _pyplot()

    def _X(a):
        X = a.layers[layer] if layer != "X" else a.X
        X = X.toarray() if hasattr(X, "toarray") else np.asarray(X)
        return np.asarray(X, dtype=float)

    X_A, X_B = _X(adataA), _X(adataB)
    if isinstance(cells, (int, str)):
        cells = [cells]
    cell_idx = [list(adataA.obs_names).index(c) if isinstance(c, str) else int(c) for c in cells]
    metrics = ["euc", "kl"] if dissimilarity == "both" else [dissimilarity]
    sims = {}
    for m in metrics:
        [D] = calc_distance(as_tensor(X_A[cell_idx], device), as_tensor(X_B, device), metric=m)
        sims[m] = np.exp(-np.asarray(D.cpu(), dtype=float) / (2 * beta2))

    ptsA = np.asarray(adataA.obsm[spatial_key], dtype=float)
    ptsB = np.asarray(adataB.obsm[spatial_key], dtype=float)
    nrow, ncol = len(cell_idx), len(metrics)
    fig, axes = plt.subplots(nrow, ncol, figsize=(4 * ncol, 4 * nrow), squeeze=False)
    for r, ci in enumerate(cell_idx):
        for c, m in enumerate(metrics):
            ax = axes[r][c]
            sc = ax.scatter(ptsB[:, 0], ptsB[:, 1], c=sims[m][r], s=model_size,
                            cmap=resolve_cmap(colormap), linewidths=0, **kwargs)
            ax.scatter([ptsA[ci, 0]], [ptsA[ci, 1]], marker="*", s=star_cell_size,
                       color=star_cell_color, zorder=3)
            ax.set_title(f"cell {ci} ({m})", fontsize=9)
            ax.set_aspect("equal")
            ax.set_axis_off()
            plt.colorbar(sc, ax=ax, shrink=0.7)
    if filename:
        fig.savefig(filename, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return filename
    return fig


def pairwise_iteration(
    adataA=None,
    adataB=None,
    iter_key_added: str = "iter_spatial",
    spatial_key: str = "align_spatial",
    filename: str = "pairwise_iteration.gif",
    fps: int = 10,
    point_size: float = 3.0,
    **kwargs,
):
    """Animate the moving slice's positions over EM iterations stored in
    `.uns[iter_key_added]` (the reference iter_added dict
    {key: {it: coords}, "sigma2": {it: s2}}, or a plain list of snapshots)
    (parity: reference pairwise_align_plots.py:540)."""
    from matplotlib import animation

    plt = _pyplot()

    frames = _iter_frames(adataA.uns[iter_key_added])
    fixed = np.asarray(adataB.obsm[spatial_key], dtype=float)[:, :2]
    fig, ax = plt.subplots(figsize=(5, 5))
    allp = np.concatenate([fixed] + frames)
    ax.set_xlim(allp[:, 0].min(), allp[:, 0].max())
    ax.set_ylim(allp[:, 1].min(), allp[:, 1].max())
    ax.set_aspect("equal")
    ax.scatter(fixed[:, 0], fixed[:, 1], s=point_size, color="tab:blue", linewidths=0)
    mv = ax.scatter(frames[0][:, 0], frames[0][:, 1], s=point_size, color="tab:red", linewidths=0)

    def update(i):
        mv.set_offsets(frames[i])
        ax.set_title(f"iteration {i}")
        return (mv,)

    anim = animation.FuncAnimation(fig, update, frames=len(frames), blit=True)
    anim.save(filename, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return filename


def pairwise_iteration_panel(
    adataA=None,
    adataB=None,
    iter_key_added: str = "iter_spatial",
    spatial_key: str = "align_spatial",
    ncols: int = 4,
    point_size: float = 2.0,
    filename: Optional[str] = None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Grid of EM-iteration snapshots (parity: reference
    pairwise_align_plots.py:813)."""
    plt = _pyplot()

    frames = _iter_frames(adataA.uns[iter_key_added])
    if len(frames) > ncols * ncols:  # subsample a panel-sized selection
        idx = np.linspace(0, len(frames) - 1, ncols * ncols).astype(int)
        frames = [frames[i] for i in idx]
    fixed = np.asarray(adataB.obsm[spatial_key], dtype=float)[:, :2]
    n = len(frames)
    ncols = min(ncols, n)
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(2.5 * ncols, 2.5 * nrows), squeeze=False)
    flat = axes.ravel()
    for i, f in enumerate(frames):
        flat[i].scatter(fixed[:, 0], fixed[:, 1], s=point_size, color="tab:blue", linewidths=0)
        flat[i].scatter(f[:, 0], f[:, 1], s=point_size, color="tab:red", linewidths=0)
        flat[i].set_title(f"iter {i}", fontsize=8)
        flat[i].set_aspect("equal")
        flat[i].set_xticks([])
        flat[i].set_yticks([])
    for j in range(n, len(flat)):
        flat[j].axis("off")
    if filename:
        fig.savefig(filename, dpi=150, bbox_inches="tight")
    return save_return_show_fig_utils(save_show_or_return, False, None, "pairwise_iteration_panel", save_kwargs, n, fig, list(flat[:n]))
