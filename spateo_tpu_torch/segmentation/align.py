"""Stain <-> RNA registration refinement by gradient descent on the device
(counterpart of `spateo_tpu.segmentation.align`; reference
spateo/segmentation/align.py:22-232).

The objective is the JAX package's: the mean squared difference between the
warped stain and the RNA raster, both scaled to [0, 1]. The warps are
written out as `jax.scipy.ndimage.map_coordinates(order=1)` computes them:
floor, the two weights of each axis, the four corners in (y, x) order, each
weight product times its corner, summed in that order; with
``mode="constant"`` a corner outside the image contributes 0, with
``mode="nearest"`` its index is clamped. The bilinear upsampling of the
non-rigid control grid gathers through one-hot matrices (exact products by
1.0), so that its gradient is a matrix product too. The parameters live in
an `nn.ParameterDict`, trained by torch autograd and `torch.optim.Adam(lr)`;
the epoch losses stay in a device tensor, read once after the loop.
`get_params` returns the JAX package's keys (``theta``, or ``disp_y`` and
``disp_x``) as numpy arrays, so either package's `transform` takes the
other's parameters.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from ..configuration import SKM
from ..core.anndata import AnnData
from ..errors import SegmentationError
from ..logging import logger_manager as lm
from ..ops.image import conv2d, scale_to_01


def _linear_nodes(coordinate: torch.Tensor):
    """The two (index, weight) nodes of each coordinate, as
    `jax.scipy.ndimage`'s `_linear_indices_and_weights` gives them."""
    lower = torch.floor(coordinate)
    upper_weight = coordinate - lower
    index = lower.to(torch.int64)
    return [(index, 1 - upper_weight), (index + 1, upper_weight)]


def _map_coordinates_constant(image: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(image, [iy, ix], order=1, mode="constant", cval=0)``
    for coordinate arrays of one shape. Differentiable in `iy` and `ix`."""
    H, W = image.shape
    out = None
    for yi, wy in _linear_nodes(iy):
        for xi, wx in _linear_nodes(ix):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            corner = image[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
            term = (wy * wx) * torch.where(valid, corner, torch.zeros((), dtype=image.dtype, device=image.device))
            out = term if out is None else out + term
    return out


def _jax_linspace(stop: int, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0, stop, num)`` in float32: ``stop * (i / (num - 1))``
    with the last entry exactly `stop`."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    return torch.cat([float(stop) * step, torch.full((1,), float(stop), dtype=torch.float32, device=device)])


def _affine_warp(image: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Warp `image` with a 2x3 affine in normalized [-1, 1] coordinates
    (torch `affine_grid`/`grid_sample` semantics, align_corners=False):
    theta maps each output pixel's (x, y) to its input position."""
    H, W = image.shape
    dev = image.device
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H * 2 - 1
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    sx = theta[0, 0] * gx + theta[0, 1] * gy + theta[0, 2]
    sy = theta[1, 0] * gx + theta[1, 1] * gy + theta[1, 2]
    iy = (sy + 1) / 2 * H - 0.5
    ix = (sx + 1) / 2 * W - 0.5
    return _map_coordinates_constant(image, iy, ix)


def _displacement_warp(image: torch.Tensor, disp_y: torch.Tensor, disp_x: torch.Tensor) -> torch.Tensor:
    """Warp by a dense (H, W) displacement field in normalized units."""
    H, W = image.shape
    dev = image.device
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev), torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    iy = gy + disp_y * H / 2
    ix = gx + disp_x * W / 2
    return _map_coordinates_constant(image, iy, ix)


def _upsample_bilinear(grid: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear upsample an (h, w) control grid to (H, W): ``map_coordinates(
    grid, meshgrid(linspace(0, h - 1, H), linspace(0, w - 1, W)), order=1,
    mode="nearest")``. Each corner's values are ``Py @ grid @ Px^T`` with
    one-hot row selections (exact), times the product of its two weights."""
    h, w = grid.shape
    dev = grid.device
    iy, ix = _jax_linspace(h - 1, H, dev), _jax_linspace(w - 1, W, dev)
    out = None
    for yi, wy in _linear_nodes(iy):
        Py = torch.nn.functional.one_hot(yi.clamp(0, h - 1), h).to(grid.dtype)
        for xi, wx in _linear_nodes(ix):
            Px = torch.nn.functional.one_hot(xi.clamp(0, w - 1), w).to(grid.dtype)
            term = (wy[:, None] * wx[None, :]) * (Py @ grid @ Px.T)
            out = term if out is None else out + term
    return out


class AlignmentRefiner:
    """Base: optimize warp parameters to map `to_align` onto `reference`,
    both scaled to [0, 1] on `device`."""

    def __init__(self, reference: np.ndarray, to_align: np.ndarray, device="cuda"):
        self.device = device
        self.reference = scale_to_01(reference, device)
        self.to_align = scale_to_01(to_align, device)
        self.params = nn.ParameterDict({k: nn.Parameter(v) for k, v in self._init_params().items()})
        self.losses: List[float] = []

    def _init_params(self) -> dict:
        raise NotImplementedError

    def _warp(self, image: torch.Tensor, params) -> torch.Tensor:
        raise NotImplementedError

    def train(self, n_epochs: int = 100, lr: float = 0.1):
        """`n_epochs` Adam steps on the mean squared difference. The losses
        are kept on the device and reach the host in one copy."""
        opt = torch.optim.Adam(self.params.parameters(), lr=lr)
        losses = torch.empty(n_epochs, dtype=torch.float32, device=self.reference.device)
        for epoch in range(n_epochs):
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((self._warp(self.to_align, self.params) - self.reference) ** 2)
            loss.backward()
            opt.step()
            losses[epoch] = loss.detach()
        self.losses.extend(losses.cpu().tolist())

    def get_params(self) -> dict:
        return {k: v.detach().cpu().numpy() for k, v in self.params.items()}


class RigidAlignmentRefiner(AlignmentRefiner):
    """Affine refinement (parity: reference align.py:115)."""

    def __init__(self, reference: np.ndarray, to_align: np.ndarray, theta: Optional[np.ndarray] = None,
                 device="cuda"):
        self._theta0 = theta
        super().__init__(reference, to_align, device=device)

    def _init_params(self) -> dict:
        theta = self._theta0 if self._theta0 is not None else np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
        return {"theta": torch.as_tensor(np.array(theta, np.float32), device=self.device)}

    def _warp(self, image, params):
        return _affine_warp(image, params["theta"])

    @staticmethod
    def transform(x, params, train: bool = False, device="cuda") -> np.ndarray:
        theta = torch.as_tensor(np.array(params["theta"], np.float32), device=device)
        image = torch.as_tensor(np.array(x, np.float32), device=device)
        return _affine_warp(image, theta).cpu().numpy()


class NonRigidAlignmentRefiner(AlignmentRefiner):
    """Control-mesh displacement refinement (parity: reference align.py:68)."""

    def __init__(self, reference: np.ndarray, to_align: np.ndarray, binsize: Optional[int] = None,
                 meshsize: Optional[int] = None, device="cuda"):
        self._binsize = binsize or meshsize or 1000
        self._shape = reference.shape
        super().__init__(reference, to_align, device=device)

    def _init_params(self) -> dict:
        H, W = self._shape
        h = max(2, int(np.ceil(H / self._binsize)) + 1)
        w = max(2, int(np.ceil(W / self._binsize)) + 1)
        return {k: torch.zeros((h, w), dtype=torch.float32, device=self.device) for k in ("disp_y", "disp_x")}

    def _warp(self, image, params):
        H, W = image.shape
        dy = _upsample_bilinear(params["disp_y"], H, W)
        dx = _upsample_bilinear(params["disp_x"], H, W)
        return _displacement_warp(image, dy, dx)

    @staticmethod
    def transform(x, params, train: bool = False, device="cuda") -> np.ndarray:
        image = torch.as_tensor(np.array(x, np.float32), device=device)
        H, W = image.shape
        dy = _upsample_bilinear(torch.as_tensor(np.array(params["disp_y"], np.float32), device=device), H, W)
        dx = _upsample_bilinear(torch.as_tensor(np.array(params["disp_x"], np.float32), device=device), H, W)
        return _displacement_warp(image, dy, dx).cpu().numpy()


MODULES = {"rigid": RigidAlignmentRefiner, "non-rigid": NonRigidAlignmentRefiner}


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def refine_alignment(
    adata: AnnData,
    stain_layer: str = SKM.STAIN_LAYER_KEY,
    rna_layer: str = SKM.UNSPLICED_LAYER_KEY,
    mode: str = "rigid",
    downscale: float = 1,
    k: int = 5,
    n_epochs: int = 100,
    transform_layers: Optional[Union[str, List[str]]] = None,
    device="cuda",
    **kwargs,
):
    """Refine stain <-> RNA registration on `device` (parity: reference
    align.py:159). The parameters go to
    ``.uns["spatial"][SKM.UNS_SPATIAL_ALIGNMENT_KEY]``; `transform_layers`
    are warped with them."""
    if mode not in MODULES:
        raise SegmentationError('`mode` must be one of "rigid" and "non-rigid"')
    if adata.shape[0] * downscale > 10000 or adata.shape[1] * downscale > 10000:
        lm.main_warning("Input has dimension > 10000. Consider downscaling using the `downscale` option.")

    stain = np.asarray(SKM.select_layer_data(adata, stain_layer, make_dense=True), dtype=float)
    rna = np.asarray(SKM.select_layer_data(adata, rna_layer, make_dense=True), dtype=float)
    if k > 1 and rna.dtype != np.dtype(bool):
        rna = conv2d(rna, k, mode="gauss", device=device).cpu().numpy()
    if downscale < 1:
        import cv2

        stain = cv2.resize(stain, (0, 0), fx=downscale, fy=downscale)
        rna = cv2.resize(rna, (0, 0), fx=downscale, fy=downscale)

    lm.main_info(f"Refining alignment in {mode} mode.")
    module = MODULES[mode]
    aligner = module(rna, stain, device=device, **kwargs)
    aligner.train(n_epochs)
    params = aligner.get_params()
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_ALIGNMENT_KEY, params)

    if transform_layers:
        if isinstance(transform_layers, str):
            transform_layers = [transform_layers]
        for layer in transform_layers:
            data = SKM.select_layer_data(adata, layer, make_dense=True)
            transformed = module.transform(data, params, device=device)
            if np.asarray(data).dtype == np.dtype(bool):
                transformed = transformed > 0.5
            SKM.set_layer_data(adata, layer, transformed.astype(np.asarray(data).dtype))
