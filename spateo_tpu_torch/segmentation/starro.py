"""Starro EM+BP segmentation on the card.

Counterpart of `spateo_tpu.segmentation.starro`. One tile runs these steps,
all on the tile's device: density convolution -> Otsu initial NB parameters
-> Gumbel top-k weighted downsample -> NB-mixture EM -> per-pixel NB
conditionals -> loopy BP (the hand-written CUDA kernel for the standard
4-neighbourhood on a CUDA tensor) -> Otsu threshold -> close/open morphology.

Differences from the JAX package, by design:

- PyTorch runs eagerly, so the "fused program" is the same composition run
  op by op; the tile's state stays on the device between steps.
- The downsample's uniforms come from a `torch.Generator` seeded by `seed` on
  the tile's device (a different stream from `jax.random`), or from the
  caller through `uniform`. The top-k is exact `torch.topk`, as XLA's CPU
  lowering of `approx_max_k` is.
- The stream's raster uploads as int16 when it holds integers that fit,
  else float32. The JAX package's lossless upload codec (`encode_tile`,
  `upload_tile`) is here too, decoded by torch ops on the target device. On
  the card's A/B (PERF.md) the codec lost on dense rasters (its host
  encoding costs more than the copy it saves) and won on sparse ones (it
  never densifies), so the stream sends a scipy sparse tile that the codec
  would send as COO through the codec, and every other tile as the narrowed
  raster. With ``mask_only=True`` the mask is bit-packed on the device
  (`ops.bits.packbits`, the bytes of `jnp.packbits`) and unpacked on the
  host, as there.
- The stream is the JAX package's four-stage pipeline: while the card
  computes tile i, a worker thread stages tile i+2 on the host (the route
  above, into a reused page-locked buffer), tile i+1 goes to the card on a
  side stream and tile i-1's packed mask comes back on a second one; each
  tile is yielded once the next one has been computed. PyTorch dispatches
  eagerly and the EM and BP loops read the card, so the card keeps up with
  the host and idles between launches: both copies are enqueued once the
  tile's first block of BP iterations is, when the card has the most work
  queued.
- One path runs every tile: `starro_em_bp` is a stream of one tile, and
  `starro_em_bp_stream(em_batch=n)` fits up to n consecutive same-shape
  tiles' NB mixtures in one batched EM, each tile frozen at its own
  convergence; the fit sums each tile's samples on their own
  (`_nbn_em_batched(rowwise=True)`), so every tile gets exactly what a
  per-tile call gives.
- `starro_em_bp_sharded` splits one raster's rows over the ranks of a
  `torch.distributed` mesh, each rank launching `bp_step` on its rows.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.bridge import _to_device, _torch_dtype
from ..ops.bits import packbits
from ..ops.bp import _bp_kernel, _use_cuda_bp, create_neighbor_offsets
from ..ops.bp_cuda import bp_kernel
from ..ops.em import _nbn_em_batched, nb_logpmf
from ..ops.image import _binary_row_runs, _conv2d_rowsum, _reflect_pad, circle, dilate, erode
from ..ops.threshold import _otsu_from_values


def _starro_density_init_sample(
    X: torch.Tensor,  # [H, W] raw UMI raster
    k: int,
    n_samples: int,
    seed: int = 0,
    uniform: Optional[torch.Tensor] = None,
):
    """Steps 1-3: density convolution, Otsu initial NB parameters, Gumbel
    top-k weighted downsample. Returns (density [H, W], sample [n_samples],
    w0 [2], mu0 [2], var0 [2], sample indices [n_samples]), all on X's device.

    `uniform` ([H*W] in [1e-12, 1)) replaces the draws made from `seed`."""
    X = X.to(torch.float32)
    dev = X.device

    # 1. density: circular convolution with symmetric padding; exact for
    # integer counts through the prefix-sum row windows
    r = (k - 1) // 2
    rows = _binary_row_runs(np.asarray(circle(k), np.float32))
    res = _conv2d_rowsum(_reflect_pad(X, r), rows, k, k, "VALID")
    flat = res.ravel()
    n = flat.shape[0]

    # 2. initial NB params from an Otsu split, branch-free
    thr = torch.clamp_min(_otsu_from_values(flat, flat.min(), flat.max(), 256), 1.0)
    m = flat > thr
    n_fg = torch.sum(m)
    n_bg = n - n_fg
    w0 = torch.stack([n_bg, n_fg]).to(torch.float32) / n
    sum_all = torch.sum(flat)
    sum_fg = torch.sum(torch.where(m, flat, 0.0))
    mu_bg = (sum_all - sum_fg) / torch.clamp_min(n_bg, 1)
    mu_fg = torch.where(n_fg > 0, sum_fg / torch.clamp_min(n_fg, 1), thr * 2.0)
    sq_all = torch.sum(flat * flat)
    sq_fg = torch.sum(torch.where(m, flat * flat, 0.0))
    var_bg = (sq_all - sq_fg) / torch.clamp_min(n_bg, 1) - mu_bg**2
    var_fg = torch.where(n_fg > 0, sq_fg / torch.clamp_min(n_fg, 1) - mu_fg**2, thr * 4.0)
    mu0 = torch.stack([mu_bg, mu_fg])
    var0 = torch.stack([var_bg, var_fg])
    var0 = torch.where(var0 <= mu0, mu0 * 1.1, var0)  # NB needs var > mu

    # 3. weighted downsample without replacement: Gumbel top-k over the
    # log-weights log(log1p(x + 1)), the distribution of
    # np.random.choice(p=w, replace=False)
    if uniform is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        uniform = torch.clamp_min(torch.rand(n, generator=gen, device=dev) * (1.0 - 1e-12) + 1e-12, 1e-12)
    logw = torch.log(torch.log1p(flat + 1.0) + 1e-30)
    gumbel = -torch.log(-torch.log(uniform.to(device=dev, dtype=torch.float32)))
    idx = torch.topk(logw + gumbel, n_samples).indices
    samp = flat[idx]
    return res, samp, w0, mu0, var0, idx


def _starro_score_mask(
    res: torch.Tensor,  # [H, W] density raster (step-1 output)
    w_,  # [2] fitted mixture weights (tensor or numpy)
    r_,  # [2] fitted NB r
    p_,  # [2] fitted NB theta
    mk: int,
    offsets: Tuple[Tuple[int, int], ...],
    bp_p: float,
    bp_q: float,
    bp_precision: float,
    bp_max_iter: int,
    use_cuda_bp: bool = False,
    bp_msg_dtype: str = "float32",
    bp_check_every: int = 10,
    pack_mask: bool = False,
):
    """Steps 5-7: per-pixel NB conditionals, loopy-BP marginals, Otsu
    threshold and close/open morphology. Returns (scores, mask) on res's
    device, the mask bit-packed (`ops.bits.packbits`) with `pack_mask`. The
    NB mixture may come as numpy arrays, e.g. fitted by the JAX package.

    ``use_cuda_bp`` selects the fused 4-neighbour iteration (`bp_kernel`,
    delta checked every `bp_check_every` iterations, messages stored in
    `bp_msg_dtype`):
    the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor.
    Otherwise the generic `_bp_kernel` runs."""
    del w_  # the conditional stack is normalised, so the weights cancel
    return _starro_bp_mask(_starro_conditionals(res, r_, p_), mk, offsets, bp_p, bp_q, bp_precision, bp_max_iter,
                           use_cuda_bp, bp_msg_dtype, bp_check_every, pack_mask)


def _starro_bp_mask(phi, mk, offsets, bp_p, bp_q, bp_precision, bp_max_iter, use_cuda_bp, bp_msg_dtype,
                    bp_check_every, pack_mask, queued=None):
    """Steps 6-7 of `_starro_score_mask` on the conditionals `phi`;
    `queued` as `bp_kernel` takes it (called before the generic loop)."""
    # 6. loopy-BP marginals
    if use_cuda_bp:
        scores = bp_kernel(phi, bp_p, bp_q, bp_precision, bp_max_iter, check_every=bp_check_every,
                           msg_dtype=bp_msg_dtype, queued=queued)
    else:
        if queued is not None:
            queued()
        scores = _bp_kernel(phi, offsets, bp_p, bp_q, bp_precision, bp_max_iter)
    mask = _starro_threshold_mask(scores, mk)
    return scores, packbits(mask) if pack_mask else mask


def _starro_conditionals(res: torch.Tensor, r_, p_) -> torch.Tensor:
    """Step 5: the normalised per-pixel NB conditionals phi [H, W, 2]
    (background, cell) for the fitted r and theta (tensors or numpy)."""
    dev = res.device
    r_, p_ = (
        x.to(dev, torch.float32) if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
        for x in (r_, p_)
    )
    bg_cond = torch.exp(nb_logpmf(res, r_[0], p_[0]))
    cell_cond = torch.exp(nb_logpmf(res, r_[1], p_[1]))
    phi = torch.stack([bg_cond, cell_cond], dim=-1)
    return phi / torch.clamp_min(torch.sum(phi, dim=-1, keepdim=True), 1e-30)


def _starro_threshold_mask(scores: torch.Tensor, mk: int) -> torch.Tensor:
    """Step 7: Otsu threshold, then close/open morphology (the
    `apply_threshold` semantics)."""
    sflat = scores.ravel()
    mask = scores >= _otsu_from_values(sflat, sflat.min(), sflat.max(), 256)
    mask = erode(dilate(mask, mk), mk)  # close
    return dilate(erode(mask, mk), mk)  # open


def _starro_em_bp_fused(
    Xs,  # same-shape [H, W] raw UMI rasters, on the device they run on
    k: int,
    mk: int,
    n_samples: int,
    em_max_iter: int,
    em_precision: float,
    offsets: Tuple[Tuple[int, int], ...],
    bp_p: float,
    bp_q: float,
    bp_precision: float,
    bp_max_iter: int,
    use_cuda_bp: bool = False,
    bp_msg_dtype: str = "float32",
    seed: int = 0,
    uniforms=None,
    bp_check_every: int = 10,
    pack_mask: bool = False,
    queued=None,
):
    """The whole pipeline for tiles `Xs`: steps 1-3 per tile, one NB-mixture
    EM for all of them (step 4), steps 5-7 per tile. The EM sums each tile's
    samples on their own (`rowwise`), so a tile's fit is exactly the one it
    gets alone. `uniforms` (one per tile) replaces the draws made from
    `seed`. Yields (scores [H, W] f32, mask [H, W] bool) per tile, on its
    device; with `pack_mask` the mask's bits ([ceil(H W / 8)] uint8).
    `queued`, if given, goes to the first tile's BP (`bp_kernel`): it is
    called once that tile's first block of iterations is enqueued, when the
    card has the most work queued that the host enqueues without waiting."""
    uniforms = [None] * len(Xs) if uniforms is None else uniforms
    steps = [_starro_density_init_sample(X, k, n_samples, seed, u) for X, u in zip(Xs, uniforms)]

    # 4. NB-mixture EM on the samples, one row a tile
    w_, r_, p_ = _nbn_em_batched(
        torch.stack([s[1] for s in steps]),
        torch.ones((len(steps), n_samples), dtype=torch.bool, device=steps[0][1].device),
        *(torch.stack([s[i] for s in steps]) for i in (2, 3, 4)),
        max_iter=em_max_iter,
        precision=em_precision,
        rowwise=True,
    )
    for j, s in enumerate(steps):
        yield _starro_bp_mask(_starro_conditionals(s[0], r_[j], p_[j]), mk, offsets, bp_p, bp_q, bp_precision,
                              bp_max_iter, use_cuda_bp, bp_msg_dtype, bp_check_every, pack_mask,
                              queued if j == 0 else None)


class _HostBuffers:
    """Host staging buffers reused from tile to tile, page-locked when the
    tiles go to a card (so that their copies run asynchronously). `take`
    hands out a buffer of at least n bytes, the smallest free one that fits;
    `give` takes one back with the event of the last copy that reads or
    writes it, and the buffer is handed out again only once that event has
    completed. The stream's worker and its main thread share it, hence the
    lock."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self._free = []  # (uint8 tensor, event or None)
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            fits = [i for i, (buf, _) in enumerate(self._free) if buf.numel() >= nbytes]
            buf, event = self._free.pop(min(fits, key=lambda i: self._free[i][0].numel())) if fits else (None, None)
        if buf is None:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pinned)
        if event is not None:
            event.synchronize()
        return buf

    def give(self, buf: torch.Tensor, event=None):
        with self._lock:
            self._free.append((buf, event))


def _stage(X, buffers: _HostBuffers):
    """The host half of a tile's upload, written into a buffer from
    `buffers`: a scipy sparse raster that `encode_tile` sends as COO as its
    flat indices (int32) and values, anything else dense, as int16 when it
    holds integers in [-32767, 32767] (exact, half the bytes of f32), else
    float32. Returns (kind "coo" or "dense", buffer, parts, shape), a part
    (byte offset, numpy dtype, number of values) for each array in the
    buffer, at offsets aligned to 8 bytes."""
    from scipy import sparse as _sp

    if _sp.issparse(X):
        enc = encode_tile(X)
        if enc[0] == "coo":
            _, idx, val, shape = enc
            return ("coo", *_write(buffers, [(idx, np.int32), (val, np.int16 if val.dtype == np.uint16 else val.dtype)]),
                    shape)
        X = X.toarray()
    X = np.asarray(X)
    # the range in two passes and integrality in one comparison (a byte a
    # pixel), no float temporaries: this runs on the stream's worker, beside
    # the main thread's launches
    if X.size and (np.issubdtype(X.dtype, np.integer) or np.issubdtype(X.dtype, np.floating)) \
            and -32767 < X.min() and X.max() < 32767:  # NaN fails both
        buf, parts = _write(buffers, [(X, np.int16)])
        if np.issubdtype(X.dtype, np.integer) or np.array_equal(buf.numpy()[: 2 * X.size].view(np.int16), X.ravel()):
            return ("dense", buf, parts, X.shape)
        buffers.give(buf)  # non-integral values
    return ("dense", *_write(buffers, [(X, np.float32)]), X.shape)


def _write(buffers: _HostBuffers, arrays):
    """Each (array, numpy dtype) of `arrays` cast into one buffer from
    `buffers`; returns (buffer, parts) as `_stage` describes them."""
    parts, end = [], 0
    for a, dt in arrays:
        dt = np.dtype(dt)
        parts.append((end, dt, a.size))
        end += -(-a.size * dt.itemsize // 8) * 8
    buf = buffers.take(end)
    host = buf.numpy()
    for (off, dt, n), (a, _) in zip(parts, arrays):
        np.copyto(host[off : off + n * dt.itemsize].view(dt).reshape(a.shape), a, casting="unsafe")
    return buf, parts


def _send(staged, device: torch.device, stream, buffers: _HostBuffers):
    """Enqueue the copy of a staged tile's bytes to `device` on `stream` (the
    current stream when None), and give its buffer back to `buffers` with
    the copy's event. Returns (device bytes, event); to the CPU, a copy of
    the bytes and no event."""
    _, buf, parts, _ = staged
    off, dt, n = parts[-1]
    host = buf[: off + n * dt.itemsize]
    if device.type != "cuda":
        data = host.clone()
        buffers.give(buf)
        return data, None
    with torch.cuda.stream(stream):
        data = torch.empty(host.numel(), dtype=torch.uint8, device=device)
        data.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    buffers.give(buf, event)
    return data, event


def _land(staged, sent) -> torch.Tensor:
    """The raster of a sent tile on the current stream: the stream waits for
    the copy's event (and keeps the bytes from reuse until it is done with
    them), then decodes a COO tile."""
    kind, _, parts, (H, W) = staged
    data, event = sent
    if event is not None:
        current = torch.cuda.current_stream(data.device)
        current.wait_event(event)
        data.record_stream(current)
    views = [data[off : off + n * dt.itemsize].view(_torch_dtype(dt)) for off, dt, n in parts]
    if kind == "dense":
        return views[0].reshape(int(H), int(W))
    return _decode_coo(views[0].long(), views[1], int(H), int(W))


def _upload(X, device) -> torch.Tensor:
    """The raster on `device` by the stream's route (`_stage`), copied on the
    current stream."""
    device = torch.device(device)
    buffers = _HostBuffers(pinned=device.type == "cuda")
    staged = _stage(X, buffers)
    return _land(staged, _send(staged, device, None, buffers))


def _narrow_upload(X: np.ndarray) -> np.ndarray:
    """Lossless narrow dtype of a raster: int8 when its counts fit, else
    int16; float rasters holding non-integral values unchanged."""
    if np.issubdtype(X.dtype, np.floating) and X.size and float(np.abs(X).max()) < 32767 and np.all(X == np.round(X)):
        amax = float(np.abs(X).max())
        return X.astype(np.int8 if amax < 127 else np.int16)
    if np.issubdtype(X.dtype, np.integer) and (X.size == 0 or np.abs(X).max() < 32767):
        amax = float(np.abs(X).max()) if X.size else 0.0
        return X.astype(np.int8 if amax < 127 else np.int16)
    return X


# --- lossless tile upload codec ---------------------------------------------
#
# UMI rasters compress losslessly; `encode_tile` picks the smallest of:
#   * 'packed2': counts clipped to 2 bits, four pixels a byte; crumb 3 is an
#     escape whose true value (clipped to u8) follows in a side stream in
#     raster order, found on the device by a prefix sum over the escape
#     flags, plus a COO list for values > 255: ~0.25 + P(>=3) bytes/px.
#   * 'packed4': counts clipped to 4 bits, two pixels a byte, plus a COO
#     list of the pixels > 15: ~0.5 bytes/px.
#   * 'coo': a flat uint32 index and a narrow value a nonzero pixel (sparse
#     tiles).
#   * 'dense': the narrow dense raster (always correct).
# The matching decoder rebuilds the exact int16 raster on the device. The
# exception and COO lists are padded to power-of-two lengths with entries
# that repeat a real assignment, so a scatter without accumulation is
# unchanged by them.


def _pad_bucket(idx: np.ndarray, val: np.ndarray, fill_idx: int, fill_val: int):
    """Pad (idx, val) to the next power-of-two length (at least 16) with an
    idempotent entry."""
    n = len(idx)
    if n == 0:
        cap = 1
    else:
        cap = 1 << (max(int(n) - 1, 0)).bit_length()
        cap = max(cap, 16)
    pad = cap - n
    if pad:
        idx = np.concatenate([idx, np.full(pad, fill_idx, idx.dtype)])
        val = np.concatenate([val, np.full(pad, fill_val, val.dtype)])
    return idx, val


def encode_tile(X) -> tuple:
    """The cheapest lossless upload encoding of a UMI tile (host numpy).

    Accepts a dense array or a scipy sparse matrix (never densified when
    COO wins). Returns one of:
      ('dense',   X_narrow, shape)
      ('packed4', packed_u8, exc_idx_u32, exc_val, shape)
      ('packed2', packed_u8, esc_val_u8, exc_idx_u32, exc_val_i16, shape)
      ('coo',     idx_u32, val, shape)
    """
    from scipy import sparse as sp

    if sp.issparse(X):
        coo = X.tocoo(copy=True)  # copy: sum_duplicates mutates in place
        coo.sum_duplicates()  # the decoder SETs a pixel; scipy SUMS duplicates
        shape = coo.shape
        size = shape[0] * shape[1]
        vmax = float(coo.data.max()) if coo.nnz else 0.0
        vmin = float(coo.data.min()) if coo.nnz else 0.0
        integral = np.all(coo.data == np.round(coo.data)) if coo.nnz else True
        # the decoded raster is int16: negatives and counts > 32766 would wrap
        if integral and vmin >= 0 and vmax <= 32766:
            vdt = np.uint8 if vmax < 256 else np.uint16
            idx = (coo.row.astype(np.int64) * shape[1] + coo.col.astype(np.int64)).astype(np.uint32)
            val = coo.data.astype(vdt)
            coo_bytes = _pad_bucket(idx, val, 0, 0)[0].nbytes + val.nbytes
            if coo_bytes < size + size // 2:  # beats dense and likely packed4
                idx, val = _pad_bucket(idx, val, int(idx[0]) if len(idx) else 0, int(val[0]) if len(val) else 0)
                return ("coo", idx, val, shape)
        X = np.asarray(X.todense())

    X = np.asarray(X)
    shape = X.shape
    size = X.size
    if size == 0:
        return ("dense", _narrow_upload(X), shape)
    if np.issubdtype(X.dtype, np.floating):
        flat = X.ravel().astype(np.int16)
        if not np.array_equal(flat, X.ravel()):  # non-integral or overflow
            return ("dense", X, shape)
    elif np.issubdtype(X.dtype, np.integer):
        flat = X.ravel()
        if flat.min() < 0 or flat.max() > 32766:
            return ("dense", _narrow_upload(X), shape)
        flat = flat.astype(np.int16, copy=False)
    else:
        return ("dense", X, shape)
    if flat.min() < 0:
        return ("dense", _narrow_upload(X), shape)

    vmax = int(flat.max())
    nnz = int(np.count_nonzero(flat))
    n_exc = int(np.count_nonzero(flat > 15))
    vdt = np.uint8 if vmax < 256 else np.uint16
    vsize = np.dtype(vdt).itemsize

    dense_bytes = size * (1 if vmax < 127 else 2)
    coo_bytes = nnz * (4 + vsize)
    pack_bytes = (size + 1) // 2 + n_exc * (4 + vsize)
    n_esc = int(np.count_nonzero(flat >= 3))
    n_exc2 = int(np.count_nonzero(flat > 255))
    pack2_bytes = (size + 3) // 4 + n_esc + n_exc2 * 6

    best = min(dense_bytes, coo_bytes, pack_bytes, pack2_bytes)
    if best == dense_bytes:
        return ("dense", flat.astype(np.int8 if vmax < 127 else np.int16, copy=False).reshape(shape), shape)
    if best == coo_bytes:
        nnz_idx = np.flatnonzero(flat).astype(np.uint32)
        coo_val = flat[nnz_idx.astype(np.int64)].astype(vdt)
        idx, val = _pad_bucket(nnz_idx, coo_val, int(nnz_idx[0]) if len(nnz_idx) else 0,
                               int(coo_val[0]) if len(coo_val) else 0)
        return ("coo", idx, val, shape)
    if best == pack2_bytes:
        base = np.minimum(flat, 3).astype(np.uint8)
        pad = (-size) % 4
        if pad:
            base = np.concatenate([base, np.zeros(pad, np.uint8)])
        packed = base[0::4] | (base[1::4] << 2) | (base[2::4] << 4) | (base[3::4] << 6)
        # escape stream: the true values (clipped to u8) of every pixel >= 3
        # in raster order; zero padding is never gathered
        esc_val = np.minimum(flat[flat >= 3], 255).astype(np.uint8)
        cap = max(16, 1 << (max(len(esc_val) - 1, 0)).bit_length()) if len(esc_val) else 16
        if cap > len(esc_val):
            esc_val = np.concatenate([esc_val, np.zeros(cap - len(esc_val), np.uint8)])
        exc2_idx = np.flatnonzero(flat > 255).astype(np.uint32)
        exc2_val = flat[exc2_idx.astype(np.int64)].astype(np.int16)
        # idempotent padding: pixel 0 set to its own value, or a real
        # exception repeated
        if len(exc2_idx):
            exc2_idx, exc2_val = _pad_bucket(exc2_idx, exc2_val, int(exc2_idx[0]), int(exc2_val[0]))
        else:
            exc2_idx, exc2_val = _pad_bucket(exc2_idx, exc2_val, 0, int(flat[0]))
        return ("packed2", packed, esc_val, exc2_idx, exc2_val, shape)
    exc_idx = np.flatnonzero(flat > 15).astype(np.uint32)
    exc_val = flat[exc_idx.astype(np.int64)].astype(vdt)
    base = np.minimum(flat, 15).astype(np.uint8)
    if size % 2:
        base = np.concatenate([base, np.zeros(1, np.uint8)])
    packed = base[0::2] | (base[1::2] << 4)
    if len(exc_idx):
        exc_idx, exc_val = _pad_bucket(exc_idx, exc_val, int(exc_idx[0]), int(exc_val[0]))
    else:
        # no exceptions: pixel 0 set to its clipped value
        fill_val = int(min(int(flat[0]), 15)) if size else 0
        exc_idx, exc_val = _pad_bucket(exc_idx, exc_val, 0, fill_val)
    return ("packed4", packed, exc_idx, exc_val, shape)


def _codec_array(a: np.ndarray, device) -> torch.Tensor:
    """A codec stream on `device` through pinned memory: uint32 indices as
    int64, uint16 values (<= 32766) as int16, narrowed as `jnp.asarray`
    narrows with x64 off (float64 -> float32, int64 -> int32)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return _to_device(a.view(np.int32), device).long()
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return _to_device(a, device)


def _decode_packed4(packed, exc_idx, exc_val, H: int, W: int) -> torch.Tensor:
    lo = (packed & 15).to(torch.int16)
    hi = (packed >> 4).to(torch.int16)
    flat = torch.stack([lo, hi], dim=1).reshape(-1)[: H * W]
    flat.index_put_((exc_idx,), exc_val.to(torch.int16))
    return flat.reshape(H, W)


def _decode_coo(idx, val, H: int, W: int) -> torch.Tensor:
    flat = torch.zeros(H * W, dtype=torch.int16, device=idx.device)
    flat.index_put_((idx,), val.to(torch.int16))
    return flat.reshape(H, W)


def _decode_packed2(packed, esc_val, exc_idx, exc_val, H: int, W: int) -> torch.Tensor:
    """The 2-bit plane and the escape stream: crumb 3 marks an escape, and
    the k-th escape in raster order reads ``esc_val[k]``, k from a prefix sum
    over the escape flags."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=packed.device)
    crumbs = (packed[:, None] >> shifts[None, :]) & 3
    flat = crumbs.reshape(-1)[: H * W].to(torch.int16)
    esc = flat == 3
    pos = torch.cumsum(esc.to(torch.int32), 0) - 1
    gathered = esc_val[torch.clamp(pos, 0, esc_val.shape[0] - 1)].to(torch.int16)
    flat = torch.where(esc, gathered, flat)
    flat.index_put_((exc_idx,), exc_val.to(torch.int16))
    return flat.reshape(H, W)


def _upload_encoded(enc, device) -> torch.Tensor:
    """An `encode_tile` result copied to `device` and decoded there."""
    kind, *arrays, (H, W) = enc
    t = [_codec_array(a, device) for a in arrays]
    if kind == "dense":
        return t[0]
    decode = {"coo": _decode_coo, "packed2": _decode_packed2, "packed4": _decode_packed4}[kind]
    return decode(*t, int(H), int(W))


def upload_tile(X, device="cuda") -> torch.Tensor:
    """A tile uploaded with the cheapest lossless encoding (`encode_tile`)
    and decoded on `device`: the int16 raster (the dense encoding keeps its
    narrow dtype)."""
    return _upload_encoded(encode_tile(X), device)


def _n_samples(size: int, downsample: float) -> int:
    # a floor of 1000 samples: the fractional downsample degenerates on small
    # rasters (unstable NB fits); at >= 1 Mpixel the floor is inactive
    n = max(int(size * downsample), 1000) if downsample <= 1 else int(downsample)
    return min(n, size)


def _offsets(bp_k: int, bp_square: bool):
    neighborhood = np.ones((bp_k, bp_k)) if bp_square else circle(bp_k)
    return tuple(map(tuple, create_neighbor_offsets(neighborhood.astype(bool)).tolist()))


def starro_em_bp(
    X: np.ndarray,
    k: int = 5,
    mk: Optional[int] = None,
    downsample: float = 0.001,
    em_max_iter: int = 2000,
    em_precision: float = 1e-6,
    bp_k: int = 3,
    bp_square: bool = False,
    bp_p: float = 0.6,
    bp_q: float = 0.4,
    bp_precision: float = 1e-6,
    bp_max_iter: int = 100,
    bp_msg_dtype: str = "bfloat16",
    seed: Optional[int] = None,
    mask_only: bool = False,
    device="cuda",
):
    """Starro EM+BP scoring and masking of one raster on `device`; returns
    (scores, mask).

    The counterpart of `spateo_tpu.segmentation.starro.starro_em_bp`: the
    same defaults, BP messages stored in bf16 with f32 arithmetic. `scores`
    is an [H, W] f32 tensor on `device`; `mask` an [H, W] bool tensor there,
    or with ``mask_only=True`` a host numpy array. `X` may be dense or a
    scipy sparse matrix. It is a stream of one tile."""
    return next(starro_em_bp_stream(
        [X], k, mk, downsample, em_max_iter, em_precision, bp_k, bp_square, bp_p, bp_q, bp_precision, bp_max_iter,
        bp_msg_dtype, seed, mask_only, device=device,
    ))


def starro_em_bp_stream(
    tiles,
    k: int = 5,
    mk: Optional[int] = None,
    downsample: float = 0.001,
    em_max_iter: int = 2000,
    em_precision: float = 1e-6,
    bp_k: int = 3,
    bp_square: bool = False,
    bp_p: float = 0.6,
    bp_q: float = 0.4,
    bp_precision: float = 1e-6,
    bp_max_iter: int = 100,
    bp_msg_dtype: str = "bfloat16",
    seed: Optional[int] = None,
    mask_only: bool = False,
    em_batch: int = 1,
    device="cuda",
):
    """Starro over a stream of rasters (tiles, fields of view): yields
    ``(scores, mask)`` per tile, identical to calling `starro_em_bp` on each
    with the same arguments (every tile uses the same `seed`).

    Up to `em_batch` consecutive same-shape tiles make a chunk that shares
    one batched NB-mixture EM (the launch-bound stage); each then gets its
    own conditionals, BP and mask. Around the chunks runs the JAX package's
    four-stage pipeline:

    - a one-thread worker stages each tile on the host as soon as it is
      pulled from `tiles` (`_stage`, into a reused buffer of
      `_HostBuffers`);
    - while a chunk computes, the tile pulled after it is copied to the card
      on a side stream (`_send`); the compute stream waits for a copy's
      event where it first uses the tile (`_land`);
    - with ``mask_only=True`` each mask is bit-packed on the card, and the
      previous chunk's masks are copied back on a second side stream that
      waits for each mask's event;
    - a chunk is yielded only after the next one has been computed; then
      the host waits for each mask's copy and unpacks it.

    PyTorch dispatches eagerly and the EM and BP loops read the card, so the
    card keeps up with the host and idles between its launches: a copy
    enqueued at an arbitrary point runs in such a gap. Both copies are
    therefore enqueued once the chunk's first block of BP iterations is
    (`queued` of `_starro_em_bp_fused`), when the card has the most work
    queued. Tiles are pulled from `tiles`, and yielded, in the order of the
    JAX package's `starro_em_bp_stream`: with ``em_batch=1`` tile i is
    yielded once tile i+3 has been pulled; with chunks, a chunk is yielded
    once the chunk after the next one has begun to be pulled (or `tiles` has
    ended). On the CPU the worker and that order are the same, with no
    streams. An error on the worker is raised here."""
    from scipy import sparse as _sp

    device = torch.device(device)
    on_card = device.type == "cuda"
    em_batch = max(int(em_batch), 1)
    mk = mk or k + 2
    offsets = _offsets(bp_k, bp_square)
    buffers = _HostBuffers(pinned=on_card)
    h2d = torch.cuda.Stream(device) if on_card else None
    d2h = torch.cuda.Stream(device) if on_card else None
    it = iter(tiles)
    pulled = deque()  # _Tile records pulled from `tiles`, not yet in a chunk
    ended = False
    worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="starro-stream")

    def pull() -> bool:
        nonlocal ended
        X = _END if ended else next(it, _END)
        if X is _END:
            ended = True
            return False
        X = X if _sp.issparse(X) else np.asarray(X)
        pulled.append(_Tile(X.shape, worker.submit(_stage, X, buffers)))
        return True

    def form() -> list:
        """The next chunk: up to `em_batch` same-shape tiles from the head of
        `pulled`, closed (as the JAX package closes it) by a tile pulled
        after it, or by the end of `tiles`."""
        while True:
            n = 0
            while n < min(len(pulled), em_batch) and pulled[n].shape == pulled[0].shape:
                n += 1
            if len(pulled) > n or not pull():
                return [pulled.popleft() for _ in range(n)]

    def send(tile):
        if tile.sent is None:
            staged = tile.staged.result()
            tile.sent = staged, _send(staged, device, h2d, buffers)

    def copy_back(outs):
        """Enqueue the copies of these tiles' packed masks to host buffers."""
        for out in outs:
            if out.host is None:
                n = out.mask.numel()
                out.host = buffers.take(n)
                if on_card:
                    with torch.cuda.stream(d2h):
                        d2h.wait_event(out.made)
                        out.host[:n].copy_(out.mask, non_blocking=True)
                        out.mask.record_stream(d2h)
                        out.copied = torch.cuda.Event()
                        out.copied.record()
                else:
                    out.host[:n].copy_(out.mask)

    def queued(after, prev):
        if after is not None:
            send(after)
        copy_back(prev)

    def compute(chunk, after, prev):
        """Steps 1-7 of a chunk; `after` (the next tile pulled, or None)
        goes to the card and `prev`'s masks come back while it computes."""
        for tile in chunk:
            send(tile)
        H, W = chunk[0].shape
        Xs = [_land(*tile.sent) for tile in chunk]
        outs = []
        for tile, (scores, mask) in zip(chunk, _starro_em_bp_fused(
            Xs, k, mk, _n_samples(H * W, downsample), int(em_max_iter), float(em_precision), offsets, float(bp_p),
            float(bp_q), float(bp_precision), int(bp_max_iter), _use_cuda_bp(offsets, Xs[0]), str(bp_msg_dtype),
            0 if seed is None else int(seed), pack_mask=bool(mask_only), queued=lambda: queued(after, prev),
        )):
            made = None
            if on_card and mask_only:
                made = torch.cuda.Event()
                made.record()
            outs.append(_Out(tile.shape, scores, mask, made))
        return outs

    def finish(out):
        if not mask_only:
            return out.scores, out.mask
        if out.copied is not None:
            out.copied.synchronize()
        n = out.mask.numel()
        mask = np.unpackbits(out.host[:n].numpy())[: out.shape[0] * out.shape[1]].reshape(out.shape).view(bool)
        buffers.give(out.host)
        return out.scores, mask

    try:
        chunk, prev = form(), []
        while chunk:
            # the JAX package's per-tile pipeline pulls the tile after next
            # before it computes a tile; its chunked one pulls the next chunk
            # only once it has yielded the last
            nxt = form() if em_batch == 1 else None
            after = nxt[0] if nxt else (pulled[0] if pulled else None)
            outs = compute(chunk, after, prev if mask_only else [])
            for out in prev:
                yield finish(out)
            chunk, prev = (nxt if em_batch == 1 else form()), outs
        if mask_only:
            copy_back(prev)
        for out in prev:
            yield finish(out)
    finally:
        worker.shutdown(wait=False, cancel_futures=True)


class _Tile:
    """A tile of the stream: its shape, the future of its staging (`_stage`)
    and, once its copy is enqueued, the staging and `_send`'s result."""

    __slots__ = ("shape", "staged", "sent")

    def __init__(self, shape, staged):
        self.shape, self.staged, self.sent = tuple(shape), staged, None


class _Out:
    """A computed tile of the stream: its scores and mask on the device, the
    event after which the mask is made, and, once its copy back is
    enqueued, the host buffer and the copy's event."""

    __slots__ = ("shape", "scores", "mask", "made", "host", "copied")

    def __init__(self, shape, scores, mask, made):
        self.shape, self.scores, self.mask, self.made = shape, scores, mask, made
        self.host = self.copied = None


_END = object()


#: Keyword arguments of `starro_em_bp_sharded` and their defaults (the JAX
#: package's).
_SHARDED_DEFAULTS = dict(k=5, mk=None, downsample=0.001, bp_k=3, bp_square=False, seed=None, mask_only=False,
                         em_max_iter=2000, em_precision=1e-6, bp_p=0.6, bp_q=0.4, bp_precision=1e-6, bp_max_iter=100)


def starro_em_bp_sharded(X: np.ndarray, mesh=None, mesh_axis: str = "data", **kwargs):
    """Multi-device Starro (counterpart of
    `spateo_tpu.segmentation.starro.starro_em_bp_sharded`, `:756-824`): the
    raster's rows split over the mesh's `mesh_axis` (`config.mesh` when
    `mesh` is None). Every rank calls it with the whole raster and gets the
    whole (scores, mask) as host arrays; `kwargs` are `starro_em_bp`'s.

    Each rank computes its own rows, and one halo row of BP's reach on each
    side, from the host raster:

    - the density convolution with symmetric padding at the raster's edges
      and the neighbours' rows at the cuts (exact for counts);
    - the Otsu initial parameters: the value range by MIN and MAX, the
      256-bin histogram as exact counts summed over ranks, the sums of the
      means and variances as float64 partial sums added in rank order;
    - the Gumbel top-k downsample: each rank draws the whole raster's
      uniforms from `seed` on its device, as `starro_em_bp` does, and keeps
      its rows; its top `n_samples` join every rank's, and a second top-k
      orders them by key, so the NB-mixture EM (replicated, then broadcast
      from rank 0) sees the samples of the unsharded run in its order;
    - the conditionals; loopy BP by `ops.bp._bp_kernel_sharded` (a one-row
      halo exchange of the messages each iteration, f32 messages, the delta
      every iteration, `bp_step` on the card); the Otsu threshold of the
      scores as above; close and open with a halo of ``mk // 2`` rows before
      each erosion and dilation.

    ``mask_only`` is accepted and, as in the JAX package, the mask comes back
    whole. BP's messages are f32 whatever `bp_msg_dtype` says."""
    from scipy import sparse as _sp

    from ..configuration import config
    from ..ops.bp import _bp_kernel_sharded, bp_halo
    from ..ops.threshold import _otsu_from_hist, _otsu_hist
    from ..parallel._collectives import RowShard

    kwargs.pop("bp_msg_dtype", None)
    unknown = set(kwargs) - set(_SHARDED_DEFAULTS)
    if unknown:
        raise TypeError(f"starro_em_bp_sharded: unexpected arguments {sorted(unknown)}")
    o = dict(_SHARDED_DEFAULTS, **kwargs)
    mesh = mesh if mesh is not None else config.mesh
    X = np.asarray(X.toarray() if _sp.issparse(X) else X, np.float32)
    H, W = X.shape
    sh = RowShard(mesh, H, mesh_axis)
    dev = sh.device
    k, mk = int(o["k"]), int(o["mk"] or o["k"] + 2)
    offsets = _offsets(int(o["bp_k"]), bool(o["bp_square"]))
    n, n_own = H * W, sh.rows_local * W
    n_samples = _n_samples(n, float(o["downsample"]))

    # 1. density of this rank's rows and BP's halo rows: the host raster's
    # rows r = (k - 1) // 2 beyond them, mirrored at the raster's edges
    r, depth = (k - 1) // 2, bp_halo(offsets)
    rows = sh.halo_index(depth)[sh.rank]  # this rank's rows and BP's halo, clipped to the raster
    top = sh.lo - int(rows[0]) if len(rows) else 0
    src = np.arange(int(rows[0]) - r, int(rows[-1]) + 1 + r) if len(rows) else np.zeros(0, np.int64)
    src = np.where(src < 0, -src - 1, src)
    src = np.where(src >= H, 2 * H - 1 - src, src)
    Xr = _to_device(np.ascontiguousarray(X[src]), dev)
    if r:
        Xr = torch.cat([Xr[:, :r].flip(-1), Xr, Xr[:, -r:].flip(-1)], dim=-1)
    res_ext = _conv2d_rowsum(Xr, _binary_row_runs(np.asarray(circle(k), np.float32)), k, k, "VALID")
    flat = res_ext[top : top + sh.rows_local].reshape(-1)

    # 2. initial NB parameters from an Otsu split
    inf = torch.tensor(float("inf"), device=dev)
    vmin = sh.min(flat.min() if n_own else inf)
    vmax = sh.max(flat.max() if n_own else -inf)
    (hist,) = sh.sum(_otsu_hist(flat, vmin, vmax, 256))
    thr = torch.clamp_min(_otsu_from_hist(hist, vmin, vmax, 256), 1.0)
    m = flat > thr
    f64 = flat.to(torch.float64)
    parts = torch.stack([m.sum().to(torch.float64), f64.sum(), torch.where(m, f64, 0.0).sum(), (f64 * f64).sum(),
                         torch.where(m, f64 * f64, 0.0).sum()])
    (parts,) = sh.sum(parts)
    n_fg = parts[0].to(torch.int64)
    n_bg = n - n_fg
    sum_all, sum_fg, sq_all, sq_fg = (parts[i].to(torch.float32) for i in (1, 2, 3, 4))
    w0 = torch.stack([n_bg, n_fg]).to(torch.float32) / n
    mu_bg = (sum_all - sum_fg) / torch.clamp_min(n_bg, 1)
    mu_fg = torch.where(n_fg > 0, sum_fg / torch.clamp_min(n_fg, 1), thr * 2.0)
    var_bg = (sq_all - sq_fg) / torch.clamp_min(n_bg, 1) - mu_bg**2
    var_fg = torch.where(n_fg > 0, sq_fg / torch.clamp_min(n_fg, 1) - mu_fg**2, thr * 4.0)
    mu0 = torch.stack([mu_bg, mu_fg])
    var0 = torch.stack([var_bg, var_fg])
    var0 = torch.where(var0 <= mu0, mu0 * 1.1, var0)

    # 3. the Gumbel top-k downsample over every rank's pixels
    gen = torch.Generator(device=dev)
    gen.manual_seed(0 if o["seed"] is None else int(o["seed"]))
    uniform = torch.clamp_min(torch.rand(n, generator=gen, device=dev) * (1.0 - 1e-12) + 1e-12, 1e-12)
    keys = torch.log(torch.log1p(flat + 1.0) + 1e-30) - torch.log(-torch.log(uniform[sh.lo * W : sh.hi * W]))
    top_k = torch.topk(keys, min(n_samples, n_own))
    cand = torch.full((2, n_samples), -float("inf"), dtype=torch.float32, device=dev)
    cand[0, : top_k.values.numel()] = top_k.values
    cand[1, : top_k.values.numel()] = flat[top_k.indices]
    cand = sh.stack(cand)  # [world, 2, n_samples]
    pick = torch.topk(cand[:, 0].reshape(-1), n_samples).indices
    samp = cand[:, 1].reshape(-1)[pick]

    # 4. NB-mixture EM, the same on every rank (broadcast from rank 0)
    w_, r_, p_ = _nbn_em_batched(samp[None], torch.ones((1, n_samples), dtype=torch.bool, device=dev), w0[None],
                                 mu0[None], var0[None], max_iter=int(o["em_max_iter"]),
                                 precision=float(o["em_precision"]), rowwise=True)
    r_, p_ = sh.broadcast(torch.stack([r_[0], p_[0]]))

    # 5-6. conditionals of the rows BP reads, and BP over the ranks
    phi = _starro_conditionals(res_ext, r_, p_)
    scores = _bp_kernel_sharded(phi, top, sh, offsets, float(o["bp_p"]), float(o["bp_q"]),
                                float(o["bp_precision"]), int(o["bp_max_iter"]))

    # 7. Otsu threshold of the scores, then close and open with halo rows
    sflat = scores.reshape(-1)
    smin = sh.min(sflat.min() if n_own else inf)
    smax = sh.max(sflat.max() if n_own else -inf)
    (shist,) = sh.sum(_otsu_hist(sflat, smin, smax, 256))
    mask = scores >= _otsu_from_hist(shist, smin, smax, 256)
    for op in (dilate, erode, erode, dilate):  # close, then open
        ext, t = sh.halo(mask, (mk - 1) // 2)
        mask = op(ext, mk)[t : t + sh.rows_local]
    return sh.gather_rows(scores).numpy(force=True), sh.gather_rows(mask).numpy(force=True)
