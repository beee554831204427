"""The Starro stream's pipeline and its bit-packed mask, the port against the
JAX package on the CPU.

- `ops.bits.packbits` / `unpackbits` equal `np.packbits` and `jnp.packbits`.
- The stream pulls tiles from the caller's iterator, and yields them, in the
  order of the JAX package's `starro_em_bp_stream` (an instrumented iterator
  records how many tiles had been pulled at each yield), for ``em_batch`` 1
  and 2, across a mid-stream shape change.
- Its outputs are bit for bit those of per-tile `starro_em_bp` calls, with a
  COO-sparse tile, for both ``mask_only`` settings.
- An error of the staging worker is raised from the generator; a caller that
  stops after the first tile gets control back and leaves no worker behind.
- `label_cells_from_mask` on a packed mask (host bytes or a tensor) gives the
  JAX package's labels and centroids.

Tiles are 64x96 (72x96 after the shape change), EM 300 iterations, BP 15,
one torch and BLAS thread.
"""

import itertools
import threading
import time
from functools import partial

import numpy as np
import pytest
import torch
from scipy import sparse

import jax
import jax.numpy as jnp

from spateo_tpu.ops import labels as JL
from spateo_tpu.segmentation import starro as JS
from spateo_tpu_torch.ops import bits as TB
from spateo_tpu_torch.ops import labels as TL
from spateo_tpu_torch.segmentation import starro as TS

KW = dict(k=3, seed=0, em_max_iter=300, bp_max_iter=15)
OFFSETS = ((-1, 0), (0, -1), (0, 1), (1, 0))  # circle(3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, and for numpy's BLAS and OpenMP: the
    tier-1 run shares the CPU among its workers."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _tile(shape, seed):
    r = np.random.default_rng(seed)
    X = r.negative_binomial(1, 0.5, shape).astype(np.float32)
    X[10:40, 10:40] += r.negative_binomial(8, 0.35, (30, 30)).astype(np.float32)
    X[45:60, 55:85] += r.negative_binomial(8, 0.35, (15, 30)).astype(np.float32)
    return X


def _sparse_tile(shape, seed):
    """A tile the codec sends as COO: a planted block of counts and 2% of the
    other pixels at 1-3."""
    r = np.random.default_rng(seed)
    X = np.zeros(shape, np.float32)
    X.flat[r.choice(X.size, X.size // 50, replace=False)] = r.integers(1, 4, X.size // 50)
    X[10:40, 10:40] = r.negative_binomial(8, 0.35, (30, 30)) + 1
    return sparse.csr_matrix(X)


def _tiles():
    """Five tiles, the shape changing after the third."""
    return [_tile((64, 96), 0), _sparse_tile((64, 96), 1), _tile((64, 96), 2), _tile((72, 96), 3),
            _tile((72, 96), 4)]


class _Counted:
    """An iterator over `tiles` that counts the tiles pulled from it."""

    def __init__(self, tiles):
        self.pulled = 0
        self._it = iter(tiles)

    def __iter__(self):
        return self

    def __next__(self):
        t = next(self._it)
        self.pulled += 1
        return t


def _pulled_at_yields(stream, tiles, **kw):
    src = _Counted(tiles)
    return [src.pulled for _ in stream(src, **kw)]


# -- the bits -------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 8, 9, 64, 1001, 64 * 96])
def test_packbits_matches_numpy_and_jax(n):
    m = np.random.default_rng(n).random(n) < 0.4
    got = TB.packbits(torch.from_numpy(m))
    assert got.dtype == torch.uint8 and got.shape == ((n + 7) // 8,)
    np.testing.assert_array_equal(got.numpy(), np.packbits(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.packbits(jnp.asarray(m))))
    back = TB.unpackbits(got, n)
    assert back.dtype == torch.bool
    np.testing.assert_array_equal(back.numpy(), m)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jnp.unpackbits(jnp.packbits(jnp.asarray(m)))[:n]))


def test_packbits_of_a_raster_is_row_major():
    m = np.random.default_rng(3).random((13, 21)) < 0.5
    np.testing.assert_array_equal(TB.packbits(torch.from_numpy(m)).numpy(), np.asarray(jnp.packbits(m.ravel())))
    np.testing.assert_array_equal(TB.unpackbits(TB.packbits(torch.from_numpy(m)), m.size).reshape(13, 21).numpy(), m)


def test_fused_packed_mask_against_jax():
    """`_starro_em_bp_fused(pack_mask=True)` with JAX's uniforms: the port's
    bytes are `packbits` of its own bool mask, and unpack to a mask of IoU
    >= 0.999 with the JAX package's packed one (the bar of the unpacked
    masks' test)."""
    X = _tile((96, 128), 0)
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (X.size,), minval=1e-12, maxval=1.0))
    _, bj = JS._starro_em_bp_fused(jnp.asarray(X), key, 3, 5, 1000, 2000, 1e-6, OFFSETS, 0.6, 0.4, 1e-6, 50,
                                   pack_mask=True)
    args = ([torch.from_numpy(X)], 3, 5, 1000, 2000, 1e-6, OFFSETS, 0.6, 0.4, 1e-6, 50)
    ((_, bt),) = TS._starro_em_bp_fused(*args, uniforms=[torch.from_numpy(u)], pack_mask=True)
    ((_, mt),) = TS._starro_em_bp_fused(*args, uniforms=[torch.from_numpy(u)])
    assert bt.dtype == torch.uint8 and bt.shape == (X.size // 8,)
    np.testing.assert_array_equal(bt.numpy(), np.packbits(mt.numpy().ravel()))
    a, b = np.unpackbits(bt.numpy()).astype(bool), np.unpackbits(np.asarray(bj)).astype(bool)
    assert (a & b).sum() / max((a | b).sum(), 1) >= 0.999


# -- the stream's order and outputs -------------------------------------------------------------------------


@pytest.mark.parametrize("em_batch", [1, 2])
def test_stream_pulls_and_yields_in_the_jax_order(em_batch, monkeypatch):
    """The count of tiles pulled at each yield equals the JAX package's, five
    tiles with a shape change after the third (its BP in interpret mode)."""
    from spateo_tpu.ops import bp_pallas

    monkeypatch.setattr(bp_pallas, "bp_kernel_pallas", partial(bp_pallas.bp_kernel_pallas, interpret=True))
    tiles = _tiles()
    want = _pulled_at_yields(JS.starro_em_bp_stream, tiles, em_batch=em_batch, mask_only=True, **KW)
    got = _pulled_at_yields(TS.starro_em_bp_stream, tiles, em_batch=em_batch, mask_only=True, device="cpu", **KW)
    assert got == want
    assert got == ([4, 5, 5, 5, 5] if em_batch == 1 else [4, 4, 5, 5, 5])


@pytest.mark.parametrize("mask_only", [True, False])
@pytest.mark.parametrize("em_batch", [1, 2])
def test_stream_equals_per_tile_calls(em_batch, mask_only):
    """Scores and masks bit for bit those of per-tile `starro_em_bp` calls,
    with a COO-sparse tile and a shape change; the sparse tile goes through
    the codec's COO route."""
    tiles = _tiles()
    assert TS.encode_tile(tiles[1])[0] == "coo" and TS._stage(tiles[1], TS._HostBuffers(False))[0] == "coo"
    out = list(TS.starro_em_bp_stream(tiles, em_batch=em_batch, mask_only=mask_only, device="cpu", **KW))
    assert len(out) == len(tiles)
    for X, (s, m) in zip(tiles, out):
        s_ref, m_ref = TS.starro_em_bp(X, mask_only=mask_only, device="cpu", **KW)
        torch.testing.assert_close(s, s_ref, atol=0, rtol=0)
        if mask_only:
            assert isinstance(m, np.ndarray) and m.dtype == bool and m.shape == X.shape
            np.testing.assert_array_equal(m, m_ref)
        else:
            assert m.dtype == torch.bool and tuple(m.shape) == X.shape and torch.equal(m, m_ref)


def test_stream_reuses_its_staging_buffers(monkeypatch):
    """Six tiles and their six masks take twelve buffers from the stream's
    pool, which makes no more than the lookahead holds at once (a tile being
    staged, its successor's bytes, two masks) and one to spare."""
    taken = []

    class Counted(TS._HostBuffers):
        def take(self, nbytes):
            buf = super().take(nbytes)
            taken.append(buf.data_ptr())
            return buf

    monkeypatch.setattr(TS, "_HostBuffers", Counted)
    list(TS.starro_em_bp_stream([_tile((64, 96), s) for s in range(6)], mask_only=True, device="cpu", **KW))
    assert len(taken) == 12 and len(set(taken)) <= 5


def _stream_threads():
    return [t for t in threading.enumerate() if t.name.startswith("starro-stream")]


def _no_stream_threads(timeout=20.0):
    end = time.monotonic() + timeout
    while _stream_threads() and time.monotonic() < end:
        time.sleep(0.05)
    return not _stream_threads()


def test_worker_error_raises_from_the_stream(monkeypatch):
    """An encode that raises on the staging worker raises from the generator,
    as it does from the JAX package's (whose worker encodes every tile)."""

    def boom(X):
        raise RuntimeError("encode failed")

    tiles = [_tile((64, 96), 0), _sparse_tile((64, 96), 1), _tile((64, 96), 2)]
    monkeypatch.setattr(TS, "encode_tile", boom)
    monkeypatch.setattr(JS, "encode_tile", boom)
    with pytest.raises(RuntimeError, match="encode failed"):
        list(JS.starro_em_bp_stream(tiles, mask_only=True, **KW))
    with pytest.raises(RuntimeError, match="encode failed"):
        list(TS.starro_em_bp_stream(tiles, mask_only=True, device="cpu", **KW))
    assert _no_stream_threads()


@pytest.mark.parametrize("em_batch", [1, 2])
def test_break_after_the_first_tile_returns(em_batch, monkeypatch):
    """A caller that stops after the first tile of an endless stream gets
    control back, having pulled what the JAX package pulls, and no worker
    thread is left."""
    from spateo_tpu.ops import bp_pallas

    monkeypatch.setattr(bp_pallas, "bp_kernel_pallas", partial(bp_pallas.bp_kernel_pallas, interpret=True))
    tiles = [_tile((64, 96), 0), _tile((64, 96), 1)]
    pulled = []
    for stream, kw in ((JS.starro_em_bp_stream, {}), (TS.starro_em_bp_stream, {"device": "cpu"})):
        src = _Counted(itertools.cycle(tiles))
        for s, m in stream(src, em_batch=em_batch, mask_only=True, **KW, **kw):
            assert m.shape == (64, 96)
            break
        pulled.append(src.pulled)
    assert pulled[1] == pulled[0] == (4 if em_batch == 1 else 5)
    assert _no_stream_threads()


# -- labeling a packed mask -----------------------------------------------------------------------------------


def _disks(n=96, seed=0):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n]
    m = np.zeros((n, n), bool)
    for _ in range(25):
        cy, cx, rad = r.integers(0, n), r.integers(0, n), r.integers(3, 8)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad * rad
    return m


@pytest.mark.parametrize("packed", ["numpy", "tensor"])
def test_label_cells_from_packed_mask_matches_jax(packed):
    """Labels and centroids of a packed mask (host bytes, or a tensor as the
    stream leaves it) equal the JAX package's on the bool mask, and the
    port's on the bool mask."""
    m = _disks()
    lj, cj = JL.label_cells_from_mask(m, 3)
    bits = np.packbits(m.ravel()) if packed == "numpy" else TB.packbits(torch.from_numpy(m))
    lt, ct = TL.label_cells_from_mask(bits, 3, shape=m.shape, device="cpu")
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ct, cj)
    lb, cb = TL.label_cells_from_mask(m, 3, device="cpu")
    assert torch.equal(lb, lt) and np.array_equal(cb, ct)
