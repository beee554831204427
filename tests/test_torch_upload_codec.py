"""The lossless tile upload codec (`segmentation/starro.py::encode_tile`,
`upload_tile`) against the JAX package's on the CPU, on the cases of its
own tests (`tests/test_segmentation.py::TestTileUploadCodec`).

Bars: `encode_tile`'s encoding and every array equal to the JAX package's
(values and dtypes); `upload_tile(X, device="cpu")` equal bit for bit to
``np.asarray(upload_tile(X))`` of the JAX package, in dtype and shape too;
the stream's `_upload` of a sparse tile (through the codec when it is COO)
equal to the dense raster.
"""

import numpy as np
import pytest
import torch
from scipy import sparse

from spateo_tpu.segmentation import starro as JS
from spateo_tpu_torch.segmentation import starro as TS


def _packed4():
    X = np.random.default_rng(0).integers(0, 15, (123, 77)).astype(np.float32)
    X[10, 10], X[0, 0], X[5, 5] = 90.0, 16.0, 15.0
    return X


def _packed2():
    X = np.random.default_rng(0).negative_binomial(1, 0.5, (123, 77)).astype(np.float32)
    X[10, 10], X[11, 11], X[5, 5], X[6, 6] = 90.0, 300.0, 3.0, 2.0
    return X


def _odd(shape):
    X = np.random.default_rng(7).negative_binomial(1, 0.35, shape).astype(np.int32)
    X[0, 0] = 4
    return X


def _coo():
    rng = np.random.default_rng(1)
    X = np.zeros((200, 150), np.int32)
    X.flat[rng.choice(X.size, 900, replace=False)] = rng.integers(1, 300, 900)
    return X


CASES = {
    "packed4": (_packed4, "packed4"),
    "packed2": (_packed2, "packed2"),
    "odd 13x5": (lambda: _odd((13, 5)), None),
    "odd 33x3": (lambda: _odd((33, 3)), None),
    "odd 2x2": (lambda: _odd((2, 2)), None),
    "all escape": (lambda: np.full((40, 41), 200, np.int32), None),
    "coo": (_coo, "coo"),
    "coo from scipy": (lambda: sparse.csr_matrix(_coo()), "coo"),
    "sparse negative": (lambda: sparse.coo_matrix(([-3.0, 5.0], ([0, 1], [0, 1])), shape=(4, 4)), "dense"),
    "sparse overflow": (lambda: sparse.coo_matrix(([40000.0], ([0], [0])), shape=(50, 50)), "dense"),
    "sparse duplicates": (lambda: sparse.coo_matrix(([2.0, 3.0], ([1, 1], [2, 2])), shape=(30, 40)), None),
    "non-integral": (lambda: np.random.default_rng(2).uniform(0, 3, (20, 20)).astype(np.float32), "dense"),
    "negative": (lambda: np.array([[-1, 2], [3, 4]], np.int32), "dense"),
    "zeros odd": (lambda: np.zeros((7, 9)), None),
    "packed4 odd": (lambda: np.random.default_rng(3).integers(0, 14, (33, 35)), "packed4"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_encode_tile_matches_jax(case):
    make, kind = CASES[case]
    X = make()
    ej, et = JS.encode_tile(X), TS.encode_tile(X)
    assert et[0] == ej[0] and (kind is None or et[0] == kind)
    assert tuple(et[-1]) == tuple(ej[-1])
    assert len(et) == len(ej)
    for a, b in zip(ej[1:-1], et[1:-1]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", list(CASES))
def test_upload_tile_equals_jax_bit_for_bit(case):
    X = CASES[case][0]()
    uj = np.asarray(JS.upload_tile(X))
    ut = TS.upload_tile(X, device="cpu").numpy()
    assert ut.dtype == uj.dtype and ut.shape == uj.shape and ut.tobytes() == uj.tobytes()
    dense = X.toarray() if sparse.issparse(X) else np.asarray(X)
    if TS.encode_tile(X)[0] != "dense":
        np.testing.assert_array_equal(ut, dense.astype(np.int16))


@pytest.mark.parametrize("case", ["coo from scipy", "sparse duplicates", "sparse negative"])
def test_stream_upload_of_a_sparse_tile_is_the_dense_raster(case):
    """`_upload` sends a sparse tile that the codec would send as COO
    through the codec, and densifies the rest: either way the stream gets
    the dense raster, int16 where its counts fit."""
    S = CASES[case][0]()
    t = TS._upload(S, "cpu")
    dense = S.toarray()
    assert t.dtype == torch.int16 and np.array_equal(t.numpy(), dense)
