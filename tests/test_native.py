"""Native C++ host-kernel tests.  The library is built from
`native/dh3d_native.cpp` on first use; they skip where no C++ compiler
can build it."""

import numpy as np
import pytest

import oracles
from dh3d_tpu import native


@pytest.fixture(autouse=True)
def _needs_native_library():
    if not native.available():
        pytest.skip("native library could not be built (no C++ compiler)")


def test_native_fps_matches_oracle(rng):
    pts = rng.randn(512, 3).astype(np.float32) * 10
    idx = native.fps(pts, 64)
    expect = oracles.fps_oracle(pts[None], 64)[0]
    np.testing.assert_array_equal(idx, expect)


def test_native_nn1_matches_scipy(rng):
    from scipy.spatial import cKDTree

    ref = rng.randn(2048, 3).astype(np.float32) * 10
    q = rng.randn(256, 3).astype(np.float32) * 10
    i1 = native.nn1(q, ref)
    _, i2 = cKDTree(ref).query(q, k=1)
    np.testing.assert_array_equal(i1, i2)


def test_native_nn1_far_queries(rng):
    """Queries far outside the reference cloud exercise the expanding
    radius + final-coverage pass."""
    from scipy.spatial import cKDTree

    ref = rng.randn(128, 3).astype(np.float32)
    q = rng.randn(16, 3).astype(np.float32) + 500.0
    i1 = native.nn1(q, ref)
    _, i2 = cKDTree(ref).query(q, k=1)
    np.testing.assert_array_equal(i1, i2)


def test_native_knn_matches_oracle(rng):
    pts = rng.randn(256, 3).astype(np.float32) * 5
    idx = native.knn(pts, 8)
    expect, _ = oracles.knn_oracle(pts[None], 8)
    np.testing.assert_array_equal(idx, expect[0])


def test_native_voxel_and_outlier(rng):
    from dh3d_tpu.data import io

    pts = rng.randn(2000, 3).astype(np.float32) * 2
    v1 = native.voxel_downsample(pts, 0.5)
    # bypass the native dispatch to get the pure-numpy reference
    keys = np.floor(np.asarray(pts, np.float64) / 0.5).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                   return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inverse, np.asarray(pts, np.float64))
    v2 = (sums / counts[:, None]).astype(np.float32)
    assert v1.shape == v2.shape
    np.testing.assert_allclose(np.sort(v1, axis=0), np.sort(v2, axis=0),
                               atol=1e-4)

    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    counts = tree.query_ball_point(pts, r=1.0, return_length=True)
    expect = np.where(counts - 1 >= 4)[0]
    got = native.remove_radius_outlier(pts, 4, 1.0)
    np.testing.assert_array_equal(np.sort(got), np.sort(expect))
