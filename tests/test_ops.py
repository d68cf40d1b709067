"""Op-level parity tests against the reference CPU-kernel semantics.

Pattern follows the reference's own op tests
(`user_ops/test_flex_convolution.py`): seeded random fixture at small sizes
(B=2, N=32, K=4), forward parity vs the naive oracle, and gradient checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.test_util import check_grads

import oracles
from dh3d_tpu import ops


class Fixture:
    """FakePointCloud-style fixture (`user_ops/misc.py:31-84`)."""

    def __init__(self, rng, B=2, N=32, K=4, Din=3, Dout=5, Dp=3, scale=1.0):
        self.positions = rng.randn(B, N, Dp).astype(np.float32) * scale
        self.features = rng.randn(B, N, Din).astype(np.float32)
        self.theta = rng.randn(Dp, Din, Dout).astype(np.float32)
        self.bias = rng.randn(Din, Dout).astype(np.float32)
        self.neighborhood, _ = oracles.knn_oracle(self.positions, K)


def test_knn_matches_oracle(rng):
    f = Fixture(rng, N=48, K=6)
    idx, dist = ops.knn_bruteforce(jnp.asarray(f.positions), 6)
    oidx, odist = oracles.knn_oracle(f.positions, 6)
    np.testing.assert_allclose(np.asarray(dist), odist, atol=1e-4)
    # self is always slot 0
    np.testing.assert_array_equal(np.asarray(idx[..., 0]),
                                  np.arange(48)[None].repeat(2, 0))
    # indices may differ only on exactly-tied distances
    np.testing.assert_array_equal(np.asarray(idx), oidx)


def test_knn_chunked_matches_unchunked(rng):
    pos = jnp.asarray(rng.randn(2, 64, 3).astype(np.float32))
    i1, d1 = ops.knn_bruteforce(pos, 8, chunk=64)
    i2, d2 = ops.knn_bruteforce(pos, 8, chunk=16)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-6)


def test_knn_pairwise(rng):
    q = jnp.asarray(rng.randn(2, 8, 3).astype(np.float32))
    r = jnp.asarray(rng.randn(2, 32, 3).astype(np.float32))
    idx, dist = ops.knn_bruteforce_pairwise(q, r, 4)
    d = np.sqrt(np.sum((np.asarray(q)[:, :, None] - np.asarray(r)[:, None]) ** 2, -1))
    expect = np.sort(d, axis=-1)[..., :4]
    np.testing.assert_allclose(np.asarray(dist), expect, atol=1e-5)


def test_flex_conv_matches_oracle(rng):
    f = Fixture(rng)
    out = ops.flex_conv(
        jnp.asarray(f.features), jnp.asarray(f.positions),
        jnp.asarray(f.neighborhood), jnp.asarray(f.theta), jnp.asarray(f.bias),
    )
    expect = oracles.flex_conv_oracle(
        f.features, f.positions, f.neighborhood, f.theta, f.bias
    )
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-4, atol=1e-4)


def test_flex_conv_grads(rng):
    f = Fixture(rng, B=1, N=8, K=3, Din=2, Dout=3)
    fn = lambda feat, th, bi: jnp.sum(
        jnp.sin(ops.flex_conv(feat, jnp.asarray(f.positions),
                              jnp.asarray(f.neighborhood), th, bi))
    )
    check_grads(
        fn,
        (jnp.asarray(f.features), jnp.asarray(f.theta), jnp.asarray(f.bias)),
        order=1, modes=["rev"], atol=1e-2, rtol=1e-2,
    )


def test_flex_avg_is_neighborhood_sum(rng):
    f = Fixture(rng)
    out = ops.flex_avg(jnp.asarray(f.features), jnp.asarray(f.neighborhood))
    # flex_avg == flex_conv with zero theta, identity bias
    # (`core/layers.py:342-436`)
    Din = f.features.shape[-1]
    expect = oracles.flex_conv_oracle(
        f.features, f.positions, f.neighborhood,
        np.zeros((3, Din, Din), np.float32), np.eye(Din, dtype=np.float32),
    )
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-4, atol=1e-4)


def test_conv_pointset_matches_oracle(rng):
    f = Fixture(rng)
    theta = rng.randn(3, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    out = ops.conv_pointset(
        jnp.asarray(f.features), jnp.asarray(f.neighborhood),
        jnp.asarray(theta), jnp.asarray(bias),
    )
    expect = oracles.conv_pointset_oracle(f.features, f.neighborhood, theta, bias)
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-4, atol=1e-4)


def test_flex_pool_matches_oracle(rng):
    f = Fixture(rng, Din=6)
    out, argmax = ops.flex_pool(jnp.asarray(f.features),
                                jnp.asarray(f.neighborhood))
    eo, ea = oracles.flex_pool_oracle(f.features, f.neighborhood)
    np.testing.assert_allclose(np.asarray(out), eo, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(argmax), ea)


def test_flex_deconv_matches_oracle(rng):
    f = Fixture(rng)
    out = ops.flex_deconv(
        jnp.asarray(f.features), jnp.asarray(f.positions),
        jnp.asarray(f.neighborhood), jnp.asarray(f.theta), jnp.asarray(f.bias),
    )
    expect = oracles.flex_deconv_oracle(
        f.features, f.positions, f.neighborhood, f.theta, f.bias
    )
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-3, atol=1e-3)


def test_fps_matches_oracle(rng):
    pts = rng.randn(2, 40, 3).astype(np.float32)
    idx = ops.farthest_point_sample(jnp.asarray(pts), 10)
    expect = oracles.fps_oracle(pts, 10)
    np.testing.assert_array_equal(np.asarray(idx), expect)


def test_gather_and_group(rng):
    pts = rng.randn(2, 16, 5).astype(np.float32)
    idx = rng.randint(0, 16, (2, 6)).astype(np.int32)
    out = ops.gather_point(jnp.asarray(pts), jnp.asarray(idx))
    np.testing.assert_allclose(
        np.asarray(out), np.stack([pts[b][idx[b]] for b in range(2)])
    )
    gidx = rng.randint(0, 16, (2, 4, 3)).astype(np.int32)
    g = ops.group_point(jnp.asarray(pts), jnp.asarray(gidx))
    np.testing.assert_allclose(
        np.asarray(g), np.stack([pts[b][gidx[b]] for b in range(2)])
    )


def test_query_ball_matches_oracle(rng):
    xyz1 = rng.randn(2, 32, 3).astype(np.float32)
    xyz2 = rng.randn(2, 8, 3).astype(np.float32)
    idx, cnt = ops.query_ball_point(1.0, 5, jnp.asarray(xyz1), jnp.asarray(xyz2))
    eidx, ecnt = oracles.query_ball_oracle(1.0, 5, xyz1, xyz2)
    np.testing.assert_array_equal(np.asarray(cnt), ecnt)
    np.testing.assert_array_equal(np.asarray(idx), eidx)


def test_query_ball_empty_falls_back_to_nearest(rng):
    xyz1 = np.ones((1, 4, 3), np.float32) * 10
    xyz1[0, 2] = 9.0  # nearest to origin
    xyz2 = np.zeros((1, 1, 3), np.float32)
    idx, cnt = ops.query_ball_point(0.5, 3, jnp.asarray(xyz1), jnp.asarray(xyz2))
    assert int(cnt[0, 0]) == 0
    np.testing.assert_array_equal(np.asarray(idx)[0, 0], [2, 2, 2])


def test_three_nn_matches_oracle(rng):
    xyz1 = rng.randn(2, 24, 3).astype(np.float32)
    xyz2 = rng.randn(2, 9, 3).astype(np.float32)
    dist, idx = ops.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2))
    edist, eidx = oracles.three_nn_oracle(xyz1, xyz2)
    np.testing.assert_allclose(np.asarray(dist), edist, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(idx), eidx)


def test_three_interpolate(rng):
    pts = rng.randn(2, 9, 7).astype(np.float32)
    idx = rng.randint(0, 9, (2, 24, 3)).astype(np.int32)
    w = rng.rand(2, 24, 3).astype(np.float32)
    out = ops.three_interpolate(jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(w))
    expect = np.einsum("bnj,bnjc->bnc", w,
                       np.stack([pts[b][idx[b]] for b in range(2)]))
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-5, atol=1e-5)
    check_grads(
        lambda p: jnp.sum(ops.three_interpolate(p, jnp.asarray(idx), jnp.asarray(w))),
        (jnp.asarray(pts),), order=1, modes=["rev"], atol=1e-2, rtol=1e-2,
    )


def test_prob_sample(rng):
    inp = np.abs(rng.rand(2, 10)).astype(np.float32)
    total = inp.sum(-1, keepdims=True)
    r = (rng.rand(2, 5) * total).astype(np.float32)
    idx = ops.prob_sample(jnp.asarray(inp), jnp.asarray(r))
    cdf = np.cumsum(inp, -1)
    expect = np.stack([np.searchsorted(cdf[b], r[b], side="left") for b in range(2)])
    np.testing.assert_array_equal(np.asarray(idx), np.clip(expect, 0, 9))


def test_subsample(rng):
    pts = rng.randn(2, 32, 3).astype(np.float32)
    feat = rng.randn(2, 32, 6).astype(np.float32)
    xyz_s, feat_s, kp = ops.subsample(jnp.asarray(pts), jnp.asarray(feat), 8)
    expect_kp = oracles.fps_oracle(pts, 8)
    np.testing.assert_array_equal(np.asarray(kp), expect_kp)
    np.testing.assert_allclose(
        np.asarray(feat_s), np.stack([feat[b][expect_kp[b]] for b in range(2)])
    )


# ------------------------------ FPS kernel ------------------------------

@pytest.mark.parametrize("B,N,npoint", [
    (1, 64, 16),
    (2, 256, 32),
    (3, 100, 17),    # N padded 100 -> 128 with copies of point 0
    (2, 1000, 64),   # N padded 1000 -> 1024
    (1, 33, 33),     # every real point picked; padding never chosen
    (2, 512, 512),   # npoint == N, power of two
    (4, 128, 1),     # the seed alone
])
def test_fps_triton_interpret_matches_xla_and_oracle(rng, B, N, npoint):
    from dh3d_tpu.ops.sampling import _fps_xla, fps_triton

    pts = rng.randn(B, N, 3).astype(np.float32) * 5
    got = np.asarray(fps_triton(jnp.asarray(pts), npoint, interpret=True))
    assert got.shape == (B, npoint) and got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(_fps_xla(jnp.asarray(pts), npoint)))
    np.testing.assert_array_equal(got, oracles.fps_oracle(pts, npoint))
    assert (got < N).all()


def test_fps_dispatch_by_platform(rng):
    """farthest_point_sample lowers to the XLA loop for the CPU: no
    Triton kernel in the program, same indices as `_fps_xla`."""
    from dh3d_tpu.ops.sampling import _fps_xla

    pts = jnp.asarray(rng.randn(2, 96, 3).astype(np.float32))
    fn = jax.jit(lambda p: ops.farthest_point_sample(p, 24))
    assert "triton" not in fn.lower(pts).as_text()
    np.testing.assert_array_equal(np.asarray(fn(pts)),
                                  np.asarray(_fps_xla(pts, 24)))


def test_fps_triton_rejects_npoint_above_n(rng):
    from dh3d_tpu.ops.sampling import fps_triton

    with pytest.raises(ValueError, match="exceeds"):
        fps_triton(jnp.asarray(rng.randn(1, 16, 3).astype(np.float32)), 17,
                   interpret=True)


# ------------------------------ kNN (XLA) -------------------------------

@pytest.mark.parametrize("chunk", [None, 8, 32, 96])
def test_knn_chunk_sizes_match_oracle(rng, chunk):
    pos = rng.randn(2, 96, 3).astype(np.float32) * 3
    idx, dist = ops.knn_bruteforce(jnp.asarray(pos), 5, chunk=chunk)
    oidx, odist = oracles.knn_oracle(pos, 5)
    np.testing.assert_array_equal(np.asarray(idx), oidx)
    np.testing.assert_allclose(np.asarray(dist), odist, atol=1e-4)


def test_knn_chunk_must_divide_n(rng):
    with pytest.raises(ValueError, match="divide"):
        ops.knn_bruteforce(jnp.zeros((1, 96, 3)), 4, chunk=40)


def test_knn_unaligned_sizes(rng):
    """N not a multiple of any tile: 100 points, self at slot 0."""
    pos = rng.randn(1, 100, 3).astype(np.float32)
    idx, _ = ops.knn_bruteforce(jnp.asarray(pos), 4)
    assert idx.shape == (1, 100, 4)
    np.testing.assert_array_equal(np.asarray(idx),
                                  oracles.knn_oracle(pos, 4)[0])
    np.testing.assert_array_equal(np.asarray(idx)[0, :, 0], np.arange(100))


def test_knn_duplicate_points_self_at_slot0(rng):
    """Exact duplicates: the query itself wins slot 0 (the reference's
    exact zero self-distance, `knn_bruteforce_kernel.cc:65-68`) and its
    twin follows at distance 0."""
    pos = rng.randn(1, 64, 3).astype(np.float32)
    pos[0, 32:48] = pos[0, 0:16]
    idx, dist = ops.knn_bruteforce(jnp.asarray(pos), 3)
    idx, dist = np.asarray(idx), np.asarray(dist)
    r = np.arange(64)
    np.testing.assert_array_equal(idx[0, :, 0], r)
    np.testing.assert_array_equal(idx[0, 0:16, 1], r[32:48])
    np.testing.assert_array_equal(idx[0, 32:48, 1], r[0:16])
    assert (dist[0, 0:16, :2] == 0).all() and (dist[0, 32:48, :2] == 0).all()
    assert (np.diff(dist, axis=-1) >= 0).all()


def test_knn_pairwise_cross_cloud_indices(rng):
    """Cross-cloud kNN: indices into the reference cloud, ascending."""
    q = rng.randn(2, 16, 3).astype(np.float32)
    keys = rng.randn(2, 40, 3).astype(np.float32)
    idx, dist = ops.knn_bruteforce_pairwise(jnp.asarray(q),
                                            jnp.asarray(keys), 3)
    d = np.sum((q[:, :, None] - keys[:, None]) ** 2, -1)
    np.testing.assert_array_equal(
        np.asarray(idx), np.argsort(d, axis=-1, kind="stable")[..., :3])
    assert (np.diff(np.asarray(dist), axis=-1) >= 0).all()


# -------------------------- gradients vs oracles --------------------------

def _linear_vjp_oracle(fn, x, g):
    """J^T g of an affine numpy oracle `fn`, column by column in float64."""
    x = x.astype(np.float64)
    base = fn(x)
    out = np.zeros(x.size)
    for i in range(x.size):
        e = np.zeros(x.size)
        e[i] = 1.0
        out[i] = np.sum((fn(x + e.reshape(x.shape)) - base) * g)
    return out.reshape(x.shape)


def _vjp(fn, x, g):
    return np.asarray(jax.grad(lambda v: jnp.sum(fn(v) * g))(jnp.asarray(x)))


def test_flex_pool_grad_routes_to_argmax(rng):
    """The VJP of the max-pool sends each cotangent to the argmax point,
    as the reference's pooling backward does."""
    f = Fixture(rng, B=2, N=16, K=4, Din=3)
    g = rng.randn(2, 16, 3).astype(np.float32)
    got = _vjp(lambda v: ops.flex_pool(v, jnp.asarray(f.neighborhood))[0],
               f.features, g)
    _, arg = oracles.flex_pool_oracle(f.features, f.neighborhood)
    want = np.zeros_like(f.features)
    for b in range(2):
        for d in range(3):
            np.add.at(want[b, :, d], arg[b, :, d], g[b, :, d])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_flex_avg_grad_matches_oracle(rng):
    f = Fixture(rng, B=1, N=12, K=4, Din=2)
    g = rng.randn(1, 12, 2).astype(np.float32)
    eye = np.eye(2)
    want = _linear_vjp_oracle(
        lambda x: oracles.flex_conv_oracle(x, f.positions, f.neighborhood,
                                           np.zeros((3, 2, 2)), eye),
        f.features, g)
    got = _vjp(lambda v: ops.flex_avg(v, jnp.asarray(f.neighborhood)),
               f.features, g)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv_pointset_grad_matches_oracle(rng):
    f = Fixture(rng, B=1, N=12, K=4, Din=3)
    theta = rng.randn(3, 4).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    g = rng.randn(1, 12, 4).astype(np.float32)
    want = _linear_vjp_oracle(
        lambda x: oracles.conv_pointset_oracle(x, f.neighborhood, theta,
                                               bias),
        f.features, g)
    got = _vjp(lambda v: ops.conv_pointset(v, jnp.asarray(f.neighborhood),
                                           jnp.asarray(theta),
                                           jnp.asarray(bias)),
               f.features, g)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_three_interpolate_grad_matches_oracle(rng):
    points = rng.randn(2, 8, 3).astype(np.float32)
    idx = rng.randint(0, 8, (2, 20, 3)).astype(np.int32)
    w = rng.rand(2, 20, 3).astype(np.float32)
    g = rng.randn(2, 20, 3).astype(np.float32)

    def oracle(x):  # `tf_interpolate.cpp:107-127`
        return np.stack([np.einsum("nj,njc->nc", w[b], x[b][idx[b]])
                         for b in range(2)])

    want = _linear_vjp_oracle(oracle, points, g)
    got = _vjp(lambda v: ops.three_interpolate(v, jnp.asarray(idx),
                                               jnp.asarray(w)), points, g)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flex_conv_bf16_matches_oracle(rng):
    """bf16 features/weights (the `compute_dtype` path): forward and the
    feature gradient within bf16 rounding (8 mantissa bits) of the f64
    oracle; positions stay f32."""
    f = Fixture(rng, B=1, N=12, K=4, Din=3, Dout=4)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    feat, theta, bias = (np.asarray(bf(a), np.float32)
                         for a in (f.features, f.theta, f.bias))
    fn = lambda v: ops.flex_conv(v, jnp.asarray(f.positions),
                                 jnp.asarray(f.neighborhood), bf(theta),
                                 bf(bias))
    out = np.asarray(fn(bf(feat)), np.float32)
    want = oracles.flex_conv_oracle(feat, f.positions, f.neighborhood,
                                    theta, bias)
    scale = np.abs(want).max()
    np.testing.assert_allclose(out, want, atol=2e-2 * scale)

    g = rng.randn(1, 12, 4).astype(np.float32)
    got = np.asarray(jax.grad(lambda v: jnp.sum(
        fn(v).astype(jnp.float32) * g))(bf(feat)), np.float32)
    want_g = _linear_vjp_oracle(
        lambda x: oracles.flex_conv_oracle(x, f.positions, f.neighborhood,
                                           theta, bias), feat, g)
    np.testing.assert_allclose(got, want_g, atol=2e-2 * np.abs(want_g).max())


def test_morton_perm(rng):
    pts = rng.randn(2, 128, 3).astype(np.float32) * 10
    perm, inv = ops.morton_perm(jnp.asarray(pts))
    perm, inv = np.asarray(perm), np.asarray(inv)
    for b in range(2):
        assert sorted(perm[b]) == list(range(128))
        np.testing.assert_array_equal(perm[b][inv[b]], np.arange(128))
    # locality: mean 1-NN index distance after sort is much smaller than
    # before (the whole point of the ordering)
    from scipy.spatial import cKDTree

    s = pts[0][perm[0]]
    _, nn_s = cKDTree(s).query(s, k=2)
    _, nn_o = cKDTree(pts[0]).query(pts[0], k=2)
    band_s = np.abs(nn_s[:, 1] - np.arange(128)).mean()
    band_o = np.abs(nn_o[:, 1] - np.arange(128)).mean()
    assert band_s < band_o / 2, (band_s, band_o)
