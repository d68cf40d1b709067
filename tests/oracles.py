"""Numpy oracles: direct transcriptions of the reference CPU kernels' loop
semantics (channel-last layout), used as ground truth for the JAX ops.

Each function mirrors one CPU reference kernel cited in its docstring; they
are deliberately written as naive loops so the test suite checks our fused
formulations against the literal spec, in the spirit of the reference's own
CPU-vs-GPU parity tests (`user_ops/test_flex_convolution.py:42-50`).
"""

import numpy as np


def knn_oracle(positions, k):
    """`user_ops/kernels/knn_bruteforce_kernel.cc:41-70`.
    positions [B,N,D] -> (idx [B,N,k], dist [B,N,k]) ascending Euclidean."""
    B, N, _ = positions.shape
    idx = np.zeros((B, N, k), np.int32)
    dist = np.zeros((B, N, k), np.float64)
    for b in range(B):
        d = np.sqrt(
            np.sum(
                (positions[b][:, None, :] - positions[b][None, :, :]) ** 2, -1
            )
        )
        for n in range(N):
            order = np.argsort(d[n], kind="stable")
            idx[b, n] = order[:k]
            dist[b, n] = d[n][order[:k]]
    return idx, dist


def flex_conv_oracle(features, positions, neighborhood, theta, bias):
    """`user_ops/kernels/flex_conv_kernel.cc:48-68`.
    features [B,N,Din], positions [B,N,Dp], neighborhood [B,N,K],
    theta [Dp,Din,Dout], bias [Din,Dout] -> [B,N,Dout]."""
    B, N, K = neighborhood.shape
    Dp, Din, Dout = theta.shape
    out = np.zeros((B, N, Dout), np.float64)
    for b in range(B):
        for n in range(N):
            n0 = neighborhood[b, n, 0]
            for k_ in range(K):
                nk = neighborhood[b, n, k_]
                delta = positions[b, nk] - positions[b, n0]  # [Dp]
                W = bias + np.einsum("p,pio->io", delta, theta)  # [Din,Dout]
                out[b, n] += features[b, nk] @ W
    return out


def conv_pointset_oracle(features, neighborhood, theta, bias):
    """`user_ops/kernels/conv_pointset_kernel.cc:49-64`."""
    B, N, K = neighborhood.shape
    Dout = theta.shape[1]
    out = np.zeros((B, N, Dout), np.float64)
    for b in range(B):
        for n in range(N):
            n0 = neighborhood[b, n, 0]
            for k_ in range(K):
                nk = neighborhood[b, n, k_]
                out[b, n] += (features[b, nk] - features[b, n0]) @ theta
            out[b, n] += bias
    return out


def flex_pool_oracle(features, neighborhood):
    """`user_ops/kernels/flex_pool_kernel.cc:42-56`.
    features [B,N,D], neighborhood [B,M,K] -> (out [B,M,D], argmax [B,M,D])."""
    B, M, K = neighborhood.shape
    D = features.shape[-1]
    out = np.full((B, M, D), -np.inf)
    argmax = np.zeros((B, M, D), np.int32)
    for b in range(B):
        for n in range(M):
            for k_ in range(K):
                g = neighborhood[b, n, k_]
                better = out[b, n] < features[b, g]
                out[b, n] = np.where(better, features[b, g], out[b, n])
                argmax[b, n] = np.where(better, g, argmax[b, n])
    return out, argmax


def flex_deconv_oracle(features, positions, neighborhood, theta, bias):
    """`user_ops/kernels/flex_deconv_kernel.cc:49-69`."""
    B, N, K = neighborhood.shape
    Dp, Din, Dout = theta.shape
    out = np.zeros((B, N, Dout), np.float64)
    for b in range(B):
        for n in range(N):
            self_k = neighborhood[b, n, 0]
            v = features[b, self_k]
            for k_ in range(K):
                other = neighborhood[b, n, k_]
                delta = positions[b, other] - positions[b, self_k]
                W = bias + np.einsum("p,pio->io", delta, theta)
                out[b, other] += v @ W
    return out


def fps_oracle(points, m):
    """`tf_ops/sampling/tf_sampling_g.cu:105-170`: seed 0, iterate argmax of
    running min squared distance."""
    B, N, _ = points.shape
    idxs = np.zeros((B, m), np.int32)
    for b in range(B):
        mind = np.full(N, np.inf)
        last = 0
        for j in range(1, m):
            d = np.sum((points[b] - points[b, last]) ** 2, -1)
            mind = np.minimum(mind, d)
            last = int(np.argmax(mind))
            idxs[b, j] = last
    return idxs


def query_ball_oracle(radius, nsample, xyz1, xyz2):
    """`tf_ops/grouping/tf_grouping_g.cu:3-52`."""
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    idx = np.zeros((B, M, nsample), np.int32)
    cnt = np.zeros((B, M), np.int32)
    for b in range(B):
        for j in range(M):
            c = 0
            nearest_d, nearest_k = np.inf, -1
            for k in range(N):
                d = max(np.sqrt(np.sum((xyz2[b, j] - xyz1[b, k]) ** 2)), 1e-20)
                if c < nsample and d < radius:
                    if c == 0:
                        idx[b, j, :] = k
                    idx[b, j, c] = k
                    c += 1
                if d < nearest_d:
                    nearest_d, nearest_k = d, k
            if c == 0:
                idx[b, j, :] = nearest_k
            cnt[b, j] = c
    return idx, cnt


def three_nn_oracle(xyz1, xyz2):
    """`tf_ops/interpolation/tf_interpolate.cpp:60-103` (squared L2)."""
    B, N, _ = xyz1.shape
    dist = np.zeros((B, N, 3))
    idx = np.zeros((B, N, 3), np.int32)
    for b in range(B):
        d2 = np.sum((xyz1[b][:, None] - xyz2[b][None]) ** 2, -1)
        order = np.argsort(d2, axis=-1, kind="stable")[:, :3]
        idx[b] = order
        dist[b] = np.take_along_axis(d2, order, axis=-1)
    return dist, idx
