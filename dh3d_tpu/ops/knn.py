"""Brute-force k-nearest-neighbors for point clouds.

Ground-truth semantics: reference CPU kernel
`user_ops/kernels/knn_bruteforce_kernel.cc:25-72` — for every point n of a
cloud, the K nearest points of the *same* cloud by Euclidean distance,
indices+distances sorted ascending; neighbor k=0 is the point itself
(distance 0).  The reference GPU kernel caps N at 8192
(`user_ops/kernels/knn_bruteforce_kernel_gpu.cu.cc:213-221`), forcing a host
(sklearn) fallback for larger clouds (`core/model.py:38,84-96`).  No such
cap here: the [N, N] distance matrix is never fully materialized —
queries are processed in `lax.scan` chunks, each one matmul-identity
distance block + `lax.top_k`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _chunk_topk(positions, q_pos, k, self_start=None):
    """Top-k nearest of all `positions` for the chunk of queries `q_pos`.

    positions: [B, N, D]; q_pos: [B, Q, D] -> (idx [B, Q, k], sqdist [B, Q, k])

    If `self_start` is given (index of q_pos[:, 0] within `positions`), the
    query's own entry is pinned to distance -1 so it always wins slot k=0 —
    the reference guarantees neighbor 0 == self because its exact distance is
    0 (`knn_bruteforce_kernel.cc:65-68`), which float error in the matmul
    identity would otherwise not preserve.
    """
    # Squared L2 via the matmul identity — one contraction per chunk.
    # d2[b, q, n] = |q|^2 - 2 q.n + |n|^2
    qn = jnp.einsum(
        "bqd,bnd->bqn", q_pos, positions, precision="highest", preferred_element_type=jnp.float32
    )
    q2 = jnp.sum(q_pos * q_pos, axis=-1, keepdims=True)  # [B, Q, 1]
    n2 = jnp.sum(positions * positions, axis=-1)[:, None, :]  # [B, 1, N]
    d2 = q2 - 2.0 * qn + n2
    if self_start is not None:
        Q, N = q_pos.shape[1], positions.shape[1]
        rows = jax.lax.broadcasted_iota(jnp.int32, (Q, N), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (Q, N), 1)
        d2 = jnp.where((cols == rows + self_start)[None], -1.0, d2)
    neg_d2, idx = jax.lax.top_k(-d2, k)
    return idx.astype(jnp.int32), jnp.maximum(-neg_d2, 0.0)


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def knn_bruteforce(positions, k, chunk=None):
    """K nearest neighbors of every point within its own cloud.

    Args:
      positions: [B, N, Dp] float array of point coordinates (channel-last;
        the reference op takes [B, Dp, N], `user_ops/ops/knn_bruteforce.cc`).
      k: neighborhood size (k=0 is the query point itself).
      chunk: query-chunk size; bounds peak memory at B*chunk*N*4 bytes.

    Returns:
      (indices [B, N, k] int32, distances [B, N, k] float) — ascending by
      distance; distances are Euclidean (sqrt), matching
      `knn_bruteforce_kernel.cc:52`.
    """
    B, N, _ = positions.shape
    if chunk is None:
        target = (64 * 1024 * 1024) // 4
        chunk = max(128, min(N, target // max(1, B * N)))
        while N % chunk:
            chunk //= 2
        chunk = max(chunk, 1)
    if N % chunk:
        raise ValueError(f"chunk {chunk} must divide N {N}")
    n_chunks = N // chunk

    if n_chunks == 1:
        idx, d2 = _chunk_topk(positions, positions, k, self_start=0)
    else:
        q_chunks = positions.reshape(B, n_chunks, chunk, -1).transpose(1, 0, 2, 3)
        starts = jnp.arange(n_chunks, dtype=jnp.int32) * chunk

        def step(carry, xs):
            q_pos, start = xs
            return carry, _chunk_topk(carry, q_pos, k, self_start=start)

        _, (idx, d2) = jax.lax.scan(step, positions, (q_chunks, starts))
        idx = idx.transpose(1, 0, 2, 3).reshape(B, N, k)
        d2 = d2.transpose(1, 0, 2, 3).reshape(B, N, k)
    return idx, jnp.sqrt(d2)


def knn_bruteforce_pairwise(query, reference, k):
    """K nearest points of `reference` for each point of `query` (cross-cloud).

    query: [B, M, D], reference: [B, N, D] -> (idx [B, M, k], dist [B, M, k]).
    Generalization used by eval-time matching; the reference computes this on
    the host with sklearn (`core/utils.py:53-57`).
    """
    idx, d2 = _chunk_topk(reference, query, k)
    return idx, jnp.sqrt(d2)
