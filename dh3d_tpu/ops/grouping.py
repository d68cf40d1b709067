"""Grouping ops (PointNet++ family).

Ground-truth semantics: `tf_ops/grouping/tf_grouping_g.cu` —
  query_ball_point   `:3-52`   (first nsample ids within radius, fill with
                               first hit; if none, fall back to the nearest)
  query_ball_point2  `:56-90`  (per-query radii, fill with first hit)
  group_point        `:94-111` (batched gather)
  selection_sort     `:137-177`(top-k smallest of a dist matrix, ascending)
Python surface: `tf_ops/grouping/tf_grouping.py:9-88` (knn_point computes a
pairwise distance matrix then select_top_k).

"First nsample in index order" is a sequential scan on GPU; here it becomes
a rank computation: rank[n] = #inside-points with index < n, and point n
lands in slot rank[n] iff inside and rank < nsample — a cumsum + one scatter,
fully vectorized.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dh3d_tpu.ops.flex import gather_neighbors


def group_point(points, idx):
    """points [B, N, C], idx [B, M, S] int -> [B, M, S, C]
    (`tf_grouping_g.cu:94-111`)."""
    return gather_neighbors(points, idx)


def _pairwise_dist(xyz2, xyz1):
    """Euclidean distances d[b, m, n] = |xyz2[m] - xyz1[n]|, clamped at 1e-20
    like the CUDA kernels (`tf_grouping_g.cu:26`)."""
    qn = jnp.einsum("bmd,bnd->bmn", xyz2, xyz1,
                    precision="highest", preferred_element_type=jnp.float32)
    q2 = jnp.sum(xyz2 * xyz2, axis=-1)[:, :, None]
    n2 = jnp.sum(xyz1 * xyz1, axis=-1)[:, None, :]
    return jnp.maximum(jnp.sqrt(jnp.maximum(q2 - 2 * qn + n2, 0.0)), 1e-20)


def _first_inside(inside, nsample, fallback):
    """Vectorized 'first nsample true entries, in index order'.

    inside: [B, M, N] bool; fallback: [B, M] index used when a row has no
    true entry.  Returns (idx [B, M, nsample] int32, cnt [B, M] int32) with
    the reference's fill rules: slots beyond cnt hold the first hit
    (`tf_grouping_g.cu:29-34`), rows with cnt==0 hold `fallback`
    (`tf_grouping_g.cu:44-48`).
    """
    B, M, N = inside.shape
    rank = jnp.cumsum(inside, axis=-1) - inside.astype(jnp.int32)  # [B,M,N]
    cnt = jnp.sum(inside, axis=-1).astype(jnp.int32)  # [B,M]
    take = inside & (rank < nsample)
    # scatter point-index n into slot rank[n]
    slot = jnp.where(take, rank, nsample)  # overflow slot
    cols = jax.lax.broadcasted_iota(jnp.int32, (B, M, N), 2)
    out = jnp.full((B, M, nsample + 1), -1, jnp.int32)
    out = jax.vmap(jax.vmap(lambda o, s, c: o.at[s].set(c)))(out, slot, cols)
    out = out[..., :nsample]
    first = out[..., :1]
    filled = jnp.where(out < 0, jnp.broadcast_to(first, out.shape), out)
    filled = jnp.where(
        (cnt == 0)[..., None], fallback[..., None].astype(jnp.int32), filled
    )
    return filled, cnt


def query_ball_point(radius, nsample, xyz1, xyz2):
    """First `nsample` points of xyz1 within `radius` of each xyz2 query.

    xyz1 [B, N, 3] points, xyz2 [B, M, 3] queries ->
    (idx [B, M, nsample] int32, pts_cnt [B, M] int32).
    """
    d = _pairwise_dist(xyz2, xyz1)  # [B,M,N]
    nearest = jnp.argmin(d, axis=-1)
    return _first_inside(d < radius, nsample, nearest)


def query_ball_point2(nsample, xyz1, xyz2, radii):
    """Per-query-radius ball query (`tf_grouping_g.cu:56-90`).

    radii: [B, M].  No nearest-point fallback in the reference; empty rows
    keep the fill value of the first (here: index 0 via fallback=0 is NOT
    applied — the CUDA kernel leaves idx untouched, i.e. undefined; we emit 0).
    """
    d = _pairwise_dist(xyz2, xyz1)
    zeros = jnp.zeros(d.shape[:2], jnp.int32)
    return _first_inside(d < radii[..., None], nsample, zeros)


def select_top_k(k, dist):
    """Ascending top-k of a [B, M, N] distance matrix ->
    (dists [B, M, k], idx [B, M, k] int32), `tf_grouping_g.cu:137-177` /
    `tf_grouping.py:62-76`."""
    neg, idx = jax.lax.top_k(-dist, k)
    return -neg, idx.astype(jnp.int32)


def knn_point(k, xyz1, xyz2):
    """k nearest points of xyz1 for each query of xyz2, by squared L2
    (`tf_grouping.py:78-88`). Returns (dists [B,M,k], idx [B,M,k])."""
    qn = jnp.einsum("bmd,bnd->bmn", xyz2, xyz1,
                    precision="highest", preferred_element_type=jnp.float32)
    q2 = jnp.sum(xyz2 * xyz2, axis=-1)[:, :, None]
    n2 = jnp.sum(xyz1 * xyz1, axis=-1)[:, None, :]
    d2 = jnp.maximum(q2 - 2 * qn + n2, 0.0)
    return select_top_k(k, d2)
