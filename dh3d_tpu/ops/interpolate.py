"""Three-nearest-neighbor interpolation.

Ground-truth semantics: `tf_ops/interpolation/tf_interpolate.cpp` —
  three_nn           `:60-103` (3 nearest by *squared* L2; dist is squared)
  three_interpolate  `:107-127` (weighted 3-point gather)

The reference registers these CPU-only (no .cu file), forcing a
device->host->device round trip mid-graph (`core/backbones.py:91-96`).
Here they are ordinary XLA ops: one matmul distance + top_k, and a gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def three_nn(xyz1, xyz2):
    """3 nearest points of xyz2 for every point of xyz1.

    xyz1: [B, N, 3] queries (full-resolution points);
    xyz2: [B, M, 3] known points (subsampled set).
    Returns (dist [B, N, 3] SQUARED distances, idx [B, N, 3] int32),
    ascending — matching `tf_interpolate.cpp:72` (d = squared L2, no sqrt).
    """
    qn = jnp.einsum("bnd,bmd->bnm", xyz1, xyz2,
                    precision="highest", preferred_element_type=jnp.float32)
    q2 = jnp.sum(xyz1 * xyz1, axis=-1)[:, :, None]
    m2 = jnp.sum(xyz2 * xyz2, axis=-1)[:, None, :]
    d2 = jnp.maximum(q2 - 2 * qn + m2, 0.0)
    neg, idx = jax.lax.top_k(-d2, 3)
    return -neg, idx.astype(jnp.int32)


def three_interpolate(points, idx, weight):
    """Weighted interpolation of 3 neighbors (`tf_interpolate.cpp:107-127`).

    points: [B, M, C] features of known points; idx/weight: [B, N, 3].
    Returns [B, N, C]: out[n] = sum_j weight[n,j] * points[idx[n,j]].
    """
    gathered = jax.vmap(lambda p, i: p[i])(points, idx)  # [B,N,3,C]
    return jnp.einsum("bnj,bnjc->bnc", weight, gathered,
                      precision="highest", preferred_element_type=jnp.float32)


def inverse_distance_weights(dist, eps=1e-10):
    """The upsampling weight rule of `core/backbones.py:91-95`:
    w_j = (1/d_j) / sum_j (1/d_j), with d clamped below at `eps`."""
    d = jnp.maximum(dist, eps)
    inv = 1.0 / d
    return inv / jnp.sum(inv, axis=-1, keepdims=True)
