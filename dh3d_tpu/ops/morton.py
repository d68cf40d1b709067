"""Morton (Z-order) sort of point clouds.

Sorting each cloud along the space-filling curve puts spatial neighbours
at nearby indices.  `cfg.morton_order` runs the whole forward in this
order (nn/model.py); `data/io.morton_sort_np` is the host twin used by a
presorting loader (`cfg.morton_presorted`).
"""

from __future__ import annotations

import jax.numpy as jnp


def morton_codes(points, bits=10):
    """[B, N, 3] -> [B, N] uint32 Z-order codes (bits per axis <= 10;
    the 30-bit code fits uint32, so this works with x64 disabled)."""
    if bits > 10:
        raise ValueError(f"bits={bits}: a 3-axis code must fit 32 bits")
    lo = jnp.min(points, axis=1, keepdims=True)
    hi = jnp.max(points, axis=1, keepdims=True)
    scale = (2 ** bits - 1) / jnp.maximum(hi - lo, 1e-9)
    q = jnp.clip((points - lo) * scale, 0, 2 ** bits - 1).astype(jnp.uint32)

    def spread(x):  # classic 10-bit -> 30-bit interleave in 32 bits
        x = x & jnp.uint32(0x3FF)
        x = (x | (x << 16)) & jnp.uint32(0x30000FF)
        x = (x | (x << 8)) & jnp.uint32(0x300F00F)
        x = (x | (x << 4)) & jnp.uint32(0x30C30C3)
        x = (x | (x << 2)) & jnp.uint32(0x9249249)
        return x

    return (spread(q[..., 0]) | (spread(q[..., 1]) << jnp.uint32(1))
            | (spread(q[..., 2]) << jnp.uint32(2)))


def morton_perm(points, bits=10):
    """Permutation sorting each cloud along the Z-order curve.
    Returns (perm [B, N] int32, inv_perm [B, N] int32):
    sorted = x[perm]; original = sorted[inv_perm]."""
    code = morton_codes(points, bits)
    perm = jnp.argsort(code, axis=1).astype(jnp.int32)
    B, N = perm.shape
    inv = jnp.zeros_like(perm)
    inv = inv.at[jnp.arange(B)[:, None], perm].set(
        jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (B, N)))
    return perm, inv
