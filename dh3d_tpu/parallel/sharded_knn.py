"""Point-axis-sharded kNN — the sequence-parallel analog for huge clouds.

The reference's "long context" axis is the cloud size N: its GPU knn op
caps at 8192 and falls back to host sklearn (`core/model.py:38,84-96`).
The chunked kNN removes the cap on one card; for clouds too large even
for that (memory or latency), this shards the POINT axis across the mesh:
each device holds a query shard, all-gathers the (small, 3-D) coordinates,
and runs the local exact kNN — returning globally-indexed
neighborhoods, still one jit region.  This is the only place anything
CP/ring-like enters this model family (SURVEY.md §5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dh3d_tpu.ops.knn import _chunk_topk


def knn_sharded(positions, k, mesh: Mesh, axis: str = "data"):
    """kNN with the point axis sharded over `axis`.

    positions: [B, N, 3] (global view; will be sharded [B, N/devices, 3]
    per device).  Returns (idx [B, N, k] int32 GLOBAL indices,
    dist [B, N, k]), identical to `ops.knn_bruteforce`.
    """
    n_dev = mesh.shape[axis]
    B, N, D = positions.shape
    if N % n_dev:
        raise ValueError(f"N={N} must divide across {n_dev} devices")
    local_n = N // n_dev

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(None, axis, None),
        out_specs=(P(None, axis, None), P(None, axis, None)),
    )
    def _local(pos_local):
        # coordinates are tiny (N*12 bytes) — one all-gather gives
        # every device the full key set
        keys = jax.lax.all_gather(pos_local, axis, axis=1, tiled=True)
        offset = jax.lax.axis_index(axis) * local_n
        idx, d2 = _chunk_topk(keys, pos_local, k, self_start=offset)
        return idx, jnp.sqrt(d2)

    pos_sharded = jax.device_put(
        positions, NamedSharding(mesh, P(None, axis, None))
    )
    return _local(pos_sharded)
