"""Device-mesh utilities for data-parallel training.

The reference has no distributed backend at all (SURVEY.md §2.3 — single
GPU `SimpleTrainer`, `train.py:75`).  Parallelism here: a 1-D `data` mesh
(the cards of one host are joined all to all, so the mesh follows the
algorithm alone), batch (the tuple-flattened cloud axis) sharded across
it, parameters replicated.  The train step is an ordinary `jax.jit` with
sharding annotations — XLA inserts the gradient all-reduce and the
cross-device BatchNorm reductions (global-view semantics), so batch-norm
is sync-BN across the mesh for free.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_parallel_mesh(n_devices: int | None = None) -> Mesh:
    """1-D data-parallel mesh over the first `n_devices` devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices, have {len(devices)}"
        )
    return Mesh(np.array(devices[:n_devices]), axis_names=("data",))


def _batch_axes(mesh: Mesh):
    """The mesh axes the batch shards over: every axis (product DP)."""
    return tuple(mesh.axis_names)


def shard_batch_spec(mesh: Mesh) -> NamedSharding:
    """Leading (cloud) axis sharded across all mesh axes (product DP)."""
    return NamedSharding(mesh, P(_batch_axes(mesh)))


def replicate_spec(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch):
    """Device-put a batch pytree: arrays whose leading axis divides the mesh
    are sharded on 'data'; the rest (e.g. the per-anchor R matrices, which
    have half the cloud count) are replicated — XLA re-shards them as needed
    inside the jitted step.

    A *whole batch* that cannot shard (no leaf's leading axis divisible by
    the mesh) silently loses all DP speedup, so that case warns loudly:
    pick batch sizes (x tuple fan-out) divisible by the mesh size.
    """
    import warnings

    n = int(np.prod([mesh.shape[a] for a in _batch_axes(mesh)]))
    sharded = shard_batch_spec(mesh)
    replicated = replicate_spec(mesh)

    def divisible(x):
        return x.ndim > 0 and x.shape[0] % n == 0

    if n > 1 and not any(map(divisible, jax.tree_util.tree_leaves(batch))):
        shapes = [tuple(x.shape)
                  for x in jax.tree_util.tree_leaves(batch)]
        warnings.warn(
            f"shard_batch: no array in the batch has a leading axis "
            f"divisible by the {n}-device mesh (shapes {shapes}); the whole "
            f"batch is REPLICATED and every device does the full-batch "
            f"work. Choose batch_size*tuple_size divisible by {n}.",
            stacklevel=2,
        )

    def put(x):
        spec = sharded if divisible(x) else replicated
        return jax.device_put(x, spec)

    return jax.tree_util.tree_map(put, batch)


def replicate(mesh: Mesh, tree):
    spec = replicate_spec(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, spec), tree)
