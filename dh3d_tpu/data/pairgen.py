"""On-device local-pair generation.

Device replacement for the host hot loop of the local self-pair
sampler (`core/datasets.py:126-151`): the random 1-D z-rotation, the
FPS anchor-node sampling over a random half subset, and the 1-NN
correspondence search all run *inside the jitted train step* (FPS via
`ops.farthest_point_sample`, 1-NN via the knn op), so the host only
loads + fixed-size-normalizes clouds and the pair-generation cost rides
the accelerator instead of serializing with it.

Semantics per reference:
  rotation   `core/datasets.py:134-140`  angle ~ U(-rot_maxv, rot_maxv)
  subset     `core/datasets.py:145`      N/2 points drawn without replacement
  anchors    `core/datasets.py:146-147`  FPS(sample_nodes) over the subset
  positives  `core/datasets.py:148-150`  1-NN of pc1[anc] in the UNROTATED pc2
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from dh3d_tpu import ops


def rotation_z(angle):
    """[...]-shaped angles -> [..., 3, 3] z-rotations matching the
    reference matrix layout (`core/datasets.py:136-139`: row-vector
    convention, pc2_t = pc2 @ R)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    z, o = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack([
        jnp.stack([c, s, z], axis=-1),
        jnp.stack([-s, c, z], axis=-1),
        jnp.stack([z, z, o], axis=-1),
    ], axis=-2)


def device_local_pairs(key, pc1, pc2, sample_nodes, rot_maxv=math.pi):
    """Build the local-training batch fields on device.

    Args:
      key: PRNG key (one per step; split internally).
      pc1, pc2: [B, N, 3] — two independent augmentations of the same
        clouds, both UNROTATED (the loader's `raw_batches` output).
      sample_nodes: number of anchor keypoints (cfg.sampled_kpnum).
      rot_maxv: rotation angle bound.

    Returns a dict in the trainer's batch contract:
      points [2B, N, 3] (anchors | rotated positives),
      sample_inds [2B, M] (anchor ids | 1-NN correspondence ids),
      R [B, 3, 3].
    """
    B, N, _ = pc1.shape
    k_ang, k_sub = jax.random.split(key)

    ang = jax.random.uniform(k_ang, (B,), minval=-rot_maxv, maxval=rot_maxv)
    rot = rotation_z(ang)
    pc2_t = jnp.einsum("bnd,bde->bne", pc2, rot, precision="highest")

    # random half-subset per cloud; FPS seeds at the subset's first entry,
    # which the permutation makes uniformly random — the device twin of the
    # host sampler's random FPS seed.
    subs = jax.vmap(
        lambda k: jax.random.permutation(k, N)[: N // 2]
    )(jax.random.split(k_sub, B)).astype(jnp.int32)  # [B, N/2]
    sub_pts = ops.gather_point(pc1, subs)
    fps_idx = ops.farthest_point_sample(sub_pts, sample_nodes)  # [B, M]
    anc_inds = jnp.take_along_axis(subs, fps_idx, axis=1)

    anc_xyz = ops.gather_point(pc1, anc_inds)
    pos_inds, _ = ops.knn_bruteforce_pairwise(anc_xyz, pc2, 1)
    pos_inds = pos_inds[..., 0].astype(jnp.int32)

    return {
        "points": jnp.concatenate([pc1, pc2_t], axis=0),
        "sample_inds": jnp.concatenate([anc_inds, pos_inds], axis=0),
        "R": rot.astype(jnp.float32),
    }
