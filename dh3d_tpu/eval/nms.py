"""Keypoint non-maximum suppression.

`single_nms` replicates the reference host NMS exactly
(`core/utils.py:15-43`): 50-NN neighborhoods (a KD-tree here, a ball tree
there — same exact neighbours), noise removal (8th neighbor farther than
2 m -> zero attention), radius suppression, response ratio threshold,
top-k by attention.  `device_nms` is the device equivalent built on the
knn op — same rules, one jitted call, no host round trip.
"""

from __future__ import annotations

import numpy as np


def single_nms(xyz, attention, nms_radius, min_response_ratio, max_keypoints,
               remove_noise=True):
    """Host NMS, exact parity with `core/utils.py:15-43`.

    Returns (num_keypoints, max_indices list) — indices ordered by
    descending attention.
    """
    from scipy.spatial import cKDTree

    attention = np.array(attention, copy=True)
    k = min(50, len(xyz))
    # a list of ranks keeps the [N, k] shape at k == 1
    distances, indices = cKDTree(xyz).query(xyz, k=list(range(1, k + 1)))
    if remove_noise:
        invalid = distances[:, min(7, k - 1)] > 2.0
        attention[invalid] = 0.0

    knn_attention = attention[indices]
    knn_attention[distances > nms_radius] = 0.0
    is_max = np.where(np.argmax(knn_attention, axis=1) == 0)[0]

    thresh = np.max(attention) * min_response_ratio
    is_max_attention = sorted(
        [(attention[m], m) for m in is_max if attention[m] > thresh],
        reverse=True,
    )
    max_indices = [m[1] for m in is_max_attention][:max_keypoints]
    return len(max_indices), max_indices


def device_nms(xyz, attention, nms_radius, min_response_ratio, max_keypoints,
               remove_noise=True):
    """Same suppression rules as `single_nms`, computed on device.

    xyz: [N, 3]; attention: [N].  Returns (num_keypoints,
    indices [max_keypoints] int32 padded with -1) — descending attention.
    """
    import jax.numpy as jnp

    from dh3d_tpu import ops

    xyz = jnp.asarray(xyz)[None]
    att = jnp.asarray(attention).reshape(-1)
    k = min(50, xyz.shape[1])
    idx, dist = ops.knn_bruteforce(xyz, k)
    idx, dist = idx[0], dist[0]

    if remove_noise:
        att = jnp.where(dist[:, min(7, k - 1)] > 2.0, 0.0, att)

    knn_att = att[idx]
    knn_att = jnp.where(dist > nms_radius, 0.0, knn_att)
    is_max = jnp.argmax(knn_att, axis=1) == 0

    thresh = jnp.max(att) * min_response_ratio
    keep = is_max & (att > thresh)
    score = jnp.where(keep, att, -jnp.inf)
    # Host parity: `sorted([(att, idx)], reverse=True)` orders ties in
    # attention by DESCENDING index (tuple comparison under reverse=True),
    # so the secondary lexsort key is the negated index.
    n = score.shape[0]
    order = jnp.lexsort((-jnp.arange(n), -score))[:max_keypoints]
    top_att = score[order]
    valid = top_att > -jnp.inf
    n_kp = int(jnp.sum(valid))
    order = jnp.where(valid, order, -1)
    return n_kp, np.asarray(order)


def nms_keypoint_indices(xyz, attention, nms_radius, min_response_ratio,
                         max_keypoints, remove_noise=True, backend="device",
                         parity_check=False):
    """Unified NMS entry point for the extraction drivers.

    backend='device' (default) runs the device knn suppression;
    'host' runs the reference-parity host path.  `parity_check=True`
    runs both and asserts they select the same keypoints (ties in float
    attention aside) — used in tests and for one-off validation runs.

    Returns a plain list of keypoint indices, descending attention.
    """
    if backend == "device":
        _, order = device_nms(xyz, attention, nms_radius,
                              min_response_ratio, max_keypoints,
                              remove_noise=remove_noise)
        idx = [int(i) for i in order if i >= 0]
    elif backend == "host":
        _, idx = single_nms(xyz, attention, nms_radius, min_response_ratio,
                            max_keypoints, remove_noise=remove_noise)
    else:
        raise ValueError(f"unknown NMS backend '{backend}'")
    if parity_check:
        _, host_idx = single_nms(xyz, attention, nms_radius,
                                 min_response_ratio, max_keypoints,
                                 remove_noise=remove_noise)
        assert list(idx) == list(host_idx), (
            f"device/host NMS mismatch: {idx[:8]}... vs {host_idx[:8]}..."
        )
    return idx
