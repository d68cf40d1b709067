"""Loss functions, faithful ports of `core/losses.py` (channel-last).

All four reference losses:
  desc_local_loss          `core/losses.py:29-62`   (N-tuple contrastive)
  local_detection_loss_nn  `core/losses.py:65-133`  (unsupervised detector)
  lazy_triplet_loss        `core/losses.py:147-170` (PointNetVLAD)
  lazy_quadruplet_loss     `core/losses.py:173-200`

Dict-key contract matches the model's `outs` dict; losses are selected by
name via the registry at the bottom (reference dispatches with getattr,
`core/model.py:217,224,231`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dh3d_tpu import ops


def pairwise_dist(a, b):
    """Squared-L2 pairwise distances (`core/tf_utils.py:125-136`).
    a [B,M,D], b [B,N,D] -> [B,M,N]."""
    # explicit difference form: no matmul-identity cancellation — used for
    # GEOMETRY (D=3), where absolute coordinates are large vs the
    # distances of interest and the broadcast is cheap.
    diff = a[:, :, None, :] - b[:, None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def pairwise_dist_matmul(a, b):
    """Squared-L2 via the matmul identity a^2 - 2ab + b^2 — the form the
    reference actually computes (`core/tf_utils.py:125-136`).  Used for
    DESCRIPTOR distances (D=128, values O(1)): the identity's
    cancellation error is ~1e-6 at highest precision, and the [M,D]x[D,N]
    matmul replaces a [B,M,N,D] broadcast."""
    ab = jnp.einsum("bmd,bnd->bmn", a, b, precision="highest",
                    preferred_element_type=jnp.float32)
    a2 = jnp.sum(a * a, axis=-1)[:, :, None]
    b2 = jnp.sum(b * b, axis=-1)[:, None, :]
    return jnp.maximum(a2 - 2.0 * ab + b2, 0.0)


def pairwise_dist_cosine(a, b, isl2norm=True):
    """Cosine similarity matrix (`core/tf_utils.py:112-123`): matmul
    clipped to [-1, 1].  The reference's `isl2norm` parameter is accepted
    and ignored, exactly as upstream (the function assumes pre-normalized
    inputs either way).  a [B,M,D], b [B,N,D] -> [B,M,N]."""
    del isl2norm  # unused in the reference too
    sim = jnp.einsum("bmd,bnd->bmn", a, b, precision="highest",
                     preferred_element_type=jnp.float32)
    return jnp.clip(sim, -1.0, 1.0)


def desc_local_loss(outs, pos_r=0.5, search_r=20.0, margin=0.8,
                    neg_weight=5.0, **unused):
    """N-tuple contrastive loss over sampled correspondences
    (`core/losses.py:29-62`).

    Positives: warped-anchor/pos keypoint pairs closer than pos_r;
    negatives: pairs in (2*pos_r, search_r).  Positive pulls descriptor
    distance down; negative hinge relu(margin - d), weighted `neg_weight`.
    Returns (loss, aux dict with pos_loss/neg_loss/num_pos/num_neg).
    """
    xyz0, xyz1 = jnp.split(outs["xyz_sampled"], 2, axis=0)
    feat0, feat1 = jnp.split(outs["feat_sampled"], 2, axis=0)
    rot = outs["R"]

    xyz0_warp = jnp.einsum("bmd,bde->bme", xyz0, rot, precision="highest")
    xyzdist = jnp.sqrt(pairwise_dist(xyz0_warp, xyz1) + 1e-10)
    is_neg = ((xyzdist > pos_r * 2) & (xyzdist < search_r)).astype(jnp.float32)
    is_pos = (xyzdist < pos_r).astype(jnp.float32)

    feat_dist = jnp.sqrt(pairwise_dist_matmul(feat0, feat1) + 1e-10)
    num_pos = jnp.sum(is_pos)
    num_neg = jnp.sum(is_neg)

    pos_loss = jnp.sum(is_pos * feat_dist) / (num_pos + 1e-10)
    neg_loss = neg_weight * (
        jnp.sum(is_neg * jax.nn.relu(margin - feat_dist)) / (num_neg + 1e-10)
    )
    loss = pos_loss + neg_loss
    return loss, {
        "pos_loss": pos_loss,
        "neg_loss": neg_loss,
        "num_pos": num_pos,
        "num_neg": num_neg,
    }


def local_detection_loss_nn(outs, ar_th=0.3, det_k=16, ar_nn_k=5, pos_r=0.3,
                            use_hardest_neg=True,
                            reproduce_ref_detloss_bug=False, **unused):
    """Unsupervised keypoint detector loss (`core/losses.py:65-133`).

    For each anchor keypoint: take the det_k-neighborhood of its
    correspondent in the positive cloud (plus, optionally, the neighborhood
    of the hardest negative keypoint), rank those candidates by descriptor
    distance, and measure the normalized rank (AR) of the first true match
    within pos_r.  Loss drives the per-keypoint score toward predicting AR:
    1 - (AR*s + ar_th*(1-s)).

    The reference computes knn for ALL N pos-cloud points
    (`core/losses.py:74`) but only ever reads the rows at the M sampled
    keypoints and their M hardest negatives; here those <= 2M rows are
    queried directly (exact pairwise kNN of the keypoints against the
    full cloud) — same candidate sets, ~N/(2M) less kNN work, and exact
    under every model mode including Morton.

    Note the reference quirk kept here: candidate features come from the
    UN-normalized dense map `feat`, while the query keypoint descriptor
    `feat_sampled` is l2-normalized (`core/losses.py:67,72,112`).
    """
    xyz0, xyz1 = jnp.split(outs["xyz"], 2, axis=0)
    feat0, feat1 = jnp.split(outs["feat"], 2, axis=0)
    s_ind = outs["sample_nodes_concat"]
    s_ind = s_ind.reshape(s_ind.shape[0], -1)
    sample_ind0, sample_ind1 = jnp.split(s_ind, 2, axis=0)

    score0, _ = jnp.split(outs["att_sampled"], 2, axis=0)  # [B,M]
    xyz_s0, xyz_s1 = jnp.split(outs["xyz_sampled"], 2, axis=0)
    feat_s0, feat_s1 = jnp.split(outs["feat_sampled"], 2, axis=0)
    rot = outs["R"]

    xyz0_warp = jnp.einsum("bmd,bde->bme", xyz_s0, rot, precision="highest")

    # neighborhoods of the positive correspondents (`core/losses.py:81-84`)
    # — exact kNN rows queried at the keypoints only (xyz_s1 IS xyz1
    # gathered at sample_ind1)
    knn_sampled1, _ = ops.knn_bruteforce_pairwise(
        xyz_s1, xyz1, det_k)  # [B,M,det_k]

    if use_hardest_neg:
        # hardest negative among pos-cloud keypoints (`core/losses.py:87-99`)
        xyz_dist_all = jnp.sqrt(pairwise_dist(xyz0_warp, xyz_s1) + 1e-10)
        is_neg = (xyz_dist_all > 1.0).astype(jnp.float32)
        feat_dist_all = jnp.sqrt(
            pairwise_dist_matmul(feat_s0, feat_s1) + 1e-10)
        neg_dist = feat_dist_all + (1.0 - is_neg) * 100.0
        hardest = jnp.argmin(neg_dist, axis=2)  # [B,M]
        # INTENTIONAL DIVERGENCE from the reference: `core/losses.py:94-98`
        # gathers knn rows at the raw keypoint *slot* index (0..M-1), i.e.
        # the neighborhood of an unrelated low-id cloud point — a reference
        # bug.  We map keypoint id -> cloud point id via sample_ind1 first,
        # so the gathered neighborhood is actually the hardest negative's.
        # See PARITY.md "detection loss hardest-negative gather".
        # `reproduce_ref_detloss_bug=True` (cfg flag) switches to a faithful
        # reproduction of the reference gather — the det_k-neighborhood of
        # cloud point id == the keypoint SLOT index — for strict-parity
        # fidelity A/B runs without code edits.
        if reproduce_ref_detloss_bug:
            hardest_kp = hardest  # slot index used as a cloud point id
        else:
            hardest_kp = jnp.take_along_axis(
                sample_ind1, hardest, axis=1
            )  # keypoint id -> cloud point id
        xyz_neg1 = jnp.take_along_axis(xyz1, hardest_kp[..., None], axis=1)
        knn_neg1, _ = ops.knn_bruteforce_pairwise(xyz_neg1, xyz1, det_k)
        knn_sampled1 = jnp.concatenate([knn_sampled1, knn_neg1], axis=-1)

    # gather candidate xyz/features (`core/losses.py:103-106`)
    sampled_xyz1 = ops.group_point(xyz1, knn_sampled1)  # [B,M,K2,3]
    sampled_feat1 = ops.group_point(feat1, knn_sampled1)  # [B,M,K2,D]

    matching_xyz_dist = jnp.sqrt(
        jnp.sum((xyz0_warp[:, :, None, :] - sampled_xyz1) ** 2, axis=-1)
    )  # [B,M,K2]
    matching_feat_dist = jnp.sum(
        (feat_s0[:, :, None, :] - sampled_feat1) ** 2, axis=-1
    )  # [B,M,K2]

    # top-ar_nn_k best feature matches (`core/losses.py:114`)
    _, idx_k = jax.lax.top_k(-matching_feat_dist, ar_nn_k)
    xyzdist_sel = jnp.take_along_axis(matching_xyz_dist, idx_k, axis=-1)

    is_good = (xyzdist_sel <= pos_r).astype(jnp.float32)
    pad = jnp.ones(is_good.shape[:2] + (1,), jnp.float32)
    is_good = jnp.concatenate([is_good, pad], axis=-1)
    first = jnp.argmax(is_good, axis=-1).astype(jnp.float32)

    ar = (first + 1e-8) / ar_nn_k  # 0 = best
    matchingloss = 1.0 - (ar * score0 + ar_th * (1.0 - score0))
    det_loss = jnp.mean(matchingloss)
    return det_loss, {"det_loss": det_loss, "mean_ar": jnp.mean(ar)}


def best_pos_distance(query, pos_vecs):
    """Min squared distance to the positives (`core/losses.py:137-144`).
    query [B,1,D], pos_vecs [B,P,D] -> [B]."""
    return jnp.min(jnp.sum((pos_vecs - query) ** 2, axis=2), axis=1)


def _lazy_triplet_impl(q_vec, pos_vecs, neg_vecs, margin):
    """`core/losses.py:147-160`: max-over-negatives hinge vs best positive."""
    best_pos = best_pos_distance(q_vec, pos_vecs)  # [B]
    neg_d = jnp.sum((neg_vecs - q_vec) ** 2, axis=2)  # [B,Nn]
    hinge = jax.nn.relu(margin + best_pos[:, None] - neg_d)
    return jnp.mean(jnp.max(hinge, axis=1))


def _split_tuple(global_descs, batch_size, num_pos, num_neg, other_neg):
    d = global_descs.shape[-1]
    sizes = [batch_size, num_pos * batch_size, num_neg * batch_size]
    if other_neg:
        sizes.append(batch_size)
    # split points must be static Python ints (jit-traceable)
    cuts = [sum(sizes[: i + 1]) for i in range(len(sizes) - 1)]
    splits = jnp.split(global_descs, cuts, 0)
    q = splits[0].reshape(batch_size, 1, d)
    pos = splits[1].reshape(batch_size, num_pos, d)
    neg = splits[2].reshape(batch_size, num_neg, d)
    oneg = splits[3].reshape(batch_size, 1, d) if other_neg else None
    return q, pos, neg, oneg


def lazy_triplet_loss(global_descs, batch_size, num_pos, num_neg,
                      global_triplet_margin=0.5, **unused):
    """`core/losses.py:163-170`."""
    q, pos, neg, _ = _split_tuple(global_descs, batch_size, num_pos, num_neg,
                                  other_neg=False)
    loss = _lazy_triplet_impl(q, pos, neg, global_triplet_margin)
    return loss, {"triplet_loss": loss}


def lazy_quadruplet_loss(global_descs, batch_size, num_pos, num_neg,
                         global_triplet_margin=0.5,
                         global_quadruplet_margin=0.2, **unused):
    """`core/losses.py:173-200`: triplet + second hinge of negatives vs the
    'other negative' cloud."""
    q, pos, neg, oneg = _split_tuple(global_descs, batch_size, num_pos,
                                     num_neg, other_neg=True)
    trip = _lazy_triplet_impl(q, pos, neg, global_triplet_margin)
    best_pos = best_pos_distance(q, pos)
    neg_to_othneg = jnp.sum((neg - oneg) ** 2, axis=2)  # [B,Nn]
    hinge2 = jax.nn.relu(
        global_quadruplet_margin + best_pos[:, None] - neg_to_othneg
    )
    second = jnp.mean(jnp.max(hinge2, axis=1))
    total = trip + second
    return total, {"triplet_loss": trip, "second_loss": second}


def _global_neg_pool(neg, axis_name=None):
    """Flatten all negative clouds in the batch into one pool [B*Nn, D].

    With `axis_name` bound (shard_map trainer), the pool is all-gathered
    across the mesh axis so every device mines against the full
    global-batch pool.  Under the global-view jit trainer the input already
    IS the global batch (XLA inserts the collectives), so axis_name stays
    None.
    """
    d = neg.shape[-1]
    pool = neg.reshape(-1, d)
    if axis_name is not None:
        pool = jax.lax.all_gather(pool, axis_name).reshape(-1, d)
    return pool


def batch_hard_triplet_loss(global_descs, batch_size, num_pos, num_neg,
                            global_triplet_margin=0.5, axis_name=None,
                            **unused):
    """Batch-hard N-tuple mining (BASELINE.json north star; greenfield —
    the reference's lazy losses mine only within the tuple,
    `core/losses.py:147-170`).

    Every query's negative pool is the union of ALL tuples' negative clouds
    in the global batch; the hinge takes the hardest (max-violation) one.
    Identical in expectation to lazy_triplet when B=1; strictly harder
    otherwise.  Negatives of other tuples are valid negatives with high
    probability (they were sampled outside their own query's non-negative
    set, and Oxford submaps are sparse in UTM space) — the standard
    batch-hard relaxation.
    """
    q, pos, neg, _ = _split_tuple(global_descs, batch_size, num_pos, num_neg,
                                  other_neg=False)
    pool = _global_neg_pool(neg, axis_name)  # [B*Nn(*mesh), D]
    best_pos = best_pos_distance(q, pos)  # [B]
    neg_d = jnp.sum((pool[None, :, :] - q) ** 2, axis=2)  # [B, pool]
    hinge = jax.nn.relu(global_triplet_margin + best_pos[:, None] - neg_d)
    loss = jnp.mean(jnp.max(hinge, axis=1))
    return loss, {
        "triplet_loss": loss,
        "hardest_neg_dist": jnp.mean(jnp.min(neg_d, axis=1)),
    }


def batch_hard_quadruplet_loss(global_descs, batch_size, num_pos, num_neg,
                               global_triplet_margin=0.5,
                               global_quadruplet_margin=0.2, axis_name=None,
                               **unused):
    """Quadruplet variant of `batch_hard_triplet_loss`: second hinge
    compares the global negative pool to each tuple's 'other negative'
    (structure of `core/losses.py:173-200`, pool widened across the batch
    and, with axis_name, across the mesh)."""
    q, pos, neg, oneg = _split_tuple(global_descs, batch_size, num_pos,
                                     num_neg, other_neg=True)
    pool = _global_neg_pool(neg, axis_name)
    best_pos = best_pos_distance(q, pos)
    neg_d = jnp.sum((pool[None, :, :] - q) ** 2, axis=2)
    hinge = jax.nn.relu(global_triplet_margin + best_pos[:, None] - neg_d)
    trip = jnp.mean(jnp.max(hinge, axis=1))

    neg_to_othneg = jnp.sum((pool[None, :, :] - oneg) ** 2, axis=2)
    hinge2 = jax.nn.relu(
        global_quadruplet_margin + best_pos[:, None] - neg_to_othneg
    )
    second = jnp.mean(jnp.max(hinge2, axis=1))
    total = trip + second
    return total, {
        "triplet_loss": trip,
        "second_loss": second,
        "hardest_neg_dist": jnp.mean(jnp.min(neg_d, axis=1)),
    }


LOCAL_LOSSES = {"desc_local_loss": desc_local_loss}
DETECTION_LOSSES = {"local_detection_loss_nn": local_detection_loss_nn}
GLOBAL_LOSSES = {
    "lazy_triplet_loss": lazy_triplet_loss,
    "lazy_quadruplet_loss": lazy_quadruplet_loss,
    "batch_hard_triplet_loss": batch_hard_triplet_loss,
    "batch_hard_quadruplet_loss": batch_hard_quadruplet_loss,
}
# cfg.cross_device_mining upgrades the lazy losses to their batch-hard
# global-pool twins (same tuple layout, widened negative pool)
BATCH_HARD_UPGRADE = {
    "lazy_triplet_loss": "batch_hard_triplet_loss",
    "lazy_quadruplet_loss": "batch_hard_quadruplet_loss",
}


def compute_total_loss(outs, cfg, params_l2=0.0):
    """Loss dispatch of `DH3D.compute_loss` (`core/model.py:212-246`).

    Returns (total_loss, metrics dict).  `params_l2` is the precomputed sum
    of squared Dense/conv kernel weights (the reference regularizes '.*/W'
    only, `core/model.py:239-241`).
    """
    total = 0.0
    metrics = {}

    def _default(v, d):
        # NOT `v or d`: an explicitly configured 0.0 (zero-weight ablation)
        # must stay 0.0; only the dotdict's silent-None falls back.
        return d if v is None else v

    if cfg.extract_global:
        loss_name = cfg.global_loss
        if cfg.cross_device_mining:
            loss_name = BATCH_HARD_UPGRADE.get(loss_name, loss_name)
        gl, aux = GLOBAL_LOSSES[loss_name](
            outs["global_desc"], cfg.batch_size, cfg.num_pos, cfg.num_neg,
            global_triplet_margin=_default(cfg.global_triplet_margin, 0.5),
            global_quadruplet_margin=_default(
                cfg.global_quadruplet_margin, 0.2),
        )
        gl = gl * _default(cfg.global_loss_weight, 1.0)
        metrics["globaldesc_loss"] = gl
        metrics.update(aux)
        total += gl

    if cfg.add_local_loss:
        ll, aux = LOCAL_LOSSES[cfg.local_loss](
            outs, pos_r=cfg.pos_r, search_r=cfg.search_r, margin=cfg.margin,
            neg_weight=cfg.neg_weight,
        )
        ll = ll * _default(cfg.local_loss_weight, 1.0)
        metrics["localdesc_loss"] = ll
        metrics.update(aux)
        total += ll

    if cfg.detection and cfg.add_det_loss:
        dl, aux = DETECTION_LOSSES[cfg.detection_loss](
            outs, ar_th=cfg.ar_th, det_k=cfg.det_k, ar_nn_k=cfg.ar_nn_k,
            pos_r=cfg.pos_r,
            reproduce_ref_detloss_bug=bool(cfg.reproduce_ref_detloss_bug),
        )
        dl = dl * _default(cfg.det_loss_weight, 1.0)
        metrics["det_loss_weighted"] = dl
        metrics.update(aux)
        total += dl

    metrics["gl_loc_loss"] = total
    if cfg.add_weight_decay:
        wd = cfg.train_weight_decay * params_l2
        metrics["wd_cost"] = wd
        total = total + wd
    metrics["total_cost"] = total
    return total, metrics
