"""Loss-value tests against hand-computed / numpy-oracle small cases.

The detection loss is the hairiest graph in the reference
(`core/losses.py:65-133`, nested gather chains + hardest-negative mining);
its oracle below is an independent numpy transcription (SURVEY.md §7).
"""

import jax
import jax.numpy as jnp
import numpy as np

from dh3d_tpu import losses
from dh3d_tpu.config import dotdict


def test_pairwise_dist():
    a = np.array([[[0.0, 0], [1, 0]]], np.float32)
    b = np.array([[[0.0, 0], [0, 2]]], np.float32)
    d = np.asarray(losses.pairwise_dist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(d[0], [[0, 4], [1, 5]], atol=1e-6)


def test_desc_local_loss_hand_case():
    # 1 batch, 2 keypoints; identity rotation.
    xyz0 = np.array([[[0.0, 0, 0], [5, 0, 0]]], np.float32)
    xyz1 = xyz0.copy()  # perfect correspondence: diag is pos (d=0 < 0.5)
    feat0 = np.array([[[1.0, 0], [0, 1]]], np.float32)
    feat1 = np.array([[[0.6, 0.8], [0, 1]]], np.float32)
    outs = {
        "xyz_sampled": jnp.concatenate([jnp.asarray(xyz0), jnp.asarray(xyz1)]),
        "feat_sampled": jnp.concatenate([jnp.asarray(feat0), jnp.asarray(feat1)]),
        "R": jnp.eye(3)[None],
    }
    loss, aux = losses.desc_local_loss(outs, pos_r=0.5, search_r=20.0,
                                       margin=1.0, neg_weight=5.0)
    # positives: (0,0) featdist = |(1,0)-(.6,.8)| = sqrt(.16+.64)=.894; (1,1) 0
    # negatives: (0,1) xyz dist 5 in (1,20): featdist=sqrt(1+0+..)= sqrt(2)
    #   -> hinge relu(1-sqrt(2))=0 ; (1,0) featdist=|(0,1)-(.6,.8)| = .632
    #   -> relu(1-.632)=.368
    pos_expect = (0.894427 + np.sqrt(1e-10)) / 2
    neg_expect = 5 * ((0.0 + (1 - 0.6324555)) / 2)
    assert abs(float(aux["num_pos"]) - 2) < 1e-6
    assert abs(float(aux["num_neg"]) - 2) < 1e-6
    np.testing.assert_allclose(float(aux["pos_loss"]), pos_expect, atol=1e-4)
    np.testing.assert_allclose(float(aux["neg_loss"]), neg_expect, atol=1e-4)
    np.testing.assert_allclose(float(loss), pos_expect + neg_expect, atol=1e-4)


def test_lazy_triplet_hand_case():
    # batch 1, 1 pos, 2 neg, dim 2
    q = np.array([[1.0, 0]], np.float32)
    pos = np.array([[0.8, 0.6]], np.float32)  # d2 = .04+.36 = .4
    negs = np.array([[0.0, 1], [1, 0]], np.float32)  # d2 = 2, 0
    gd = jnp.asarray(np.concatenate([q, pos, negs]))
    loss, _ = losses.lazy_triplet_loss(gd, batch_size=1, num_pos=1, num_neg=2,
                                       global_triplet_margin=0.5)
    # hinges: max(0, .5+.4-2)=0 ; max(0,.5+.4-0)=.9 -> max = .9
    np.testing.assert_allclose(float(loss), 0.9, atol=1e-5)


def test_lazy_quadruplet_hand_case():
    q = np.array([[1.0, 0]], np.float32)
    pos = np.array([[0.8, 0.6]], np.float32)  # best_pos = .4
    negs = np.array([[0.0, 1], [1, 0]], np.float32)
    oneg = np.array([[0.0, -1]], np.float32)
    gd = jnp.asarray(np.concatenate([q, pos, negs, oneg]))
    loss, aux = losses.lazy_quadruplet_loss(
        gd, batch_size=1, num_pos=1, num_neg=2,
        global_triplet_margin=0.5, global_quadruplet_margin=0.2,
    )
    # second: d2(neg, oneg) = [(0-0)^2+(1+1)^2, 1+1] = [4, 2]
    # hinges: max(0,.2+.4-4)=0, max(0,.2+.4-2)=0 -> 0; total = triplet = .9
    np.testing.assert_allclose(float(aux["triplet_loss"]), 0.9, atol=1e-5)
    np.testing.assert_allclose(float(aux["second_loss"]), 0.0, atol=1e-5)


def _detection_loss_oracle(outs, ar_th, det_k, ar_nn_k, pos_r):
    """Independent numpy transcription of `core/losses.py:65-133`."""
    xyz = np.asarray(outs["xyz"]); feat = np.asarray(outs["feat"])
    B2 = xyz.shape[0]; B = B2 // 2
    xyz0, xyz1 = xyz[:B], xyz[B:]
    feat0, feat1 = feat[:B], feat[B:]
    s_ind = np.asarray(outs["sample_nodes_concat"]).reshape(B2, -1)
    si0, si1 = s_ind[:B], s_ind[B:]
    score = np.asarray(outs["att_sampled"]); score0 = score[:B]
    xyz_s = np.asarray(outs["xyz_sampled"]); xyz_s0, xyz_s1 = xyz_s[:B], xyz_s[B:]
    feat_s = np.asarray(outs["feat_sampled"]); feat_s0, feat_s1 = feat_s[:B], feat_s[B:]
    rot = np.asarray(outs["R"])
    M = xyz_s0.shape[1]; N = xyz1.shape[1]

    losses_all = []
    ars = []
    for b in range(B):
        # knn of pos cloud
        d = np.sqrt(np.sum((xyz1[b][:, None] - xyz1[b][None]) ** 2, -1))
        knn1 = np.argsort(d, axis=-1, kind="stable")[:, :det_k]
        warp = xyz_s0[b] @ rot[b]
        for m in range(M):
            cand = list(knn1[si1[b, m]])
            # hardest negative
            xyzd = np.sqrt(np.sum((warp[m] - xyz_s1[b]) ** 2, -1) + 1e-10)
            featd = np.sqrt(np.sum((feat_s0[b, m] - feat_s1[b]) ** 2, -1) + 1e-10)
            negd = featd + (xyzd <= 1.0) * 100.0
            hard = int(np.argmin(negd))
            cand += list(knn1[si1[b, hard]])
            cand = np.array(cand)
            cxyz = xyz1[b][cand]; cfeat = feat1[b][cand]
            mxyz = np.sqrt(np.sum((warp[m] - cxyz) ** 2, -1))
            mfeat = np.sum((feat_s0[b, m] - cfeat) ** 2, -1)
            order = np.argsort(mfeat, kind="stable")[:ar_nn_k]
            good = mxyz[order] <= pos_r
            good = np.concatenate([good, [True]])
            first = float(np.argmax(good))
            ar = (first + 1e-8) / ar_nn_k
            ars.append(ar)
            losses_all.append(1 - (ar * score0[b, m] + ar_th * (1 - score0[b, m])))
    return float(np.mean(losses_all))


def test_detection_loss_matches_oracle(rng):
    B, N, M, D = 2, 48, 6, 8
    det_k, ar_nn_k, pos_r, ar_th = 6, 5, 0.5, 0.4
    xyz0 = rng.randn(B, N, 3).astype(np.float32) * 3
    theta = rng.randn(1) * np.pi
    # use identity rotations for the oracle simplicity? no — exercise R
    R = np.stack([_rotz(rng.uniform(-np.pi, np.pi)) for _ in range(B)]).astype(np.float32)
    xyz1 = np.einsum("bnd,bde->bne", xyz0, R) + rng.randn(B, N, 3).astype(np.float32) * 0.05
    feat = rng.randn(2 * B, N, D).astype(np.float32)
    s_ind = np.stack([rng.choice(N, 2 * M, replace=False) for _ in range(2 * B)])[:, :M].astype(np.int32)
    xyz = np.concatenate([xyz0, xyz1])
    xyz_s = np.stack([xyz[i][s_ind[i]] for i in range(2 * B)])
    featn = feat / np.linalg.norm(feat, axis=-1, keepdims=True)
    feat_s = np.stack([featn[i][s_ind[i]] for i in range(2 * B)])
    att = rng.rand(2 * B, M).astype(np.float32)
    outs = {
        "xyz": jnp.asarray(xyz), "feat": jnp.asarray(feat),
        "sample_nodes_concat": jnp.asarray(s_ind),
        "att_sampled": jnp.asarray(att),
        "xyz_sampled": jnp.asarray(xyz_s), "feat_sampled": jnp.asarray(feat_s),
        "R": jnp.asarray(R),
    }
    loss, _ = losses.local_detection_loss_nn(
        outs, ar_th=ar_th, det_k=det_k, ar_nn_k=ar_nn_k, pos_r=pos_r
    )
    expect = _detection_loss_oracle(outs, ar_th, det_k, ar_nn_k, pos_r)
    np.testing.assert_allclose(float(loss), expect, atol=1e-4)


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float64)


def test_compute_total_loss_dispatch(rng):
    cfg = dotdict(
        extract_global=True, add_local_loss=False, detection=False,
        add_det_loss=False, add_weight_decay=True, train_weight_decay=0.1,
        global_loss="lazy_triplet_loss", batch_size=1, num_pos=1, num_neg=2,
        global_triplet_margin=0.5, global_loss_weight=2.0,
    )
    gd = jnp.asarray(np.array(
        [[1.0, 0], [0.8, 0.6], [0.0, 1], [1, 0]], np.float32))
    total, metrics = losses.compute_total_loss(
        {"global_desc": gd}, cfg, params_l2=3.0)
    np.testing.assert_allclose(float(metrics["globaldesc_loss"]), 1.8, atol=1e-5)
    np.testing.assert_allclose(float(metrics["wd_cost"]), 0.3, atol=1e-6)
    np.testing.assert_allclose(float(total), 2.1, atol=1e-5)


def test_detection_loss_no_hardest_neg(rng):
    """use_hardest_neg=False branch (`core/losses.py:86`)."""
    B, Nn, M, D = 1, 32, 4, 8
    xyz = rng.randn(2 * B, Nn, 3).astype(np.float32)
    feat = rng.randn(2 * B, Nn, D).astype(np.float32)
    s_ind = np.stack([rng.choice(Nn, M, replace=False)
                      for _ in range(2 * B)]).astype(np.int32)
    xyz_s = np.stack([xyz[i][s_ind[i]] for i in range(2 * B)])
    featn = feat / np.linalg.norm(feat, axis=-1, keepdims=True)
    feat_s = np.stack([featn[i][s_ind[i]] for i in range(2 * B)])
    outs = {
        "xyz": jnp.asarray(xyz), "feat": jnp.asarray(feat),
        "sample_nodes_concat": jnp.asarray(s_ind),
        "att_sampled": jnp.asarray(rng.rand(2 * B, M).astype(np.float32)),
        "xyz_sampled": jnp.asarray(xyz_s),
        "feat_sampled": jnp.asarray(feat_s),
        "R": jnp.asarray(np.eye(3, dtype=np.float32)[None]),
    }
    loss, aux = losses.local_detection_loss_nn(
        outs, ar_th=0.4, det_k=6, ar_nn_k=5, pos_r=0.5,
        use_hardest_neg=False,
    )
    assert np.isfinite(float(loss))
    assert 0.0 <= float(aux["mean_ar"]) <= 1.0


# ---------------- batch-hard (cross-device) mining ----------------

def _np_batch_hard_quadruplet(gd, B, P, Nn, m1, m2):
    """Numpy oracle: hinge over the union of ALL tuples' negatives."""
    d = gd.shape[-1]
    q = gd[:B].reshape(B, 1, d)
    pos = gd[B:B + B * P].reshape(B, P, d)
    neg = gd[B + B * P:B + B * P + B * Nn].reshape(B, Nn, d)
    oneg = gd[B + B * P + B * Nn:].reshape(B, 1, d)
    pool = neg.reshape(B * Nn, d)
    best_pos = np.min(np.sum((pos - q) ** 2, axis=2), axis=1)  # [B]
    neg_d = np.sum((pool[None] - q) ** 2, axis=2)  # [B, B*Nn]
    trip = np.mean(np.max(np.maximum(0, m1 + best_pos[:, None] - neg_d), 1))
    n2o = np.sum((pool[None] - oneg) ** 2, axis=2)
    second = np.mean(np.max(np.maximum(0, m2 + best_pos[:, None] - n2o), 1))
    return trip + second


def test_batch_hard_quadruplet_matches_numpy_oracle(rng):
    B, P, Nn, D = 3, 2, 4, 8
    gd = rng.randn(B + B * P + B * Nn + B, D).astype(np.float32)
    loss, aux = losses.batch_hard_quadruplet_loss(
        jnp.asarray(gd), batch_size=B, num_pos=P, num_neg=Nn,
        global_triplet_margin=0.5, global_quadruplet_margin=0.2,
    )
    expect = _np_batch_hard_quadruplet(gd.astype(np.float64), B, P, Nn,
                                       0.5, 0.2)
    np.testing.assert_allclose(float(loss), expect, rtol=1e-5)


def test_batch_hard_at_least_as_hard_as_lazy(rng):
    """The global pool contains each tuple's own negatives, so the mined
    triplet hinge can only be >= the lazy (within-tuple) one."""
    B, P, Nn, D = 4, 2, 3, 16
    gd = jnp.asarray(rng.randn(B + B * P + B * Nn, D).astype(np.float32))
    lazy, _ = losses.lazy_triplet_loss(gd, B, P, Nn,
                                       global_triplet_margin=0.5)
    hard, _ = losses.batch_hard_triplet_loss(gd, B, P, Nn,
                                             global_triplet_margin=0.5)
    assert float(hard) >= float(lazy) - 1e-6


def test_batch_hard_all_gather_matches_single_device(rng):
    """shard_map path: each of 8 devices holds ONE complete tuple and mines
    against the lax.all_gather'ed global pool — the mean of per-device
    losses must equal the single-device loss over the concatenated batch."""
    import pytest
    from functools import partial

    import jax
    from jax.sharding import PartitionSpec as P_
    from jax.experimental.shard_map import shard_map

    if jax.local_device_count() < 8:
        pytest.skip("needs the 8-device CPU mesh")

    from dh3d_tpu.parallel import data_parallel_mesh

    ndev, P, Nn, D = 8, 2, 3, 16
    T = 1 + P + Nn + 1  # one tuple's cloud count
    per_dev = rng.randn(ndev, T, D).astype(np.float32)

    mesh = data_parallel_mesh(ndev)

    @partial(shard_map, mesh=mesh, in_specs=P_("data"),
             out_specs=P_("data"))
    def mined(tuples):  # [1, T, D] per device
        loss, _ = losses.batch_hard_quadruplet_loss(
            tuples[0], batch_size=1, num_pos=P, num_neg=Nn,
            global_triplet_margin=0.5, global_quadruplet_margin=0.2,
            axis_name="data",
        )
        return loss[None]

    per_device_losses = np.asarray(jax.jit(mined)(jnp.asarray(per_dev)))

    # single-device oracle: rearrange into the global tuple-concat layout
    q = per_dev[:, 0]
    pos = per_dev[:, 1:1 + P].reshape(-1, D)
    neg = per_dev[:, 1 + P:1 + P + Nn].reshape(-1, D)
    oneg = per_dev[:, -1]
    gd = np.concatenate([q, pos, neg, oneg])
    expect = _np_batch_hard_quadruplet(gd.astype(np.float64), ndev, P, Nn,
                                       0.5, 0.2)
    np.testing.assert_allclose(per_device_losses.mean(), expect, rtol=1e-5)
