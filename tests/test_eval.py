"""Evaluation-layer tests: NMS parity, retrieval recall on synthetic
descriptors with known GT, RANSAC recovering a known rigid transform, and
the end-to-end extract -> retrieval flow on a tiny model."""

import os

import jax
import numpy as np

from dh3d_tpu import config as cfglib
from dh3d_tpu.eval import (
    average_recalls,
    evaluate_sequences,
    is_gt_match_2d,
    match_descriptors_mutual,
    ransac_rigid,
    register_clouds,
    registration_success,
    single_nms,
)
from dh3d_tpu.eval.nms import device_nms
from dh3d_tpu.utils.transforms import rigid_transform_3d, rotation_error_deg


def test_rigid_transform_recovers_exact(rng):
    A = rng.randn(50, 3)
    ang = 0.7
    R_gt = np.array([
        [np.cos(ang), -np.sin(ang), 0],
        [np.sin(ang), np.cos(ang), 0],
        [0, 0, 1],
    ])
    t_gt = np.array([1.0, -2.0, 0.5])
    B = (A - t_gt) @ R_gt  # so A = B @ R_gt.T + t_gt ... construct directly
    B = (A - t_gt) @ np.linalg.inv(R_gt).T
    R, t = rigid_transform_3d(A, B)
    np.testing.assert_allclose(B @ R.T + t, A, atol=1e-8)
    assert rotation_error_deg(R, R_gt) < 1e-6


def test_ransac_with_outliers(rng):
    kp2 = rng.randn(100, 3) * 10
    ang = 0.5
    R_gt = np.array([
        [np.cos(ang), -np.sin(ang), 0],
        [np.sin(ang), np.cos(ang), 0],
        [0, 0, 1],
    ])
    t_gt = np.array([2.0, 1.0, -0.3])
    kp1 = kp2 @ R_gt.T + t_gt
    # corrupt 30% with large outliers
    bad = rng.choice(100, 30, replace=False)
    kp1 = kp1.copy()
    kp1[bad] += rng.randn(30, 3) * 50
    res = ransac_rigid(kp1, kp2, inlier_thresh=0.5, iters=500, seed=1)
    assert res is not None
    assert res.num_inliers >= 65
    ok, rte, rre = registration_success(res.R, res.t, R_gt, t_gt)
    assert ok, (rte, rre)


def test_register_clouds_end_to_end(rng):
    # distinctive descriptors -> mutual matching is near-perfect
    desc = rng.randn(80, 32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    kp2 = rng.randn(80, 3) * 5
    ang = -0.3
    R_gt = np.array([
        [np.cos(ang), -np.sin(ang), 0],
        [np.sin(ang), np.cos(ang), 0],
        [0, 0, 1],
    ])
    t_gt = np.array([0.5, 0.2, 0.1])
    kp1 = kp2 @ R_gt.T + t_gt
    res = register_clouds(kp1, desc + rng.randn(80, 32) * 0.01,
                          kp2, desc, iters=300, seed=2)
    assert res is not None
    ok, _, _ = registration_success(res.R, res.t, R_gt, t_gt)
    assert ok


def test_mutual_matching():
    d1 = np.array([[1.0, 0], [0, 1], [1, 1]])
    d2 = np.array([[0.0, 1], [1, 0]])
    m = match_descriptors_mutual(d1, d2)
    assert {(a, b) for a, b in m} == {(0, 1), (1, 0)}


def test_nms_host_simple():
    # 3 clusters; highest-attention point of each survives
    xyz = np.array([
        [0, 0, 0], [0.1, 0, 0], [0.2, 0, 0],
        [10, 0, 0], [10.1, 0, 0],
        [20, 0, 0],
    ], np.float64)
    att = np.array([0.9, 0.5, 0.4, 0.3, 0.8, 0.7])
    n, idx = single_nms(xyz, att, nms_radius=1.0, min_response_ratio=0.01,
                        max_keypoints=10, remove_noise=False)
    assert set(idx) == {0, 4, 5}
    assert idx == [0, 4, 5]  # descending attention


def test_nms_noise_removal():
    xyz = np.concatenate([
        np.random.RandomState(0).randn(60, 3) * 0.3,  # dense cluster
        np.array([[50.0, 50, 50]]),                   # isolated outlier
    ])
    att = np.full(61, 0.5)
    att[60] = 0.99  # outlier has the top response
    n, idx = single_nms(xyz, att, nms_radius=0.5, min_response_ratio=0.01,
                        max_keypoints=5, remove_noise=True)
    assert 60 not in idx  # noise removal killed it


def test_device_nms_matches_host(rng):
    xyz = rng.randn(200, 3).astype(np.float32) * 3
    att = rng.rand(200).astype(np.float32)
    n_h, idx_h = single_nms(xyz.astype(np.float64), att.copy(), 0.5, 0.01,
                            50, remove_noise=True)
    n_d, idx_d = device_nms(xyz, att, 0.5, 0.01, 50, remove_noise=True)
    assert n_h == n_d
    np.testing.assert_array_equal(np.asarray(idx_d)[:n_d], idx_h)


def test_device_nms_tie_parity(rng):
    """Exact attention ties must order identically to the host NMS.

    The host `sorted([(att, idx)], reverse=True)` breaks ties by
    DESCENDING index; trained sigmoid attention produces exact ties
    (saturated scores, bf16-quantized logits), modeled here by snapping
    attention to a 16-level grid so many spatially-separated survivors
    share a value."""
    xyz = rng.randn(300, 3).astype(np.float32) * 4
    att = (np.floor(rng.rand(300) * 16) / 16 + 1 / 16).astype(np.float32)
    n_h, idx_h = single_nms(xyz.astype(np.float64), att.copy(), 0.5, 0.01,
                            100, remove_noise=True)
    # precondition: the fixture actually exercises ties among survivors
    surv_att = att[idx_h]
    assert len(surv_att) != len(np.unique(surv_att)), "fixture has no ties"
    n_d, idx_d = device_nms(xyz, att, 0.5, 0.01, 100, remove_noise=True)
    assert n_h == n_d
    np.testing.assert_array_equal(np.asarray(idx_d)[:n_d], idx_h)


def test_retrieval_recall_synthetic(rng):
    # two sequences; descriptors = noisy position encodings so retrieval
    # works by construction
    def make_seq(offset):
        n = 40
        northing = np.arange(n) * 30.0 + offset  # 30 m spacing
        easting = np.zeros(n)
        desc = np.stack([northing / 100.0, easting], 1)
        desc = np.concatenate([desc, np.zeros((n, 6))], 1)
        return {
            "pos": {"northing": northing, "easting": easting},
            "desc": desc + rng.randn(n, 8) * 0.001,
        }

    ref = {"A": make_seq(0.0)}
    query = {"B": make_seq(5.0)}  # 5 m offset -> GT match is the same index
    results = evaluate_sequences(ref, query, max_num_nn=25)
    assert len(results) == 1
    avg, one_percent = average_recalls(results)
    assert avg[0] > 0.99  # recall@1 ~ 1 by construction
    assert one_percent > 0.99


def test_gt_match_2d():
    q = {"northing": np.array([0.0, 100.0]), "easting": np.array([0.0, 0.0])}
    r = {"northing": np.array([10.0, 90.0]), "easting": np.array([0.0, 0.0])}
    gt = is_gt_match_2d(q, r, 25)
    np.testing.assert_array_equal(gt, [[True, False], [False, True]])


def test_extract_and_retrieve_roundtrip(tmp_path, rng):
    """Tiny model -> extract_global over two 'sequences' -> files -> recall
    pipeline runs end to end."""
    from dh3d_tpu.eval import extract_global, load_sets_from_dir
    from dh3d_tpu.nn import DH3D

    N = 64
    cfg = cfglib.get_config("global_config")
    cfg.num_points = N
    model = DH3D(cfg)
    pts = rng.randn(1, N, 3).astype(np.float32) * 5
    # key 1: with key 0's draws the untrained attention head saturates at
    # 0 on one cloud, which zeroes its NetVLAD descriptor
    variables = jax.jit(lambda k, p: model.init(k, p, train=False))(
        jax.random.PRNGKey(1), pts)

    names = ["seqA/1", "seqA/2", "seqB/1"]
    clouds = [rng.randn(N, 3).astype(np.float32) * 5 for _ in names]
    ds = list(zip(clouds, [n + ".bin" for n in names]))
    n = extract_global(cfg, variables, ds, str(tmp_path / "desc"),
                       batch_size=2, model=model)
    assert n == 3
    for name in names:
        f = tmp_path / "desc" / (name + ".bin")
        assert f.exists()
        d = np.fromfile(f, np.float32)
        assert d.shape == (256,)
        np.testing.assert_allclose(np.linalg.norm(d), 1.0, atol=1e-3)


def test_keypoint_repeatability_metric(rng):
    from dh3d_tpu.eval import keypoint_repeatability

    kp1 = rng.randn(50, 3) * 10
    ang = 0.4
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    t = np.array([1.0, 2.0, 0.0])
    # kp2 = warped kp1 (perfect repeatability), plus distractors
    kp2 = np.concatenate([kp1 @ R.T + t, rng.randn(20, 3) * 10 + 100])
    assert keypoint_repeatability(kp1, kp2, R, t, radius=0.1) == 1.0
    # half of kp1 displaced far -> 0.5
    kp1_bad = kp1.copy()
    kp1_bad[:25] += 1000
    r = keypoint_repeatability(kp1_bad, kp2, R, t, radius=0.1)
    assert abs(r - 0.5) < 1e-9
    # identity default
    assert keypoint_repeatability(kp1, kp1.copy(), radius=0.1) == 1.0


def test_repeatability_curve_synthetic(rng):
    from dh3d_tpu.eval import repeatability_curve

    # dense enough that NMS noise removal (8th-NN < 2 m) keeps points
    clouds = [rng.randn(300, 3).astype(np.float32) * 2 for _ in range(2)]

    def extract(cloud):
        # fake detector: attention = distance from centroid (rotation
        # invariant up to jitter) -> decent repeatability by construction
        att = np.linalg.norm(cloud - cloud.mean(0), axis=1)
        return cloud, att / att.max()

    curve = repeatability_curve(extract, clouds, ks=(8, 32), radius=0.5)
    assert set(curve) == {8, 32}
    assert all(0.0 <= v <= 1.0 for v in curve.values())
    assert curve[32] > 0.2  # invariant fake detector repeats


def test_nms_keypoint_indices_backends_agree(rng):
    """Driver-level NMS entry: device backend (default in the extraction
    drivers) selects the same keypoints as the host path, enforced
    by its own parity_check."""
    from dh3d_tpu.eval.nms import nms_keypoint_indices

    xyz = rng.randn(150, 3).astype(np.float32) * 4
    att = rng.rand(150).astype(np.float32)
    idx = nms_keypoint_indices(xyz, att, 0.5, 0.01, 40,
                               backend="device", parity_check=True)
    assert len(idx) > 0


def test_repeatability_pairs_protocol(rng):
    """GT-pose-pair repeatability on partial-overlap crops: a
    rigid-invariant detector (local density) must be highly repeatable in
    the shared region, and the warp math must use the provided GT pose."""
    from scipy.spatial import cKDTree

    from dh3d_tpu.eval.repeatability import (
        make_partial_overlap_pairs,
        repeatability_curve_pairs,
    )

    # structured cloud: grid + clusters, so density attention is stable
    base = rng.randn(4000, 3) * np.array([4, 4, 1])
    pairs = make_partial_overlap_pairs([base], numpts=1024, keep=0.85,
                                       jitter=0.005, seed=0)
    assert len(pairs) == 1
    c1, c2, R, t = pairs[0]
    assert c1.shape == (1024, 3) and c2.shape == (1024, 3)
    # GT transform maps the overlap region of c1 onto c2's region
    warped = c1 @ R.T + t
    d = np.linalg.norm(warped[:, None, :2] - c2[None, :, :2], axis=-1)
    assert np.median(d.min(axis=1)) < 1.0  # overlap exists under GT pose

    def extract(cloud):
        dist, _ = cKDTree(cloud).query(cloud, k=9)
        att = 1.0 / (1e-3 + dist[:, -1])  # local density (rigid-invariant)
        return cloud, att / att.max()

    curve = repeatability_curve_pairs(extract, pairs, ks=(32, 64),
                                      radius=1.0)
    assert set(curve) == {32, 64}
    assert all(0.0 <= v <= 1.0 for v in curve.values())
    assert curve[32] > 0.3, curve  # density peaks recur in the overlap


def test_find_point_normals_plane(rng):
    """Points on a tilted plane -> normals match the plane normal, tiny
    curvature; orientation flips toward the view point."""
    from dh3d_tpu.eval import find_point_normals

    n_true = np.array([1.0, 2.0, 2.0])
    n_true /= np.linalg.norm(n_true)
    basis = np.linalg.svd(n_true[None])[2][1:]  # 2 in-plane directions
    uv = rng.randn(300, 2) * 5
    pts = uv @ basis + rng.randn(300, 3) * 1e-4
    # full-dot orientation: unambiguous for a far-above viewpoint
    normals, curv = find_point_normals(pts, view_point=(0, 0, 100),
                                       dir_largest=False)
    dots = normals @ n_true
    assert np.mean(np.abs(dots) > 0.99) > 0.95
    # oriented toward the viewpoint above the plane (+z side)
    assert np.mean(normals[:, 2] > 0) > 0.95
    assert np.median(curv) < 1e-4
    # dirLargest mode (MATLAB default): still unit plane normals
    n2, _ = find_point_normals(pts, view_point=(0, 0, 100))
    assert np.mean(np.abs(n2 @ n_true) > 0.99) > 0.95
    np.testing.assert_allclose(np.linalg.norm(n2, axis=1), 1.0, atol=1e-6)


def test_prec_rec_separable(rng):
    """Perfectly separable scores -> an operating point with
    precision 1 & recall 1; random labels degrade monotonically."""
    from dh3d_tpu.eval import prec_rec

    score = np.concatenate([rng.rand(100) + 2.0, rng.rand(100)])
    target = np.concatenate([np.ones(100), np.zeros(100)])
    prec, tpr, fpr, th = prec_rec(score, target)
    # quantile-grid thresholds may fall just inside the positive block,
    # so allow one-sample slack on recall
    perfect = (prec >= 1.0 - 1e-9) & (tpr >= 0.98)
    assert perfect.any()
    # tpr/fpr are monotone in threshold direction
    assert (np.diff(tpr) >= -1e-12).all()
    assert (np.diff(fpr) >= -1e-12).all()


def test_euler_roundtrip_all_24_conventions(rng):
    """euler_matrix / euler_from_matrix round-trip for every axis
    convention (the doctest protocol of `core/utils.py:491-547`)."""
    from dh3d_tpu.utils import transforms as T

    angles = (4 * np.pi) * (rng.rand(3) - 0.5)
    for axes in T._AXES2TUPLE:
        R0 = T.euler_matrix(*angles, axes=axes)
        R1 = T.euler_matrix(*T.euler_from_matrix(R0, axes), axes=axes)
        np.testing.assert_allclose(R0, R1, atol=1e-10, err_msg=axes)


def test_euler_gimbal_lock_branch():
    from dh3d_tpu.utils import transforms as T

    # sxyz gimbal lock: middle angle = pi/2 (cy == 0 branch)
    R0 = T.euler_matrix(0.3, np.pi / 2, 0.7, "sxyz")
    R1 = T.euler_matrix(*T.euler_from_matrix(R0, "sxyz"), axes="sxyz")
    np.testing.assert_allclose(R0, R1, atol=1e-10)
    # repeated-axis lock: middle angle = 0 (sy == 0 branch)
    R0 = T.euler_matrix(0.4, 0.0, -0.2, "sxyx")
    R1 = T.euler_matrix(*T.euler_from_matrix(R0, "sxyx"), axes="sxyx")
    np.testing.assert_allclose(R0, R1, atol=1e-10)


def test_angle_errors(rng):
    from dh3d_tpu.utils import transforms as T

    Rz = T.euler_matrix(0, 0, np.deg2rad(10))[:3, :3]
    assert abs(T.angle_error1(np.eye(3), Rz) - 10.0) < 1e-8
    # angle_error2 sums |euler| of the relative rotation (radians)
    assert abs(T.angle_error2(np.eye(3), Rz) - np.deg2rad(10)) < 1e-10
    assert T.angle_error2(Rz, Rz) < 1e-12


def test_random_quaternion_and_rotation(rng):
    from dh3d_tpu.utils import transforms as T

    q = T.random_quaternion(rand=rng.rand(3))
    assert abs(np.linalg.norm(q) - 1.0) < 1e-12
    R = T.random_rotation_matrix(rand=rng.rand(3))
    assert R.shape == (4, 4)
    np.testing.assert_allclose(R.T @ R, np.eye(4), atol=1e-12)
    assert abs(np.linalg.det(R[:3, :3]) - 1.0) < 1e-12
    # deterministic under a seeded Generator
    g1 = np.random.default_rng(7)
    g2 = np.random.default_rng(7)
    np.testing.assert_array_equal(T.random_quaternion(rng=g1),
                                  T.random_quaternion(rng=g2))


def test_quaternion_precise_matches_eig(rng):
    from dh3d_tpu.utils import transforms as T

    for _ in range(10):
        R = T.random_rotation_matrix(rand=rng.rand(3))
        q_eig = T.quaternion_from_matrix(R)
        q_pre = T.quaternion_from_matrix_precise(R)
        np.testing.assert_allclose(q_eig, q_pre, atol=1e-8)


def test_vector_norm_variants(rng):
    from dh3d_tpu.utils.transforms import vector_norm

    v = rng.rand(6, 5, 3)
    np.testing.assert_allclose(vector_norm(v, axis=-1),
                               np.sqrt((v * v).sum(2)))
    np.testing.assert_allclose(vector_norm(v, axis=1),
                               np.sqrt((v * v).sum(1)))
    assert vector_norm([]) == 0.0
    assert vector_norm([1]) == 1.0
    out = np.empty((6, 3))
    vector_norm(v, axis=1, out=out)
    np.testing.assert_allclose(out, np.sqrt((v * v).sum(1)))
