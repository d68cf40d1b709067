"""Training-layer tests: overfit smoke (loss decreases), curriculum freeze
masks, SmartInit-style warm start, LR schedule, and the data-parallel mesh
path on the virtual 8-device CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dh3d_tpu import config as cfglib
from dh3d_tpu import train as trainlib
from dh3d_tpu.parallel import data_parallel_mesh
from dh3d_tpu.parallel.mesh import replicate, shard_batch

N = 64
KP = 8

# mesh tests need the virtual 8-device CPU mesh (tests/conftest.py)
requires_mesh = pytest.mark.skipif(
    jax.local_device_count() < 8,
    reason="needs the 8-device CPU mesh (single-chip run)")


def make_local_batch(rng, B=2, jitter=0.01):
    """Synthetic self-pair batch mirroring `core/datasets.py:126-151`:
    anchor cloud + jittered rotated copy, correspondence = same index."""
    pc1 = rng.randn(B, N, 3).astype(np.float32) * 5
    ang = rng.uniform(-np.pi, np.pi, B)
    R = np.stack([
        np.array([[np.cos(a), np.sin(a), 0],
                  [-np.sin(a), np.cos(a), 0],
                  [0, 0, 1]], np.float32)
        for a in ang
    ])
    pc2 = np.einsum("bnd,bde->bne", pc1 + rng.randn(B, N, 3) * jitter, R)
    anc = np.stack([rng.choice(N, KP, replace=False) for _ in range(B)])
    batch = {
        "points": jnp.asarray(np.concatenate([pc1, pc2.astype(np.float32)])),
        "sample_inds": jnp.asarray(
            np.concatenate([anc, anc]).astype(np.int32)
        ),
        "R": jnp.asarray(R.astype(np.float32)),
    }
    return batch


def small_cfg(name="basic_config"):
    cfg = cfglib.get_config(name)
    cfg.num_points = N
    cfg.sampled_kpnum = KP
    cfg.batch_size = 2
    cfg.decay_step = 100
    return cfg


def test_train_step_reduces_local_loss(rng):
    cfg = small_cfg()
    cfg.start_lr = 1e-3
    batch = make_local_batch(rng)
    state = trainlib.init_state(cfg, jax.random.PRNGKey(0), batch)
    step = trainlib.make_train_step(cfg)
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["total_cost"]))
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()


def test_freeze_labels():
    cfg = small_cfg("global_config")
    params = {
        "local_backbone": {"a": np.zeros(2)},
        "detection_block": {"b": np.zeros(2)},
        "global_backbone": {"c": np.zeros(2)},
        "globalatt": {"d": np.zeros(2)},
        "global_assemble": {"e": np.zeros(2)},
    }
    labels = trainlib.param_labels(cfg, params)
    assert labels["local_backbone"]["a"] == "frozen"
    assert labels["detection_block"]["b"] == "frozen"
    assert labels["global_backbone"]["c"] == "trainable"
    assert labels["global_assemble"]["e"] == "trainable"


def test_frozen_params_unchanged_by_step(rng):
    cfg = small_cfg()
    cfg.freezebackbone = True
    batch = make_local_batch(rng)
    state = trainlib.init_state(cfg, jax.random.PRNGKey(0), batch)
    before = jax.device_get(state.params["local_backbone"])
    step = trainlib.make_train_step(cfg)
    state, _ = step(state, batch)
    after = jax.device_get(state.params["local_backbone"])
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(a, b)


def test_smart_init_partial_restore():
    init = {"a": {"w": np.zeros((2, 2))}, "b": {"w": np.zeros(3)}}
    loaded = {
        "a": {"w": np.ones((2, 2))},
        "b": {"w": np.ones(4)},       # shape mismatch -> keep fresh
        "c": {"w": np.ones(5)},       # extra -> ignored
    }
    merged, n = trainlib.smart_init(init, loaded)
    assert n == 1
    np.testing.assert_array_equal(np.asarray(merged["a"]["w"]), np.ones((2, 2)))
    np.testing.assert_array_equal(np.asarray(merged["b"]["w"]), np.zeros(3))


def test_lr_schedule_staircase():
    cfg = small_cfg()
    cfg.start_lr = 1.0
    cfg.decay_step = 10
    cfg.decay_rate = 0.5
    sched = trainlib.lr_schedule(cfg)
    assert float(sched(0)) == 1.0
    assert float(sched(9)) == 1.0  # staircase: no decay inside the step
    assert float(sched(10)) == 0.5
    assert float(sched(25)) == 0.25


def test_kernel_l2_only_dense_kernels():
    params = {
        "x": {"dense": {"kernel": np.ones((2, 2)), "bias": np.ones(2)}},
        "y": {"position_theta": np.ones((3, 2, 2)), "kernel": np.full((1,), 2.0)},
        "bn": {"scale": np.ones(4)},
    }
    l2 = float(trainlib.kernel_l2(params))
    assert l2 == 4.0 + 4.0  # both 'kernel' leaves, nothing else


@requires_mesh
def test_data_parallel_train_step(rng):
    """One DP step on the 8-device CPU mesh: batch sharded on 'data',
    params replicated; result must match the single-device step."""
    cfg = small_cfg()
    cfg.sampled_kpnum = KP
    batch = make_local_batch(rng, B=4)  # 8 clouds total -> 1 per device
    state = trainlib.init_state(cfg, jax.random.PRNGKey(0), batch)
    step = trainlib.make_train_step(cfg)

    # single-device reference
    s1, m1 = step(state, batch)

    mesh = data_parallel_mesh(8)
    with jax.sharding.set_mesh(mesh):
        sharded_batch = shard_batch(mesh, batch)
        rep_state = replicate(mesh, state)
        s2, m2 = step(rep_state, sharded_batch)
        np.testing.assert_allclose(
            float(m1["total_cost"]), float(m2["total_cost"]), rtol=1e-4
        )


def test_checkpoint_exact_resume(rng, tmp_path):
    """Full-state checkpoint -> restore -> next step is bit-identical."""
    cfg = small_cfg()
    batch = make_local_batch(rng)
    state = trainlib.init_state(cfg, jax.random.PRNGKey(0), batch)
    step = trainlib.make_train_step(cfg)
    state, _ = step(state, batch)
    path = trainlib.save_checkpoint(str(tmp_path), state)
    fresh = trainlib.init_state(cfg, jax.random.PRNGKey(1), batch)
    restored = trainlib.restore_state(path, fresh)
    assert int(restored.step) == int(state.step)
    _, m1 = step(state, batch)
    _, m2 = step(restored, batch)
    np.testing.assert_allclose(
        float(m1["total_cost"]), float(m2["total_cost"]), rtol=0, atol=0
    )


@requires_mesh
def test_sharded_knn_matches_single_device(rng):
    """Point-axis-sharded knn over the 8-device mesh == single-device knn."""
    import jax.numpy as jnp
    from dh3d_tpu import ops
    from dh3d_tpu.parallel.sharded_knn import knn_sharded

    pts = jnp.asarray(rng.randn(2, 128, 3).astype(np.float32) * 10)
    mesh = data_parallel_mesh(8)
    idx_s, d_s = knn_sharded(pts, 8, mesh)
    idx_1, d_1 = ops.knn_bruteforce(pts, 8)
    np.testing.assert_array_equal(np.asarray(idx_s), np.asarray(idx_1))
    np.testing.assert_allclose(np.asarray(d_s), np.asarray(d_1), atol=1e-5)


@requires_mesh
def test_global_config_dp_step(rng):
    """Global (quadruplet) training step over the 8-device mesh: 16 clouds
    (batch 2 x [q+1pos+5neg+otherneg]) sharded on 'data'."""
    cfg = cfglib.get_config("global_config")
    cfg.num_points = N
    cfg.batch_size = 2
    cfg.num_pos = 1
    cfg.num_neg = 5
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    total = cfg.batch_size * (1 + cfg.num_pos + cfg.num_neg + 1)  # 16
    batch = {"points": jnp.asarray(
        rng.randn(total, N, 3).astype(np.float32) * 5)}
    mesh = data_parallel_mesh(8)
    with jax.sharding.set_mesh(mesh):
        state = trainlib.init_state(cfg, jax.random.PRNGKey(0), batch)
        state = replicate(mesh, state)
        sharded = shard_batch(mesh, batch)
        step = trainlib.make_train_step(cfg)
        s1, m1 = step(state, sharded)
        assert np.isfinite(float(m1["total_cost"]))
        # frozen trunks stay frozen under DP too
        before = jax.device_get(state.params["local_backbone"])
        after = jax.device_get(s1.params["local_backbone"])
        for a, b in zip(jax.tree_util.tree_leaves(before),
                        jax.tree_util.tree_leaves(after)):
            np.testing.assert_array_equal(a, b)
        # global head DID train
        gb = jax.device_get(state.params["global_assemble"])
        ga = jax.device_get(s1.params["global_assemble"])
        assert any(
            not np.array_equal(a, b)
            for a, b in zip(jax.tree_util.tree_leaves(gb),
                            jax.tree_util.tree_leaves(ga))
        )


def test_on_device_augmentation_global(rng):
    """augment_on_device applies jax augmentations inside the jitted step
    (global config; clouds independent)."""
    cfg = cfglib.get_config("global_config")
    cfg.num_points = N
    cfg.batch_size = 1
    cfg.num_pos = 1
    cfg.num_neg = 2
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    cfg.augment_on_device = True
    total = cfg.batch_size * (1 + cfg.num_pos + cfg.num_neg + 1)
    batch = {
        "points": jnp.asarray(rng.randn(total, N, 3).astype(np.float32) * 5),
        "aug_key": jax.random.PRNGKey(3),
    }
    state = trainlib.init_state(cfg, jax.random.PRNGKey(0), batch)
    step = trainlib.make_train_step(cfg)
    s1, m1 = step(state, batch)
    assert np.isfinite(float(m1["total_cost"]))
    # different aug key -> different loss (augmentation actually applied)
    batch2 = dict(batch, aug_key=jax.random.PRNGKey(4))
    _, m2 = step(state, batch2)
    assert float(m1["total_cost"]) != float(m2["total_cost"])


@requires_mesh
def test_cross_device_mining_dp_matches_single_device(rng):
    """cfg.cross_device_mining: the mined quadruplet loss over the 8-device
    DP mesh equals the single-device loss over the concatenated batch
    (global-view jit — XLA inserts the collectives), proving mining spans
    the whole mesh-wide batch."""
    cfg = cfglib.get_config("global_config")
    cfg.num_points = N
    cfg.batch_size = 2
    cfg.num_pos = 1
    cfg.num_neg = 5
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    cfg.cross_device_mining = True
    total = cfg.batch_size * (1 + cfg.num_pos + cfg.num_neg + 1)  # 16
    batch = {"points": jnp.asarray(
        rng.randn(total, N, 3).astype(np.float32) * 5)}

    state = trainlib.init_state(cfg, jax.random.PRNGKey(0), batch)
    step = trainlib.make_train_step(cfg)
    _, m1 = step(state, batch)  # single-device oracle
    assert "hardest_neg_dist" in m1  # mined path actually taken

    mesh = data_parallel_mesh(8)
    with jax.sharding.set_mesh(mesh):
        sharded = shard_batch(mesh, batch)
        rep_state = replicate(mesh, state)
        _, m2 = step(rep_state, sharded)
    np.testing.assert_allclose(
        float(m1["total_cost"]), float(m2["total_cost"]), rtol=1e-4
    )


def test_device_pairgen_correspondences(rng):
    """On-device pair generation (data/pairgen.py): with pc2 == pc1, the
    1-NN correspondence of every FPS anchor must be the anchor itself, the
    rotated copy must equal pc1 @ R, and anchors must be unique."""
    from dh3d_tpu.data.pairgen import device_local_pairs

    B, M = 2, 16
    pc = rng.randn(B, N, 3).astype(np.float32) * 5
    out = device_local_pairs(jax.random.PRNGKey(7), jnp.asarray(pc),
                             jnp.asarray(pc), M)
    pts = np.asarray(out["points"])
    inds = np.asarray(out["sample_inds"])
    R = np.asarray(out["R"])
    assert pts.shape == (2 * B, N, 3) and inds.shape == (2 * B, M)
    np.testing.assert_array_equal(inds[:B], inds[B:])  # self-corresp.
    for b in range(B):
        assert len(set(inds[b])) == M  # FPS anchors unique
        np.testing.assert_allclose(pts[B + b], pc[b] @ R[b], atol=1e-5)
        # R is a proper rotation
        np.testing.assert_allclose(R[b] @ R[b].T, np.eye(3), atol=1e-5)


def test_device_pairgen_train_step(rng):
    """Full train step from a raw {pc1, pc2} batch: pairgen inside jit,
    loss finite and decreasing."""
    cfg = small_cfg()
    cfg.device_pairgen = True
    cfg.sampled_kpnum = KP
    pc1 = rng.randn(2, N, 3).astype(np.float32) * 5
    batch = {
        "pc1": jnp.asarray(pc1),
        "pc2": jnp.asarray(pc1 + rng.randn(2, N, 3).astype(np.float32) * 0.01),
        "pairgen_key": jax.random.PRNGKey(0),
    }
    state = trainlib.init_state(cfg, jax.random.PRNGKey(0), batch)
    step = trainlib.make_train_step(cfg)
    losses = []
    for i in range(6):
        b = dict(batch, pairgen_key=jax.random.PRNGKey(i))
        state, m = step(state, b)
        losses.append(float(m["total_cost"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_threaded_prefetcher():
    from dh3d_tpu.data import ThreadedPrefetcher

    items = list(ThreadedPrefetcher(iter(range(20)), depth=3))
    assert items == list(range(20))

    def boom():
        yield 1
        raise ValueError("source failed")

    it = ThreadedPrefetcher(boom(), depth=2)
    assert next(it) == 1
    import pytest as _pytest
    with _pytest.raises(ValueError, match="source failed"):
        next(it)


def test_reproduce_ref_detloss_bug_toggle(rng):
    """cfg.reproduce_ref_detloss_bug switches the hardest-negative gather
    to a faithful reproduction of the reference's slot-index bug
    (`core/losses.py:94-98`) — same loss structure, different candidate
    neighborhoods, no code edit needed for strict-parity A/Bs."""
    from dh3d_tpu.losses.losses import local_detection_loss_nn

    cfg = small_cfg("detection_config")
    batch = make_local_batch(rng)
    state = trainlib.init_state(cfg, jax.random.PRNGKey(0), batch)
    from dh3d_tpu.nn import DH3D

    model = DH3D(cfg)
    outs = model.apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        batch["points"], sample_inds=batch["sample_inds"], train=False)
    outs["R"] = batch["R"]

    kw = dict(det_k=cfg.det_k, ar_nn_k=cfg.ar_nn_k, pos_r=cfg.pos_r,
              ar_th=cfg.ar_th)
    fixed, aux_f = local_detection_loss_nn(
        outs, reproduce_ref_detloss_bug=False, **kw)
    buggy, aux_b = local_detection_loss_nn(
        outs, reproduce_ref_detloss_bug=True, **kw)
    for v in (fixed, buggy):
        assert np.isfinite(float(v))
    # the two gathers select different candidate neighborhoods on random
    # clouds -> different match ranks (the loss itself can coincide when
    # AR saturates at an untrained detector score)
    assert float(aux_f["mean_ar"]) != float(aux_b["mean_ar"])
