"""Model-level tests: init + forward for every config preset, shape
contract of the `outs` dict, determinism, and BN mutation.

The reference had no model-level tests (SURVEY.md §4); these are the added
layer.  Tiny sizes (N=64) keep the CPU suite fast; dilate structure still
exercises subsample/knn/upsample because 64/8 = 8 points remain.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dh3d_tpu import config as cfglib
from dh3d_tpu.nn import DH3D

N = 64
KP = 16


def tiny(cfg):
    cfg.num_points = N
    cfg.sampled_kpnum = KP if cfg.sampled_kpnum and cfg.sampled_kpnum > 0 else cfg.sampled_kpnum
    return cfg


def init_and_run(cfg, btotal, train=False, with_kp=None):
    model = DH3D(cfg)
    rng = np.random.RandomState(0)
    pts = jnp.asarray(rng.randn(btotal, N, 3).astype(np.float32) * 10)
    kwargs = {}
    if with_kp:
        kwargs["sample_inds"] = jnp.asarray(
            rng.randint(0, N, (btotal, KP)).astype(np.int32)
        )
    # key 1: an untrained model's eval-mode activations grow layer by layer
    # (BN running stats are still 0/1); with key 0's draws the global head
    # overflows float32 on these clouds and returns a zero descriptor
    variables = model.init(jax.random.PRNGKey(1), pts, train=False, **kwargs)
    if train:
        outs, mutated = model.apply(
            variables, pts, train=True, mutable=["batch_stats"], **kwargs
        )
        return outs, variables, mutated
    outs = model.apply(variables, pts, train=False, **kwargs)
    return outs, variables, None


def test_basic_config_forward():
    cfg = tiny(cfglib.get_config("basic_config"))
    outs, variables, _ = init_and_run(cfg, btotal=4, with_kp=True)
    assert outs["feat"].shape == (4, N, 128)
    assert outs["local_desc"].shape == (4, N, 128)
    # l2-normalized descriptors
    norms = np.linalg.norm(np.asarray(outs["local_desc"]), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)
    assert outs["xyz_sampled"].shape == (4, KP, 3)
    assert outs["feat_sampled"].shape == (4, KP, 128)
    assert "global_desc" not in outs
    assert "attention" not in outs


def test_detection_config_forward():
    cfg = tiny(cfglib.get_config("detection_config"))
    outs, _, _ = init_and_run(cfg, btotal=2, with_kp=True)
    att = np.asarray(outs["attention"])
    assert att.shape == (2, N, 1)
    assert (att >= 0).all() and (att <= 1).all()  # sigmoid (may saturate in f32)
    assert outs["att_sampled"].shape == (2, KP)
    assert outs["xyz_feat_att"].shape == (2, N, 3 + 128 + 1)


def test_global_config_forward():
    cfg = tiny(cfglib.get_config("global_config"))
    outs, _, _ = init_and_run(cfg, btotal=2)
    gd = np.asarray(outs["global_desc"])
    assert gd.shape == (2, 256)
    np.testing.assert_allclose(np.linalg.norm(gd, axis=-1), 1.0, atol=1e-4)


def test_forward_deterministic():
    cfg = tiny(cfglib.get_config("basic_config"))
    cfg.sampled_kpnum = -1
    outs1, variables, _ = init_and_run(cfg, btotal=2)
    model = DH3D(cfg)
    pts = jnp.asarray(np.random.RandomState(0).randn(2, N, 3).astype(np.float32) * 10)
    outs2 = model.apply(variables, pts, train=False)
    np.testing.assert_array_equal(
        np.asarray(outs1["local_desc"]), np.asarray(outs2["local_desc"])
    )


def test_train_mode_updates_batch_stats():
    cfg = tiny(cfglib.get_config("basic_config"))
    cfg.sampled_kpnum = -1
    outs, variables, mutated = init_and_run(cfg, btotal=2, train=True)
    old = jax.tree_util.tree_leaves(variables["batch_stats"])
    new = jax.tree_util.tree_leaves(mutated["batch_stats"])
    assert any(
        not np.allclose(np.asarray(a), np.asarray(b)) for a, b in zip(old, new)
    )


def test_precomputed_knn_input_path():
    """Host-knn input parity (`core/model.py:148-156`)."""
    from dh3d_tpu import ops

    cfg = tiny(cfglib.get_config("basic_config"))
    cfg.sampled_kpnum = -1
    model = DH3D(cfg)
    rng = np.random.RandomState(1)
    pts = jnp.asarray(rng.randn(2, N, 3).astype(np.float32) * 10)
    knn, _ = ops.knn_bruteforce(pts, cfg.knn_num)
    variables = model.init(jax.random.PRNGKey(0), pts, train=False)
    o1 = model.apply(variables, pts, train=False)
    o2 = model.apply(variables, pts, knn_inds=knn, train=False)
    np.testing.assert_allclose(
        np.asarray(o1["local_desc"]), np.asarray(o2["local_desc"]),
        atol=1e-6,
    )


def test_missing_sample_inds_raises():
    cfg = tiny(cfglib.get_config("basic_config"))
    model = DH3D(cfg)
    pts = jnp.zeros((2, N, 3))
    variables = model.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="sample_inds"):
        model.apply(variables, pts, train=False)


def test_softplus_detection_variant():
    cfg = tiny(cfglib.get_config("detection_config"))
    cfg.use_softplus = True
    outs, _, _ = init_and_run(cfg, btotal=2, with_kp=True)
    att = np.asarray(outs["attention"])
    assert (att >= 0).all()
    assert att.max() > 1e-6  # softplus is unbounded above, nonneg


def test_global_conv1d_backbone_variant():
    """global_before_assemble_conv1d (`core/backbones.py:189-196`)."""
    cfg = tiny(cfglib.get_config("global_config"))
    cfg.global_backbone = "global_before_assemble_conv1d"
    outs, _, _ = init_and_run(cfg, btotal=2)
    assert outs["global_desc"].shape == (2, 256)


def test_global_subsample_path():
    """`core/model.py:119-121`: optional FPS subsample before aggregation."""
    cfg = tiny(cfglib.get_config("global_config"))
    cfg.global_subsample = 16
    outs, _, _ = init_and_run(cfg, btotal=2)
    assert outs["global_desc"].shape == (2, 256)


def test_concat_xyz_path():
    cfg = tiny(cfglib.get_config("global_config"))
    cfg.concat_xyz = True
    outs, _, _ = init_and_run(cfg, btotal=2)
    assert outs["global_desc"].shape == (2, 256)


def test_remat_backbone_matches():
    """cfg.remat wraps the backbone in jax.checkpoint — identical outputs."""
    cfg = tiny(cfglib.get_config("basic_config"))
    cfg.sampled_kpnum = -1
    outs1, variables, _ = init_and_run(cfg, btotal=2)
    cfg2 = tiny(cfglib.get_config("basic_config"))
    cfg2.sampled_kpnum = -1
    cfg2.remat = True
    model2 = DH3D(cfg2)
    pts = jnp.asarray(
        np.random.RandomState(0).randn(2, N, 3).astype(np.float32) * 10)
    outs2 = model2.apply(variables, pts, train=False)
    np.testing.assert_allclose(
        np.asarray(outs1["local_desc"]), np.asarray(outs2["local_desc"]),
        atol=1e-6)


def test_morton_order_permutation_invariance(rng):
    """cfg.morton_order sorts points into a canonical Z-order internally,
    which makes the forward INVARIANT to input point order (unlike the
    reference, where FPS seeding depends on it): permuting the input rows
    just permutes the outputs."""
    import jax

    from dh3d_tpu import config as cfglib
    from dh3d_tpu.nn import DH3D

    cfg = cfglib.get_config("global_config")
    cfg.num_points = 64
    cfg.detection = True
    cfg.detection_block = "detection_block"
    cfg.sampled_kpnum = -1
    cfg.morton_order = True
    model = DH3D(cfg)
    pts = rng.randn(2, 64, 3).astype(np.float32) * 10
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                           train=False)
    o1 = model.apply(variables, jnp.asarray(pts), train=False)

    perm = np.stack([rng.permutation(64) for _ in range(2)])
    pts_p = np.stack([pts[b][perm[b]] for b in range(2)])
    o2 = model.apply(variables, jnp.asarray(pts_p), train=False)

    for key in ("local_desc", "attention"):
        a = np.asarray(o1[key])
        b = np.asarray(o2[key])
        a_p = np.stack([a[i][perm[i]] for i in range(2)])
        np.testing.assert_allclose(b, a_p, atol=2e-4, err_msg=key)
    np.testing.assert_allclose(np.asarray(o1["global_desc"]),
                               np.asarray(o2["global_desc"]), atol=2e-4)


def test_morton_order_train_step(rng):
    """Train step with morton_order on: finite, decreasing loss (sorted
    space end-to-end; losses are permutation-equivariant)."""
    import jax

    from dh3d_tpu import config as cfglib
    from dh3d_tpu import train as trainlib

    N, KP = 64, 8
    cfg = cfglib.get_config("detection_config")
    cfg.num_points = N
    cfg.sampled_kpnum = KP
    cfg.batch_size = 2
    cfg.morton_order = True
    cfg.start_lr = 1e-3

    pc1 = rng.randn(2, N, 3).astype(np.float32) * 5
    ang = rng.uniform(-np.pi, np.pi, 2)
    R = np.stack([
        np.array([[np.cos(a), np.sin(a), 0],
                  [-np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
        for a in ang])
    pc2 = np.einsum("bnd,bde->bne", pc1 + rng.randn(2, N, 3) * 0.01, R)
    anc = np.stack([rng.choice(N, KP, replace=False) for _ in range(2)])
    batch = {
        "points": jnp.asarray(np.concatenate([pc1, pc2.astype(np.float32)])),
        "sample_inds": jnp.asarray(np.concatenate([anc, anc]).astype(np.int32)),
        "R": jnp.asarray(R),
    }
    state = trainlib.init_state(cfg, jax.random.PRNGKey(0), batch)
    step = trainlib.make_train_step(cfg)
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["total_cost"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_morton_presorted_matches_ingraph_sort(rng):
    """Already-sorted input + morton_presorted=True must equal the
    in-graph-sort path on the same input (the stable argsort of sorted
    codes is the identity permutation, so both run the same compute)."""
    import jax

    from dh3d_tpu import config as cfglib
    from dh3d_tpu.data.io import morton_sort_np
    from dh3d_tpu.nn import DH3D

    cfg = cfglib.get_config("basic_config")
    cfg.num_points = 64
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    cfg.morton_order = True
    pts = morton_sort_np(rng.randn(2, 64, 3).astype(np.float32) * 5)

    model = DH3D(cfg)
    variables = jax.jit(lambda k, p: model.init(k, p, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(pts))
    out_sort = model.apply(variables, jnp.asarray(pts), train=False)

    cfg2 = cfglib.get_config("basic_config")
    for k, v in (("num_points", 64), ("sampled_kpnum", -1),
                 ("input_R", False), ("morton_order", True),
                 ("morton_presorted", True)):
        cfg2[k] = v
    out_pre = DH3D(cfg2).apply(variables, jnp.asarray(pts), train=False)
    np.testing.assert_allclose(
        np.asarray(out_sort["local_desc"]), np.asarray(out_pre["local_desc"]),
        rtol=1e-5, atol=1e-5)


def test_shared_level_cache_parity():
    """The stage2<->global level-geometry cache is semantics-preserving:
    sharing FPS/kNN/3-NN across the two dilate-8 stages must reproduce
    the unshared forward bit-for-bit (same FPS selection, same gathers;
    `core/backbones.py:104-127,178-186` compute them independently)."""
    cfg = tiny(cfglib.get_config("global_config"))
    cfg.sampled_kpnum = -1
    model = DH3D(cfg)
    rng = np.random.RandomState(3)
    pts = jnp.asarray(rng.randn(2, N, 3).astype(np.float32) * 10)
    variables = model.init(jax.random.PRNGKey(0), pts, train=False)

    cfg_off = cfglib.get_config("global_config")
    for k, v in dict(cfg).items():
        cfg_off[k] = v
    cfg_off.share_level_cache = False

    out_on = model.apply(variables, pts, train=False)
    out_off = DH3D(cfg_off).apply(variables, pts, train=False)
    for k in ("local_desc", "global_desc", "feat"):
        a, b = np.asarray(out_on[k]), np.asarray(out_off[k])
        assert np.array_equal(a, b), f"{k} differs with level cache"


def test_init_variables_matches_full_init():
    """Init is shape-driven: `init_variables(cfg, rng)` needs no cloud, and
    `model.init` with a full-size Morton-routed example returns the same
    tree, shapes, dtypes and values — the trainer, bench and entry points
    all build variables through it."""
    from dh3d_tpu.nn import init_variables

    cfg = tiny(cfglib.get_config("detection_config"))
    cfg.num_points = 1024
    cfg.morton_order = True
    model = DH3D(cfg)

    rng = np.random.RandomState(0)
    pts = jnp.asarray(rng.randn(2, 1024, 3).astype(np.float32) * 10)
    inds = jnp.asarray(rng.randint(0, 1024, (2, KP)).astype(np.int32))
    full = model.init(jax.random.PRNGKey(0), pts, sample_inds=inds,
                      train=False)
    cheap = init_variables(cfg, jax.random.PRNGKey(0))

    full_s = jax.tree.map(lambda x: (x.shape, str(x.dtype)), full)
    cheap_s = jax.tree.map(lambda x: (x.shape, str(x.dtype)), cheap)
    assert jax.tree_util.tree_structure(full_s) == \
        jax.tree_util.tree_structure(cheap_s)
    assert full_s == cheap_s
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(full["params"]),
            jax.tree_util.tree_leaves_with_path(cheap["params"])):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the variables drive the full-size forward
    outs = model.apply(full, pts, sample_inds=inds, train=False)
    assert outs["attention"].shape == (2, 1024, 1)


GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_forward.npz")
MODELS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "models")


@pytest.mark.parametrize("stem", ["demo_stage2", "demo_stage3"])
def test_param_paths_match_checkpoint(stem):
    """The shape-driven init yields exactly the variable paths and shapes
    of the committed checkpoint, so `models/*.npz` load unchanged."""
    from dh3d_tpu.nn import init_variables
    from dh3d_tpu.train import flatten_tree

    cfg = cfglib.load_config(os.path.join(MODELS, stem + ".config.json"))
    variables = init_variables(cfg, jax.random.PRNGKey(0))
    flat = {}
    flatten_tree(variables["params"], "params", flat)
    flatten_tree(variables["batch_stats"], "batch_stats", flat)
    ckpt = np.load(os.path.join(MODELS, stem + ".npz"))
    want = {k: ckpt[k].shape for k in ckpt.files if k != "step"}
    assert {k: v.shape for k, v in flat.items()} == want


@pytest.mark.parametrize("stem", ["demo_stage2", "demo_stage3"])
def test_golden_forward(stem):
    """Eval forward of a committed checkpoint reproduces the recorded
    outputs of the original Flax implementation (tests/data, made with
    the same weights on CPU: clouds uniform in [-2, 2]^3 from seed 0 and
    1, 1024 points, Morton order, every 16th point kept)."""
    from dh3d_tpu.train import resolve_model

    g = np.load(GOLDEN)
    cfg, variables = resolve_model(os.path.join(MODELS, stem))
    cfg.num_points = 1024
    cfg.sampled_kpnum = -1
    cfg.morton_presorted = False
    with jax.default_matmul_precision("highest"):
        outs = DH3D(cfg).apply(variables, jnp.asarray(g[f"{stem}/points"]),
                               train=False)
    got = {"local_desc": np.asarray(outs["local_desc"])[:, ::16]}
    if cfg.detection:
        got["attention"] = np.asarray(outs["attention"])[:, ::16, 0]
    if cfg.extract_global:
        got["global_desc"] = np.asarray(outs["global_desc"])
    assert sorted(f"{stem}/{k}" for k in got) == sorted(
        k for k in g.files if k.startswith(stem) and not k.endswith("points"))
    for k, v in got.items():
        np.testing.assert_allclose(v, g[f"{stem}/{k}"], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
