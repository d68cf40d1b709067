"""Tests that need an NVIDIA GPU: the compiled FPS kernel, its dispatch,
and the card's gradient numerics.  They skip elsewhere; `python
chip_smoke.py` runs them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dh3d_tpu import ops

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _on_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("B,N,npoint", [(2, 100, 17), (3, 4096, 256),
                                        (1, 8192, 1024)])
def test_fps_kernel_compiled_matches_xla(B, N, npoint):
    from dh3d_tpu.ops.sampling import _fps_xla, fps_triton

    pts = jnp.asarray(np.random.RandomState(B).uniform(
        -1, 1, (B, N, 3)).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(fps_triton(pts, npoint)),
                                  np.asarray(_fps_xla(pts, npoint)))


def test_fps_dispatch_uses_kernel_on_gpu():
    pts = jnp.zeros((2, 256, 3), jnp.float32)
    text = jax.jit(lambda p: ops.farthest_point_sample(p, 32)).lower(
        pts).as_text()
    assert "triton" in text


def test_flex_conv_grad_run_to_run():
    """The gather's VJP is a scatter-add, which the GPU may run with
    atomics: two runs may differ by float reassociation only (<= 1e-5 of
    the gradient's scale; K=8 neighbours, f32)."""
    rng = np.random.RandomState(0)
    pts = jnp.asarray(rng.uniform(-1, 1, (4, 8192, 3)).astype(np.float32))
    feat = jnp.asarray(rng.randn(4, 8192, 64).astype(np.float32))
    theta = jnp.asarray(rng.randn(3, 64, 64).astype(np.float32) * 0.1)
    bias = jnp.asarray(rng.randn(64, 64).astype(np.float32) * 0.1)
    nbh, _ = ops.knn_bruteforce(pts, 8)
    grad = jax.jit(jax.grad(lambda f: jnp.sum(
        ops.flex_conv(f, pts, nbh, theta, bias) ** 2)))
    g1, g2 = np.asarray(grad(feat)), np.asarray(grad(feat))
    assert np.abs(g1 - g2).max() <= 1e-5 * np.abs(g1).max()


def test_detection_train_step_on_card():
    from dh3d_tpu import config as cfglib
    from dh3d_tpu import train as trainlib
    import train as train_cli

    cfg = cfglib.get_config("detection_config")
    cfg.update(batch_size=2, num_points=1024, sampled_kpnum=64)
    batch = next(train_cli.synthetic_local_batches(cfg, 0))
    state = trainlib.init_state(cfg, jax.random.PRNGKey(0))
    step = trainlib.make_train_step(cfg)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["total_cost"]))
    assert np.isfinite(losses).all()
