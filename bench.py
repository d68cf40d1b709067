#!/usr/bin/env python
"""Benchmark of the DH3D main path on one NVIDIA GPU.

    python bench.py

Workloads (seeded inputs, one process, each timed with block_until_ready
after a warm-up call; the median of the timed calls is reported):
  fwd     eval forward, local backbone + detector + global NetVLAD
          descriptor, 20 clouds x 8192 points (clouds/s);
  train   detection_config train step (fwd + bwd + Adam) at the reference
          batch, 10 pairs x 8192 points, 512 keypoints (clouds/s);
  knn     kNN k=8 at [20, 8192] (ms);
  flex    flex_conv 64 -> 64 at [20, 8192], k=8 (ms).

Fails when JAX's first device is not a GPU.  Prints the device (platform,
device_kind, count, nvidia-smi name and power limit) and then one JSON
line with every result.
"""

import json
import sys

import numpy as np

from chip_smoke import nvidia_smi, seeded_clouds, time_call

B, N, K, KP = 20, 8192, 8, 512


def bench_forward(jax):
    from dh3d_tpu import config as cfglib
    from dh3d_tpu.nn import DH3D, init_variables

    cfg = cfglib.get_config("global_config")
    cfg.num_points = N
    cfg.detection = True
    model = DH3D(cfg)
    variables = jax.device_put(init_variables(cfg, jax.random.PRNGKey(0)))
    points = jax.device_put(seeded_clouds(B, N, 0))
    fwd = jax.jit(lambda v, p: model.apply(v, p, train=False))
    return B / time_call(fwd, variables, points)


def bench_train_step(jax):
    import train as train_cli
    from dh3d_tpu import config as cfglib
    from dh3d_tpu import train as trainlib

    cfg = cfglib.get_config("detection_config")
    cfg.update(batch_size=B // 2, num_points=N, sampled_kpnum=KP)
    batch = jax.device_put(next(train_cli.synthetic_local_batches(cfg, 0)))
    state = trainlib.init_state(cfg, jax.random.PRNGKey(0))
    step = trainlib.make_train_step(cfg)
    return B / time_call(step, state, batch, reps=3)


def bench_knn(jax):
    from dh3d_tpu import ops

    pts = jax.device_put(seeded_clouds(B, N, 0))
    return time_call(jax.jit(lambda p: ops.knn_bruteforce(p, K)), pts) * 1e3


def bench_flex_conv(jax, cin=64, cout=64):
    from dh3d_tpu import ops

    rng = np.random.RandomState(0)
    pts = jax.device_put(seeded_clouds(B, N, 0))
    feat = jax.device_put(rng.randn(B, N, cin).astype(np.float32))
    theta = jax.device_put(rng.randn(3, cin, cout).astype(np.float32) * 0.05)
    bias = jax.device_put(rng.randn(cin, cout).astype(np.float32) * 0.05)
    nbh, _ = ops.knn_bruteforce(pts, K)
    fc = jax.jit(ops.flex_conv)
    return time_call(fc, feat, pts, nbh, theta, bias) * 1e3


def main():
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {d.platform}", file=sys.stderr)
        return 2
    from dh3d_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = nvidia_smi().splitlines()[0]
    print(card, flush=True)
    result = {
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices()), "nvidia_smi": card},
        f"fwd_clouds_per_s@{B}x{N}": bench_forward(jax),
        f"train_detection_clouds_per_s@{B}x{N}": bench_train_step(jax),
        f"knn_k{K}_ms@{B}x{N}": bench_knn(jax),
        f"flex_conv_64x64_ms@{B}x{N}": bench_flex_conv(jax),
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
