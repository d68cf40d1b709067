#!/usr/bin/env python
"""Eval forward at 20 x 8192 with the FPS Triton kernel against the same
forward with the XLA FPS loop, on one GPU, in one process.

    python scripts/fps_forward_ab.py [--rounds 6]

The XLA variant is traced with `dh3d_tpu.ops.sampling.farthest_point_sample`
swapped for `_fps_xla`; both executables are compiled first, then timed in
alternating rounds (kernel, xla, xla, kernel, ...), each round the median
of 5 calls ending in block_until_ready.  Uses the committed stage-3
checkpoint (local backbone + global head).
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import REPO, nvidia_smi, seeded_clouds, time_call  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("fps_forward_ab: needs a GPU")
    from dh3d_tpu import train as trainlib
    from dh3d_tpu.compile_cache import enable_compile_cache
    from dh3d_tpu.nn import DH3D
    from dh3d_tpu.ops import sampling

    enable_compile_cache()
    print(nvidia_smi(), flush=True)
    cfg, variables = trainlib.resolve_model(
        os.path.join(REPO, "models", "demo_stage3"))
    cfg.num_points, cfg.sampled_kpnum, cfg.morton_presorted = 8192, -1, False
    model = DH3D(cfg)
    variables = jax.device_put(variables)
    pts = jax.device_put(seeded_clouds(20, 8192, 0))

    fwd = {"kernel": jax.jit(lambda v, p: model.apply(v, p, train=False))}
    jax.block_until_ready(fwd["kernel"](variables, pts))
    original = sampling.farthest_point_sample
    sampling.farthest_point_sample = sampling._fps_xla
    try:
        fwd["xla"] = jax.jit(lambda v, p: model.apply(v, p, train=False))
        jax.block_until_ready(fwd["xla"](variables, pts))
    finally:
        sampling.farthest_point_sample = original
    a = fwd["kernel"](variables, pts)["global_desc"]
    b = fwd["xla"](variables, pts)["global_desc"]
    print(f"global_desc kernel vs xla: max diff "
          f"{float(np.abs(np.asarray(a) - np.asarray(b)).max()):.2e}")

    ms = {"kernel": [], "xla": []}
    order = ["kernel", "xla", "xla", "kernel"]
    for r in range(args.rounds):
        name = order[r % 4]
        ms[name].append(time_call(fwd[name], variables, pts) * 1e3)
    print(json.dumps({k: {"median_ms": float(np.median(v)),
                          "runs_ms": [round(x, 3) for x in v]}
                      for k, v in ms.items()}), flush=True)


if __name__ == "__main__":
    main()
