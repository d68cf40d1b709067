#!/usr/bin/env python
"""Smoke test of the DH3D main path on NVIDIA GPUs, at full width.

    python chip_smoke.py          # phases 1-4 on one card, then the card tests
    python chip_smoke.py --four   # only the four-card data-parallel checks

Phases (one process; every phase that fails stops the run with a
nonzero exit):
  1. card     nvidia-smi name and power limit, device kind, JAX version,
              whether the native host library is built;
  2. kernels  the FPS Triton kernel against the XLA loop, and kNN against
              a float64 oracle, at the model's shapes, with their times;
  3. forward  the eval forward of both committed checkpoints at 20 x 8192,
              against the same weights on the CPU device;
  4. train    train steps of the detection and the global stage at the
              reference batches; run-to-run gradient spread; memory.
Then the tests marked `gpu` run in this process.

The script exits nonzero before any phase when JAX's first device is not
a GPU.  Its last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Tolerances of the card-vs-reference comparisons, in units of the
# outputs (descriptor entries are ~0.09, attention and global entries
# are in [0, 1]).
#  - TOL_HIGHEST: card vs CPU, both at "highest" matmul precision.  Only
#    summation order and FMA contraction differ, ~1e-6 relative per
#    layer; 1e-4 leaves two orders of margin and is far below the O(0.1)
#    error of any wrong op.
#  - TOL_TF32: card at default precision (TF32 in the dense layers: 10
#    mantissa bits, ~1e-3 relative per product) vs card at "highest".
#  - BAD_POINT_SHARE: a kNN set or FPS pick decided by a float near-tie
#    can flip between two backends and move that point's descriptor by
#    O(0.1); at most this share of points may exceed the tolerance.
TOL_HIGHEST = 1e-4
TOL_TF32 = 3e-2
BAD_POINT_SHARE = 2e-3
# kNN ties: the matmul identity |q|^2 - 2 q.n + |n|^2 in float32 has an
# absolute error of a few ulp of the squared norms (~6e-7 S, S the
# cloud's largest squared norm); two candidates closer than 2e-6 S are a
# tie at float32 resolution and may come in either order.
KNN_TIE_SCALE = 2e-6

REPO = os.path.dirname(os.path.abspath(__file__))
MODELS = ("models/demo_stage2", "models/demo_stage3")


def log(msg):
    print(msg, flush=True)


def seeded_clouds(b, n, seed):
    """Clouds in the unit cube (the normalized-submap scale)."""
    return np.random.RandomState(seed).uniform(
        -1.0, 1.0, (b, n, 3)).astype(np.float32)


def time_call(fn, *args, reps=5):
    """Median wall seconds of fn(*args) after one warm-up call, each call
    ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ------------------------------- phase 1 -------------------------------

def nvidia_smi():
    """`name, power.limit` of each card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def phase_card():
    import jax

    from dh3d_tpu import native

    log(nvidia_smi())
    d = jax.devices()[0]
    log(f"[card] device_kind={d.device_kind} count={len(jax.devices())} "
        f"jax={jax.__version__} native_host_library={native.available()}")


# ------------------------------- phase 2 -------------------------------

def check_knn(idx, pts, queries, k):
    """kNN indices against a float64 oracle on the sampled (cloud, point)
    queries: self at slot 0 and equal indices, where a swap is accepted
    only between candidates whose float64 distances tie within
    KNN_TIE_SCALE.  Returns the number of such tie swaps."""
    ties = 0
    for b, n in queries:
        cloud = pts[b].astype(np.float64)
        d = np.sum((cloud - cloud[n]) ** 2, axis=-1)
        want = np.argsort(d, kind="stable")[:k]
        got = idx[b, n]
        if got[0] != n:
            raise AssertionError(f"kNN self not at slot 0: cloud {b} "
                                 f"point {n} -> {got}")
        if (got == want).all():
            continue
        tol = KNN_TIE_SCALE * np.max(np.sum(cloud ** 2, axis=-1))
        if not np.allclose(d[got], d[want], rtol=0, atol=tol):
            raise AssertionError(
                f"kNN mismatch at cloud {b} point {n}: {got} vs {want} "
                f"(d {d[got]} vs {d[want]})")
        ties += 1
    return ties


def phase_kernels(batch=20, num_points=8192, npoints=(1024, 512), k=8,
                  n_queries=256, interpret=False, seed=0):
    """FPS kernel == XLA FPS (indices equal: on seeded float inputs exact
    ties have measure zero, and both round the same expression); kNN
    against the float64 oracle.  Prints each op's time."""
    import jax
    import jax.numpy as jnp

    from dh3d_tpu import ops
    from dh3d_tpu.ops.sampling import _fps_xla, fps_triton

    pts_np = seeded_clouds(batch, num_points, seed)
    pts = jnp.asarray(pts_np)
    times = {}
    for m in npoints:
        kern = jax.jit(lambda p, m=m: fps_triton(p, m, interpret=interpret))
        xla = jax.jit(lambda p, m=m: _fps_xla(p, m))
        a, b = np.asarray(kern(pts)), np.asarray(xla(pts))
        if not (a == b).all():
            bad = np.argwhere(a != b)[0]
            raise AssertionError(f"FPS kernel != XLA FPS at [{batch},"
                                 f"{num_points}]->{m}, first at {bad}")
        times[f"fps_triton_{m}_ms"] = time_call(kern, pts) * 1e3
        times[f"fps_xla_{m}_ms"] = time_call(xla, pts) * 1e3
        log(f"[kernels] fps [{batch},{num_points}]->{m}: indices equal; "
            f"triton {times[f'fps_triton_{m}_ms']:.3f} ms, "
            f"xla {times[f'fps_xla_{m}_ms']:.3f} ms")

    knn = jax.jit(lambda p: ops.knn_bruteforce(p, k))
    idx = np.asarray(knn(pts)[0])
    rng = np.random.RandomState(seed + 1)
    queries = list(zip(rng.randint(0, batch, n_queries),
                       rng.randint(0, num_points, n_queries)))
    ties = check_knn(idx, pts_np, queries, k)
    times[f"knn_k{k}_ms"] = time_call(knn, pts) * 1e3
    log(f"[kernels] knn [{batch},{num_points},k={k}]: {n_queries} sampled "
        f"queries match the float64 oracle ({ties} float-tie swaps), "
        f"self at slot 0; {times[f'knn_k{k}_ms']:.3f} ms")
    return times


# ------------------------------- phase 3 -------------------------------

def compare(name, got, want, tol):
    """Per-point max |got - want| <= tol for all but BAD_POINT_SHARE of
    the points ([B, N, ...] arrays), or everywhere ([B, D] arrays)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    if diff.ndim >= 3:
        per_point = diff.reshape(diff.shape[0], diff.shape[1], -1).max(-1)
        share = float(np.mean(per_point > tol))
        ok = share <= BAD_POINT_SHARE
        detail = (f"median {np.median(per_point):.2e}, max "
                  f"{per_point.max():.2e}, share over tol {share:.2e}")
    else:
        ok = bool(diff.max() <= tol)
        detail = f"max {diff.max():.2e}"
    log(f"[forward]   {name}: {detail} (tol {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside tolerance: {detail}")


def phase_forward(batch=20, num_points=8192, n_cmp=2, models=MODELS,
                  seed=0):
    """Eval forward of each committed checkpoint on the default device:
    finite outputs of the right shapes; then `n_cmp` clouds against the
    CPU device under "highest", and default precision vs "highest"."""
    import jax

    from dh3d_tpu import train as trainlib
    from dh3d_tpu.nn import DH3D

    pts_np = seeded_clouds(batch, num_points, seed)
    pts = jax.device_put(pts_np)
    times = {}
    for stem in models:
        cfg, host_vars = trainlib.resolve_model(os.path.join(REPO, stem))
        variables = jax.device_put(host_vars)
        cfg.num_points = num_points
        cfg.sampled_kpnum = -1
        cfg.morton_presorted = False
        model = DH3D(cfg)
        fwd = jax.jit(lambda v, p: model.apply(v, p, train=False))
        keys = ["local_desc"] + (["attention"] if cfg.detection else []) \
            + (["global_desc"] if cfg.extract_global else [])

        outs = fwd(variables, pts)
        for key in keys:
            o = np.asarray(outs[key])
            want = {"local_desc": (batch, num_points, cfg.featdim),
                    "attention": (batch, num_points, 1),
                    "global_desc": (batch, 256)}[key]
            if o.shape != want or not np.isfinite(o).all():
                raise AssertionError(f"{stem} {key}: shape {o.shape} "
                                     f"(want {want}) finite "
                                     f"{np.isfinite(o).all()}")
        name = os.path.basename(stem)
        times[f"{name}_fwd_ms"] = time_call(fwd, variables, pts) * 1e3
        log(f"[forward] {name} {batch}x{num_points}: finite, shapes ok; "
            f"{times[f'{name}_fwd_ms']:.2f} ms "
            f"({batch / times[f'{name}_fwd_ms'] * 1e3:.1f} clouds/s)")

        sub = pts[:n_cmp]
        cpu = jax.devices("cpu")[0]
        with jax.default_matmul_precision("highest"):
            hi = fwd(variables, sub)
            ref = fwd(jax.device_put(host_vars, cpu),
                      jax.device_put(pts_np[:n_cmp], cpu))
        lo = fwd(variables, sub)
        for key in keys:
            compare(f"{name} {key} device vs cpu (highest)",
                    hi[key], ref[key], TOL_HIGHEST)
            compare(f"{name} {key} default vs highest precision",
                    lo[key], hi[key], TOL_TF32)
    return times


# ------------------------------- phase 4 -------------------------------

def _tree_max_diff(a, b):
    import jax

    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))


def _memory(step, state, batch, device):
    mem = step.lower(state, batch).compile().memory_analysis()
    stats = device.memory_stats() or {}
    gib = 2.0 ** 30
    return (f"args {mem.argument_size_in_bytes / gib:.2f} GiB, temp "
            f"{mem.temp_size_in_bytes / gib:.2f} GiB, out "
            f"{mem.output_size_in_bytes / gib:.2f} GiB; peak_bytes_in_use "
            f"{stats.get('peak_bytes_in_use', 0) / gib:.2f} GiB")


def run_train(cfg_name, steps, overrides, seed=0):
    """`steps` train steps of a preset on train.py's synthetic batches:
    finite losses, changed trainable params, run-to-run gradient spread
    of one step, memory.  Returns (ms per step, max grad difference)."""
    import jax

    import train as train_cli
    from dh3d_tpu import config as cfglib
    from dh3d_tpu import train as trainlib
    from dh3d_tpu.nn import DH3D

    cfg = cfglib.get_config(cfg_name)
    cfg.update(overrides)
    gen = (train_cli.synthetic_local_batches(cfg, seed) if cfg.training_local
           else train_cli.synthetic_global_batches(cfg, seed))
    batches = [jax.device_put(next(gen)) for _ in range(steps)]
    state0 = trainlib.init_state(cfg, jax.random.PRNGKey(seed))
    step = trainlib.make_train_step(cfg)

    state, losses = state0, []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["total_cost"]))
    if not np.isfinite(losses).all():
        raise AssertionError(f"{cfg_name}: non-finite losses {losses}")
    labels = trainlib.param_labels(cfg, state0.params)
    moved = [float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
             for a, b, lab in zip(jax.tree_util.tree_leaves(state.params),
                                  jax.tree_util.tree_leaves(state0.params),
                                  jax.tree_util.tree_leaves(labels))
             if lab == "trainable"]
    if not moved or max(moved) == 0.0:
        raise AssertionError(f"{cfg_name}: trainable params did not change")

    model = DH3D(cfg)
    grad = jax.jit(jax.grad(
        lambda p, bs, b: trainlib.trainer.loss_and_updates(
            p, bs, b, cfg, model)[0]))
    g1 = grad(state0.params, state0.batch_stats, batches[0])
    g2 = grad(state0.params, state0.batch_stats, batches[0])
    gdiff = _tree_max_diff(g1, g2)
    gscale = max(float(np.max(np.abs(np.asarray(x))))
                 for x in jax.tree_util.tree_leaves(g1))
    ms = time_call(step, state0, batches[0], reps=3) * 1e3
    clouds = batches[0]["points"].shape[0]
    log(f"[train] {cfg_name} {clouds}x{cfg.num_points}: losses "
        f"{[round(x, 5) for x in losses]}; trainable params moved (max "
        f"{max(moved):.2e}); {ms:.2f} ms/step "
        f"({clouds / ms * 1e3:.1f} clouds/s); same step twice: max grad "
        f"difference {gdiff:.3e} (largest gradient entry {gscale:.3e})")
    log(f"[train]   memory: {_memory(step, state0, batches[0], jax.devices()[0])}")
    return ms, gdiff


def phase_train(pairs=10, tuples=2, num_points=8192, kp=512, seed=0):
    """Detection stage at the reference batch (10 pairs x 8192, 512
    keypoints), then the stage-3 global step (2 tuples x 12 clouds)."""
    det = run_train("detection_config", 3, dict(
        batch_size=pairs, num_points=num_points, sampled_kpnum=kp), seed)
    glo = run_train("global_config", 2, dict(
        batch_size=tuples, num_points=num_points), seed)
    return det, glo


# ------------------------------ four cards ------------------------------

def four_card_checks(devices, pairs_per_card=10, num_points=8192, kp=512,
                     seed=0):
    """Data-parallel checks on a 1-D ("data",) mesh over `devices` (the
    cards are joined all to all, so the mesh follows the algorithm): each
    result against the same computation on devices[0] alone, both at
    "highest" matmul precision.  At default precision the per-card and
    whole-batch programs pick other GEMM kernels whose TF32 roundings
    differ: the stage-3 loss then moved by 1.0e-3 relative on four H100s.

      - one detection_config train step, `pairs_per_card` pairs per card:
        every scalar metric within 1e-3 relative (the same sums taken in
        another order across the gradient all-reduce);
      - point-sharded kNN: where it differs from single-device kNN, both
        match a float64 oracle up to float ties;
      - one global_config step with cross-device batch-hard mining, one
        tuple per card: every scalar metric within 1e-3 relative.
    """
    import jax
    from jax.sharding import Mesh

    import train as train_cli
    from dh3d_tpu import config as cfglib
    from dh3d_tpu import ops
    from dh3d_tpu import train as trainlib
    from dh3d_tpu.parallel.mesh import replicate, shard_batch
    from dh3d_tpu.parallel.sharded_knn import knn_sharded

    n = len(devices)
    mesh = Mesh(np.array(devices), axis_names=("data",))
    one = devices[0]

    def step_both(cfg, batch):
        state = trainlib.init_state(cfg, jax.random.PRNGKey(seed))
        step = trainlib.make_train_step(cfg)
        with jax.default_matmul_precision("highest"):
            _, m1 = step(jax.device_put(state, one),
                         jax.device_put(batch, one))
            m1 = {k: float(v) for k, v in m1.items()}
            with jax.sharding.set_mesh(mesh):
                _, mn = step(replicate(mesh, state),
                             shard_batch(mesh, batch))
                mn = {k: float(v) for k, v in mn.items()}
        return m1, mn

    def close(name, m1, mn):
        for k in m1:
            if not abs(mn[k] - m1[k]) <= 1e-3 * max(1.0, abs(m1[k])):
                raise AssertionError(f"{name} {k}: {n} cards {mn[k]} vs "
                                     f"one card {m1[k]}")
        log(f"[four] {name}: {n} cards == one card "
            f"(total_cost {mn['total_cost']:.6f} vs {m1['total_cost']:.6f})")

    cfg = cfglib.get_config("detection_config")
    cfg.update(batch_size=pairs_per_card * n, num_points=num_points,
               sampled_kpnum=kp)
    batch = next(train_cli.synthetic_local_batches(cfg, seed))
    close(f"detection step {2 * cfg.batch_size}x{num_points}",
          *step_both(cfg, batch))

    pts_np = seeded_clouds(2, num_points, seed)
    idx_n = np.asarray(knn_sharded(pts_np, 8, mesh)[0])
    idx_1 = np.asarray(ops.knn_bruteforce(jax.device_put(pts_np, one), 8)[0])
    queries = [(b, p) for b in range(2) for p in range(num_points)]
    differ = [(b, p) for b, p in queries
              if (idx_n[b, p] != idx_1[b, p]).any()]
    ties = (check_knn(idx_n, pts_np, differ, 8)
            + check_knn(idx_1, pts_np, differ, 8))
    log(f"[four] sharded knn [2,{num_points},k=8]: equals one card except "
        f"at {len(differ)} points, where both match the float64 oracle up "
        f"to {ties} float-tie swaps")

    gcfg = cfglib.get_config("global_config")
    gcfg.update(batch_size=n, num_points=num_points,
                cross_device_mining=True)
    gbatch = next(train_cli.synthetic_global_batches(gcfg, seed))
    close(f"global step, cross-device mining, "
          f"{gbatch['points'].shape[0]}x{num_points}",
          *step_both(gcfg, gbatch))


# -------------------------------- main ---------------------------------

def run_card_tests():
    """The tests marked `gpu`, in this process (a second process could
    not get the card's memory)."""
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--noconftest",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    if rc != 0:
        raise SystemExit(f"card tests failed (pytest exit {int(rc)})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card data-parallel checks")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    from dh3d_tpu.compile_cache import enable_compile_cache

    log(f"[setup] compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    phase_card()
    if args.four:
        if len(devices) < 4:
            print(f"chip_smoke --four: needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        devices = devices[:4]
        four_card_checks(devices)
    else:
        devices = devices[:1]
        phase_kernels()
        phase_forward()
        phase_train()
        run_card_tests()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
