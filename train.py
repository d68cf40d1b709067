#!/usr/bin/env python
"""Training driver: `python train.py --cfg=basic_config` — the reference
CLI surface (`train.py:58-75`) on top of the JAX stack.

Differences from the reference trainer (tensorpack SimpleTrainer):
one jitted train step over a data-parallel mesh, `.npz` checkpoints every
`savemodel_every_k_steps` (`core/configs.py:84`), config.json dumped into
the logdir as the eval-time source of truth (`core/utils.py:71-84`),
warm start with shape-mismatch tolerance via --load (`train.py:52-53`).

`--synthetic` runs on generated self-pair data for smoke testing without a
dataset on disk.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def synthetic_local_batches(cfg, seed=0):
    """Endless synthetic self-pair batches (rotated jittered copies)."""
    rng = np.random.RandomState(seed)
    B, N, M = cfg.batch_size, cfg.num_points, cfg.sampled_kpnum
    while True:
        pc1 = rng.randn(B, N, 3).astype(np.float32) * 20
        ang = rng.uniform(-np.pi, np.pi, B)
        R = np.stack([
            np.array([[np.cos(a), np.sin(a), 0],
                      [-np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
            for a in ang
        ])
        pc2 = np.einsum(
            "bnd,bde->bne", pc1 + rng.randn(B, N, 3) * 0.02, R
        ).astype(np.float32)
        anc = np.stack([rng.choice(N, M, replace=False) for _ in range(B)])
        yield {
            "points": np.concatenate([pc1, pc2]),
            "sample_inds": np.concatenate([anc, anc]).astype(np.int32),
            "R": R.astype(np.float32),
        }


def synthetic_global_batches(cfg, seed=0):
    rng = np.random.RandomState(seed)
    B, N = cfg.batch_size, cfg.num_points
    total = B * (1 + cfg.num_pos + cfg.num_neg + (1 if cfg.other_neg else 0))
    while True:
        yield {"points": rng.randn(total, N, 3).astype(np.float32) * 20}


def real_batches(cfg, seed=0):
    from dh3d_tpu.data import GlobalTrainTriplet, LocalTrainSelfPair

    def presort(gen):
        """Host-side Morton sort in the loader (prefetch-hidden) so the
        jitted step skips its in-graph argsort (cfg.morton_presorted)."""
        from dh3d_tpu.data.io import morton_sort_np

        for batch in gen:
            yield {k: (morton_sort_np(v)
                       if k in ("points", "pc1", "pc2") else v)
                   for k, v in batch.items()}

    if cfg.training_local:
        ds = LocalTrainSelfPair(
            seed=seed,
            basedir=cfg.data_basedir,
            train_file=os.path.join(cfg.data_basedir,
                                    "oxford_train_local_gt.pickle"),
            numpts=cfg.num_points,
            sample_nodes=cfg.sampled_kpnum,
            # with on-device augmentation the host loader must not also
            # augment (the jitted step applies cfg.data_aug itself)
            aug=() if (cfg.device_pairgen and cfg.augment_on_device)
            else cfg.data_aug,
        )
        while True:
            if cfg.device_pairgen:
                # host does load+normalize only; rotation/FPS/1-NN run
                # inside the jitted step (dh3d_tpu/data/pairgen.py)
                gen = ds.raw_batches(cfg.batch_size)
                yield from (presort(gen) if cfg.morton_presorted else gen)
            else:
                assert not cfg.morton_presorted, (
                    "morton_presorted requires device_pairgen for local "
                    "training (host sample_inds are in load order)")
                yield from ds.batches(cfg.batch_size)
    else:
        ds = GlobalTrainTriplet(
            seed=seed,
            basedir=cfg.data_basedir,
            train_file=os.path.join(cfg.data_basedir,
                                    "oxford_train_global_gt.pickle"),
            posnum=cfg.num_pos,
            negnum=cfg.num_neg,
            numpts=cfg.num_points,
            other_neg=cfg.other_neg,
            aug=cfg.data_aug,
        )
        while True:
            gen = ds.batches(cfg.batch_size)
            yield from (presort(gen) if cfg.morton_presorted else gen)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True,
                        help="basic_config | detection_config | global_config")
    parser.add_argument("--logdir", default=None)
    parser.add_argument("--load", default=None,
                        help="checkpoint path for warm start (SmartInit)")
    parser.add_argument("--resume", default=None,
                        help="checkpoint path for exact resume (params + "
                             "optimizer state + step)")
    parser.add_argument("--profile", action="store_true",
                        help="capture a jax.profiler trace of steps 10-15 "
                             "into <logdir>/profile")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds model init, the data sampler order, and "
                             "the on-device pairgen/augment key streams")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--data_basedir", default=None)
    parser.add_argument("--num_points", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--num_devices", type=int, default=None)
    parser.add_argument("--device_pairgen", action="store_true",
                        help="generate local-pair rotation/anchors/"
                             "correspondences inside the jitted step")
    parser.add_argument("--set", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="override any config key (JSON-parsed value),"
                             " e.g. --set grad_clip_norm=1.0 "
                             "--set morton_order=false")
    args = parser.parse_args()

    import jax

    from dh3d_tpu import config as cfglib
    from dh3d_tpu import train as trainlib
    from dh3d_tpu.compile_cache import enable_compile_cache
    from dh3d_tpu.parallel import data_parallel_mesh
    from dh3d_tpu.parallel.mesh import replicate, shard_batch

    enable_compile_cache()
    cfg = cfglib.get_config(args.cfg)
    for key in ("data_basedir", "num_points", "batch_size"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
    if args.device_pairgen:
        cfg.device_pairgen = True
    for kv in args.set:
        key, _, value = kv.partition("=")
        try:
            cfg[key] = json.loads(value)
        except json.JSONDecodeError:
            cfg[key] = value
        print(f"config override: {key} = {cfg[key]!r}")

    logdir = args.logdir or os.path.join(
        "train_log", f"{args.cfg}_{time.strftime('%m%d-%H%M%S')}"
    )
    os.makedirs(logdir, exist_ok=True)
    cfglib.save_config(cfg, os.path.join(logdir, "config.json"))

    batches = (
        (synthetic_local_batches(cfg, args.seed) if cfg.training_local
         else synthetic_global_batches(cfg, args.seed))
        if args.synthetic else real_batches(cfg, args.seed)
    )
    if (cfg.prefetch or 0) > 0 and not args.synthetic:
        from dh3d_tpu.data import ThreadedPrefetcher

        batches = ThreadedPrefetcher(batches, depth=cfg.prefetch)
    first = next(batches)

    n_dev = args.num_devices or len(jax.devices())
    mesh = data_parallel_mesh(n_dev)
    print(f"mesh: {mesh}; logdir: {logdir}")

    metrics_log = open(os.path.join(logdir, "metrics.jsonl"), "a")
    with jax.sharding.set_mesh(mesh):
        state = trainlib.init_state(
            cfg, jax.random.PRNGKey(args.seed), first)
        if args.resume:
            state = trainlib.restore_state(args.resume, state)
            print(f"resumed at step {int(state.step)} from {args.resume}")
        elif args.load:
            loaded = trainlib.load_checkpoint(args.load)
            params, n = trainlib.smart_init(state.params, loaded["params"])
            state = state.replace(params=params)
            print(f"warm start: restored {n} tensors from {args.load}")
        state = replicate(mesh, state)

        step_fn = trainlib.make_train_step(cfg, donate=True)
        t0 = time.time()
        start = int(state.step)
        pg_key = jax.random.PRNGKey(1000 + args.seed)
        aug_key = jax.random.PRNGKey(2000 + args.seed)
        for i in range(start, start + args.steps):
            batch = dict(first if i == start else next(batches))
            if cfg.device_pairgen and "pc1" in batch:
                batch["pairgen_key"] = jax.random.fold_in(pg_key, i)
            if cfg.augment_on_device and (
                    not cfg.training_local or "pc1" in batch):
                # local host-pairgen batches must NOT be re-augmented on
                # device: the correspondences were built from the already-
                # augmented clouds (trainer docstring)
                batch["aug_key"] = jax.random.fold_in(aug_key, i)
            batch = shard_batch(mesh, batch)
            if args.profile and i == start + 10:
                jax.profiler.start_trace(os.path.join(logdir, "profile"))
            state, metrics = step_fn(state, batch)
            if args.profile and i == start + 15:
                jax.block_until_ready(metrics)
                jax.profiler.stop_trace()
            if i % 50 == 0 or i == start + args.steps - 1:
                m = {k: round(float(v), 5) for k, v in metrics.items()}
                m["step"] = i
                m["wall_s"] = round(time.time() - t0, 1)
                print(f"step {i}: {json.dumps(m)}", flush=True)
                metrics_log.write(json.dumps(m) + "\n")
                metrics_log.flush()
            if (i + 1) % cfg.savemodel_every_k_steps == 0 \
                    or i == start + args.steps - 1:
                path = trainlib.save_checkpoint(
                    os.path.abspath(os.path.join(logdir, "ckpt")), state, i + 1
                )
                print(f"saved {path}", flush=True)


if __name__ == "__main__":
    main()
