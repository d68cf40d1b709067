#!/usr/bin/env python
"""Keypoint relative-repeatability CLI — the metric behind BASELINE.md
rows 1-5 / the paper's Fig. 4 (`results_in_paper/results_in_paper.txt:3-10`).

Loads a trained detector model (a `detection_config` logdir), extracts
per-point attention on demo/test clouds, and reports relative
repeatability at K in {32, 64, 128, 256, 512} under two protocols:

  self-pair        each cloud vs its jittered rigid copy (easy; upper
                   bound — point identities shared)
  partial-overlap  two half-space crops of each cloud, independently
                   resampled and rigidly separated, scored via the known
                   pose (`make_partial_overlap_pairs`) — paper-style
                   cross-scan difficulty, no shared point identities

Usage:
  python evaluate/repeatability_eval.py --model <logdir> \
      --pcdpath <dir-with-*.bin> [--num_points 4096] [--max_clouds 10] \
      [--protocol both|self|overlap]
"""

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_extract_fn(model_path, num_points):
    from dh3d_tpu import train as trainlib
    from dh3d_tpu.eval.extract import make_forward
    from dh3d_tpu.nn import DH3D

    cfg, variables = trainlib.resolve_model(model_path)
    cfg.num_points = num_points
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    cfg.extract_global = False
    if not cfg.detection:
        raise SystemExit(
            f"{model_path} has no detector (cfg.detection is falsy) — "
            "repeatability needs per-point attention")
    fwd = make_forward(cfg, variables, DH3D(cfg))

    def extract_fn(cloud):
        outs = fwd(np.asarray(cloud, np.float32)[None])
        return (np.asarray(outs["xyz"][0]),
                np.asarray(outs["attention"][0]).reshape(-1))

    return extract_fn


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True,
                   help="detection_config logdir (config.json + ckpt/)")
    p.add_argument("--pcdpath", required=True,
                   help="directory searched recursively for *.bin clouds")
    p.add_argument("--num_points", type=int, default=4096)
    p.add_argument("--max_clouds", type=int, default=10)
    p.add_argument("--protocol", default="both",
                   choices=["both", "self", "overlap"])
    p.add_argument("--radius", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    from dh3d_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    from dh3d_tpu.data.io import get_fixednum_pcd, load_single_pcfile
    from dh3d_tpu.eval.repeatability import (
        make_partial_overlap_pairs,
        repeatability_curve,
        repeatability_curve_pairs,
    )

    files = sorted(
        glob.glob(os.path.join(args.pcdpath, "**", "*.bin"),
                  recursive=True))[: args.max_clouds]
    if not files:
        raise SystemExit(f"no *.bin clouds under {args.pcdpath}")
    extract_fn = build_extract_fn(args.model, args.num_points)

    rng = np.random.RandomState(args.seed)
    raw = [load_single_pcfile(f)[:, :3] for f in files]
    clouds = []
    for c in raw:
        pc, _ = get_fixednum_pcd(c, args.num_points, randsample=True,
                                 need_downsample=False, sortby_dis=False,
                                 rng=rng)
        clouds.append(pc.astype(np.float32))

    def show(name, curve):
        ks = sorted(curve)
        print(f"{name}: " + "  ".join(f"K={k}: {curve[k]:.4f}" for k in ks))

    if args.protocol in ("both", "self"):
        show("self-pair", repeatability_curve(
            extract_fn, clouds, radius=args.radius, seed=args.seed))
    if args.protocol in ("both", "overlap"):
        pairs = make_partial_overlap_pairs(
            raw, numpts=args.num_points, seed=args.seed)
        show("partial-overlap", repeatability_curve_pairs(
            extract_fn, pairs, radius=args.radius))


if __name__ == "__main__":
    main()
