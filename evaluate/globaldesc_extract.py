#!/usr/bin/env python
"""Global descriptor extraction + retrieval recall CLI.

Mirrors `evaluate/global_eval/globaldesc_extract.py`: per-cloud 256-f32
descriptor .bin files, then (--eval_recall) the recall@N/recall@1%
cross-sequence evaluation over reference/query GT pickles.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ModelPath", required=True)
    p.add_argument("--pcdpath", required=True)
    p.add_argument("--ref_gt_file", required=True)
    p.add_argument("--query_gt_file", required=True)
    p.add_argument("--save_dir", default="./globaldesc_out")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_points", type=int, default=8192)
    p.add_argument("--eval_recall", action="store_true")
    args = p.parse_args()

    from dh3d_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    from dh3d_tpu import train as trainlib
    from dh3d_tpu.data import GlobalTestDataset
    from dh3d_tpu.eval import (
        average_recalls,
        evaluate_sequences,
        extract_global,
        load_sets_from_dir,
    )
    from dh3d_tpu.nn import DH3D

    cfg, variables = trainlib.resolve_model(args.ModelPath)
    cfg.num_points = args.num_points
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    cfg.extract_global = True

    # extract for the union of ref + query sequences, deduplicating clouds
    # that appear in both GT files (each output path is extracted once)
    done = set()
    for gt_file in dict.fromkeys([args.ref_gt_file, args.query_gt_file]):
        ds = GlobalTestDataset(args.pcdpath, gt_file,
                               numpts=cfg.num_points)
        ds.files = [f for f in ds.files if f not in done]
        done.update(ds.files)
        n = extract_global(cfg, variables, ds, args.save_dir,
                           batch_size=args.batch_size, model=DH3D(cfg))
        print(f"extracted {n} clouds from {os.path.basename(gt_file)}")

    if args.eval_recall:
        ref_sets = load_sets_from_dir(args.ref_gt_file, args.save_dir)
        query_sets = load_sets_from_dir(args.query_gt_file, args.save_dir)
        results = evaluate_sequences(ref_sets, query_sets)
        avg, one_percent = average_recalls(results)
        print("Avg_recall@N:")
        for i, r in enumerate(avg):
            print(f"{i + 1}: {r:.4f}")
        print(f"Avg_one_percent_retrieved: {one_percent:.4f}")


if __name__ == "__main__":
    main()
