"""Per-seed curriculum stability table.

Evaluates each seed's stage-2 (repeatability@512, partial-overlap
protocol) and stage-3 (cross-sequence retrieval recall@1/@25, protocol of
`evaluation_retrieval.py:129-169`) checkpoints produced by
scripts/train_demo_curriculum.py, and prints a markdown row per seed —
the multi-seed stability evidence behind the committed fidelity floors
(tests/test_demo_data.py).

Run: python scripts/seed_table.py --runs <curriculum dir> --seeds 0 1 2
"""
import argparse
import glob
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DEMO = "/root/reference/evaluate/global_eval/demo_data"


def _eval_cfg(cfg):
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    cfg.morton_presorted = False
    return cfg


def recall(stage3_dir):
    from dh3d_tpu.data import GlobalTestDataset
    from dh3d_tpu.eval import (
        average_recalls,
        evaluate_sequences,
        extract_global,
        load_sets_from_dir,
    )
    from dh3d_tpu.nn import DH3D
    from dh3d_tpu.train import resolve_model

    cfg, variables = resolve_model(stage3_dir)
    _eval_cfg(cfg)
    model = DH3D(cfg)
    out = tempfile.mkdtemp(prefix="seedtab_")
    for gt in ["global_ref_demo.pickle", "global_query_demo.pickle"]:
        ds = GlobalTestDataset(DEMO, os.path.join(DEMO, gt),
                               numpts=cfg.num_points)
        extract_global(cfg, variables, ds, out, batch_size=4, model=model)
    ref = load_sets_from_dir(
        os.path.join(DEMO, "global_ref_demo.pickle"), out)
    query = load_sets_from_dir(
        os.path.join(DEMO, "global_query_demo.pickle"), out)
    avg, _ = average_recalls(evaluate_sequences(ref, query, max_num_nn=25))
    return float(avg[0]), float(avg[24])


def repeatability(stage2_dir):
    from dh3d_tpu.data.io import load_single_pcfile
    from dh3d_tpu.eval.extract import make_forward
    from dh3d_tpu.eval.repeatability import (
        make_partial_overlap_pairs,
        repeatability_curve_pairs,
    )
    from dh3d_tpu.nn import DH3D
    from dh3d_tpu.train import resolve_model

    cfg, variables = resolve_model(stage2_dir)
    _eval_cfg(cfg)
    cfg.extract_global = False
    fwd = make_forward(cfg, variables, DH3D(cfg))

    def extract_fn(cloud):
        outs = fwd(np.asarray(cloud, np.float32)[None])
        return (np.asarray(outs["xyz"][0]),
                np.asarray(outs["attention"][0]).reshape(-1))

    files = sorted(glob.glob(os.path.join(DEMO, "*", "*.bin")))[:10]
    rng = np.random.RandomState(0)
    clouds = []
    for f in files:
        pts = load_single_pcfile(f)
        sel = rng.choice(len(pts), 8192, replace=len(pts) < 8192)
        clouds.append(pts[sel].astype(np.float32))
    pairs = make_partial_overlap_pairs(clouds, numpts=8192, seed=1)
    curve = repeatability_curve_pairs(extract_fn, pairs, ks=(512,))
    return float(curve[512])


def final_losses(logdir):
    """Mean of the last 20 metrics.jsonl total_cost entries."""
    import json

    path = os.path.join(logdir, "metrics.jsonl")
    if not os.path.isfile(path):
        return float("nan")
    vals = []
    with open(path) as f:
        for line in f:
            try:
                vals.append(float(json.loads(line).get("total_cost")))
            except (ValueError, TypeError):
                pass
    return float(np.mean(vals[-20:])) if vals else float("nan")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="/tmp/curriculum")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()

    print("| seed | s2 final loss | s3 final loss | recall@1 | recall@25 "
          "| repeat@512 |")
    print("|---|---|---|---|---|---|")
    for seed in args.seeds:
        base = os.path.join(args.runs, f"seed{seed}")
        r1, r25 = recall(os.path.join(base, "stage3"))
        rep = repeatability(os.path.join(base, "stage2"))
        l2 = final_losses(os.path.join(base, "stage2"))
        l3 = final_losses(os.path.join(base, "stage3"))
        print(f"| {seed} | {l2:.3f} | {l3:.3f} | {r1 * 100:.1f}% "
              f"| {r25 * 100:.1f}% | {rep:.3f} |", flush=True)


if __name__ == "__main__":
    main()
