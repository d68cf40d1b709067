#!/usr/bin/env python
"""Full 6DoF relocalization pipeline (BASELINE.json config 5): for each
query cloud, (1) retrieve the nearest database cloud by global descriptor,
(2) extract NMS keypoints + local descriptors for both, (3) mutual-NN
match + RANSAC rigid fit.

This is the end-to-end composition the reference only documents across
separate tools (globaldesc_extract -> localdesc_extract -> MATLAB
eval_align.m); here it is one driver on one jitted model.

Usage:
  python evaluate/relocalize.py --local_model <logdir> --global_model \
      <logdir> --db_gt ref.pickle --query_gt query.pickle --pcdpath <dir>
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_model(model_path, extract_global, num_points):
    from dh3d_tpu import train as trainlib
    from dh3d_tpu.nn import DH3D

    cfg, variables = trainlib.resolve_model(model_path)
    cfg.num_points = num_points
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    cfg.extract_global = extract_global
    return cfg, DH3D(cfg), variables


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--local_model", required=True)
    p.add_argument("--global_model", required=True)
    p.add_argument("--db_gt", required=True)
    p.add_argument("--query_gt", required=True)
    p.add_argument("--pcdpath", required=True)
    p.add_argument("--num_points", type=int, default=4096)
    p.add_argument("--max_queries", type=int, default=10)
    p.add_argument("--nms_max_kp", type=int, default=256)
    p.add_argument("--nms_backend", default="device",
                   choices=["device", "host"])
    p.add_argument("--ransac_iters", type=int, default=500)
    args = p.parse_args()

    from dh3d_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax

    from dh3d_tpu.data import GlobalTestDataset
    from dh3d_tpu.data.io import get_sets_dict
    from dh3d_tpu.eval import register_clouds
    from dh3d_tpu.eval.extract import make_forward
    from dh3d_tpu.eval.nms import nms_keypoint_indices

    # ---- stage A: global descriptors for database + queries
    gcfg, gmodel, gvars = build_model(args.global_model, True,
                                      args.num_points)
    gfwd = make_forward(gcfg, gvars, gmodel)

    def descriptors(gt_file):
        ds = GlobalTestDataset(args.pcdpath, gt_file,
                               numpts=args.num_points)
        names, descs, clouds = [], [], []
        for cloud, name in ds:
            o = gfwd(cloud[None].astype(np.float32))
            descs.append(np.asarray(o["global_desc"])[0])
            names.append(name)
            clouds.append(cloud)
        return names, np.stack(descs), clouds

    db_names, db_desc, db_clouds = descriptors(args.db_gt)
    q_names, q_desc, q_clouds = descriptors(args.query_gt)
    print(f"database: {len(db_names)} clouds; queries: {len(q_names)}")

    # GT positions for retrieval scoring
    def positions(gt_file):
        gt = get_sets_dict(gt_file)
        pos = {}
        for seq in gt:
            for item in gt[seq]:
                pos[item["query"] + ".bin"] = (item["northing"],
                                               item["easting"])
        return pos

    db_pos, q_pos = positions(args.db_gt), positions(args.query_gt)

    # ---- stage B: local keypoints+descriptors, match, register
    lcfg, lmodel, lvars = build_model(args.local_model, False,
                                      args.num_points)
    lfwd = make_forward(lcfg, lvars, lmodel)

    def keypoints(cloud):
        o = lfwd(cloud[None].astype(np.float32))
        desc = np.asarray(o["local_desc"])[0]
        if "attention" in o:
            att = 1 - np.asarray(o["attention"])[0, :, 0]
        else:
            att = np.ones(len(cloud), np.float32)
        idx = nms_keypoint_indices(cloud.astype(np.float64), att,
                                   nms_radius=0.5, min_response_ratio=0.01,
                                   max_keypoints=args.nms_max_kp,
                                   backend=args.nms_backend)
        return cloud[idx], desc[idx]

    n_retrieved = n_registered = 0
    for qi in range(min(args.max_queries, len(q_names))):
        order = np.argsort(np.linalg.norm(db_desc - q_desc[qi], axis=1))
        top1 = int(order[0])
        dq, dd = q_pos[q_names[qi]], db_pos[db_names[top1]]
        retr_dist = np.hypot(dq[0] - dd[0], dq[1] - dd[1])
        retrieved = retr_dist < 25.0
        n_retrieved += int(retrieved)

        kp_q, desc_q = keypoints(q_clouds[qi])
        kp_db, desc_db = keypoints(db_clouds[top1])
        res = register_clouds(kp_db, desc_db, kp_q, desc_q,
                              iters=args.ransac_iters, seed=qi)
        inl = f"{res.num_inliers}/{res.num_matches}" if res else "n/a"
        reg_ok = res is not None and res.num_inliers >= 10
        n_registered += int(reg_ok and retrieved)
        print(f"query {q_names[qi]}: top1 {db_names[top1]} "
              f"({retr_dist:.1f} m, {'OK' if retrieved else 'MISS'}), "
              f"inliers {inl}")

    n = min(args.max_queries, len(q_names))
    print(f"\nretrieval@1 (<25m): {n_retrieved}/{n}; "
          f"registered (>=10 inliers): {n_registered}/{n}")


if __name__ == "__main__":
    main()
