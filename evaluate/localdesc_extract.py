#!/usr/bin/env python
"""Local descriptor + keypoint extraction CLI.

Mirrors `evaluate/local_eval/localdesc_extract.py`: loads the train-time
config.json from the model dir (the eval-time source of truth,
`globaldesc_extract.py:51-58` pattern), overrides num_points per dataset
(16384 oxford_lidar / 9000 oxford_dso, `localdesc_extract.py:146-149`),
runs the jitted forward over all .bin clouds in --pcdpath, and saves dense
maps (--save_all) or NMS keypoints ([xyz|desc|att] rows).

With no N<=8192 knn cap here the host-knn input path is unnecessary, but
--host_knn forces it for parity testing.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ModelPath", required=True,
                   help="dir with config.json + ckpt/step_*")
    p.add_argument("--pcdpath", required=True)
    p.add_argument("--save_dir", default="./localdesc_out")
    p.add_argument("--dataset", default="oxford_lidar",
                   choices=["oxford_lidar", "oxford_dso"])
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--perform_nms", action="store_true")
    p.add_argument("--save_all", action="store_true")
    p.add_argument("--host_knn", action="store_true")
    p.add_argument("--dim", type=int, default=6,
                   help="floats per point record in the .bin files "
                        "(reference local eval data is 6; demo data is 3)")
    p.add_argument("--nms_rad", type=float, default=0.5)
    p.add_argument("--nms_min_ratio", type=float, default=0.01)
    p.add_argument("--nms_max_kp", type=int, default=512)
    args = p.parse_args()

    from dh3d_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax

    from dh3d_tpu import train as trainlib
    from dh3d_tpu.data import LocalTestDataset
    from dh3d_tpu.eval import extract_local
    from dh3d_tpu.nn import DH3D

    cfg, variables = trainlib.resolve_model(args.ModelPath)
    cfg.num_points = 16384 if args.dataset == "oxford_lidar" else 9000
    cfg.sampled_kpnum = -1
    cfg.input_R = False

    ds = LocalTestDataset(
        args.pcdpath, numpts=cfg.num_points, dim=args.dim,
        knn_require=cfg.knn_num if args.host_knn else 0,
    )
    n = extract_local(
        cfg, variables, ds, args.save_dir, batch_size=args.batch_size,
        perform_nms=args.perform_nms, save_all=args.save_all,
        nms_rad=args.nms_rad, nms_min_ratio=args.nms_min_ratio,
        nms_max_kp=args.nms_max_kp, model=DH3D(cfg),
    )
    print(f"extracted {n} clouds -> {args.save_dir}")


if __name__ == "__main__":
    main()
