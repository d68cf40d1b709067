"""Package a trained checkpoint into a repo-committable .npz.

The fidelity gate (`tests/test_demo_data.py`) needs a trained model inside
the repository.  A training checkpoint also carries the optimizer state;
this keeps params + batch_stats (f32, exact — the gate thresholds assume
the eval-time numerics of training) in one compressed npz next to the
config.json that produced it.

The stage-3 checkpoint contains the ENTIRE model: stage-3 training freezes
the backbone and detector (`global_config`: freezebackbone/freezedetection),
so its weights are the stage-2 weights verbatim, plus the trained global
head — one file serves both local (descriptor/keypoint) and global
(retrieval) evaluation.

Usage:
  python scripts/package_checkpoint.py --ckpt /tmp/curriculum/seed0/stage3 \
      --out models/demo_stage3
Produces <out>.npz and <out>.config.json.
Load with `dh3d_tpu.train.resolve_model`.
"""

import argparse
import json
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="stage logdir (contains config.json + ckpt/) or a "
                         "step_*.npz checkpoint")
    ap.add_argument("--out", required=True, help="output path stem")
    args = ap.parse_args()

    from dh3d_tpu.train import flatten_tree, latest_checkpoint, load_checkpoint

    path = args.ckpt
    cfg_json = None
    if os.path.isdir(os.path.join(path, "ckpt")):
        cfg_json = os.path.join(path, "config.json")
        path = latest_checkpoint(path)
    loaded = load_checkpoint(os.path.abspath(path))

    flat = {}
    flatten_tree(loaded["params"], "params", flat)
    flatten_tree(loaded["batch_stats"], "batch_stats", flat)
    flat["step"] = np.asarray(loaded.get("step", 0))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out + ".npz", **flat)
    if cfg_json:
        with open(cfg_json) as f:
            cfg = json.load(f)
        with open(args.out + ".config.json", "w") as f:
            json.dump(cfg, f, indent=2)
    n_params = sum(v.size for k, v in flat.items()
                   if k.startswith("params/"))
    print(f"{args.out}.npz: {n_params:,} params, "
          f"{os.path.getsize(args.out + '.npz') / 1e6:.1f} MB "
          f"(step {int(flat['step'])})")


if __name__ == "__main__":
    main()
