"""Descriptor extraction drivers — the eval CLI surface.

Mirrors `evaluate/local_eval/localdesc_extract.py` and
`evaluate/global_eval/globaldesc_extract.py`: batch the eval clouds to a
fixed size (padding the last batch, `localdesc_extract.py:115-122`), run
the jitted forward, crop padding, and either save dense maps or NMS
keypoints ([xyz | 128-d desc | att] rows), / one 256-f32 .bin per cloud.

Note the reference quirk kept for parity: eval attention is INVERTED,
att = 1 - res[:, -1] (`localdesc_extract.py:94`).
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np

from dh3d_tpu.data.io import write_to_bin
from dh3d_tpu.eval.nms import nms_keypoint_indices


# One jitted apply per model CONFIG: repeated make_forward calls over equal
# configs (ref set then query set, or a CLI looping over datasets) share one
# traced executable.  Keyed on the config's sorted item digest — id(model)
# keys never hit for the default model=None pattern and pin a new executable
# per call (round-4 advisor finding).  Bounded: oldest entry evicted at 8.
_APPLY_CACHE: dict = {}
_APPLY_CACHE_MAX = 8


def _cfg_digest(cfg):
    return tuple(sorted(
        (k, tuple(v) if isinstance(v, (list, tuple)) else v)
        for k, v in dict(cfg).items()
    ))


def make_forward(cfg, variables, model=None):
    """Jitted inference forward: points [B, N, 3] -> outs dict."""
    import jax

    from dh3d_tpu.nn import DH3D

    # Eval clouds are never host-presorted; a checkpoint trained with
    # morton_presorted must fall back to the in-graph Z-order sort, or the
    # stages would keep an arbitrary order where the config promises the
    # sorted one.  cfg is shared by reference with any caller-constructed
    # model, so this covers both.
    if cfg.morton_presorted:
        cfg.morton_presorted = False

    # caller-constructed models may differ from DH3D(cfg); only the
    # default pattern is safely shareable by config digest
    key = ("model", id(model)) if model is not None \
        else ("cfg", _cfg_digest(cfg))
    model = model or DH3D(cfg)

    # `variables` rides as a jit ARGUMENT, not a closure constant — no
    # multi-MB weight constants embedded in the executable.
    cached = _APPLY_CACHE.get(key)
    if cached is None or (key[0] == "model" and cached[0] is not model):
        @jax.jit
        def _fwd(variables, points, knn_inds=None):
            return model.apply(variables, points, knn_inds=knn_inds,
                               train=False)

        while len(_APPLY_CACHE) >= _APPLY_CACHE_MAX:
            _APPLY_CACHE.pop(next(iter(_APPLY_CACHE)))
        _APPLY_CACHE[key] = (model, _fwd)  # model ref keeps id() stable
    _fwd = _APPLY_CACHE[key][1]
    return lambda points, knn_inds=None: _fwd(variables, points, knn_inds)


def local_result_rows(outs, with_attention):
    """[B, N, 3+128(+1)] rows: xyz | l2-normed descriptor (| attention) —
    the 'xyz_feat(_att)' output tensors (`core/model.py:181,188`)."""
    key = "xyz_feat_att" if with_attention else "xyz_feat"
    return np.asarray(outs[key])


def extract_local(cfg, variables, dataset: Iterable, save_dir,
                  batch_size=1, perform_nms=False, save_all=False,
                  nms_rad=0.5, nms_min_ratio=0.01, nms_max_kp=512,
                  model=None, nms_backend="device",
                  nms_parity_check=False):
    """Per-cloud local descriptor extraction
    (`localdesc_extract.py:106-138` perform_pred + pred_saveres).

    dataset yields [cloud [N,3], name, ori_num(, knn_ind)].
    Writes `<name>_res.bin` (dense) or `<name>_nms_res.bin` (keypoints).
    """
    os.makedirs(save_dir, exist_ok=True)
    fwd = make_forward(cfg, variables, model)
    with_att = bool(cfg.detection)

    buf, names, orinums, knns = [], [], [], []

    def flush():
        if not buf:
            return 0
        batch = np.stack(buf)
        pad = batch_size - batch.shape[0]
        if pad > 0:
            batch = np.concatenate(
                [batch, np.zeros((pad,) + batch.shape[1:], np.float32)]
            )
        knn = None
        if knns and knns[0] is not None:
            knn = np.stack(knns)
            if pad > 0:
                knn = np.concatenate(
                    [knn, np.zeros((pad,) + knn.shape[1:], np.int32)]
                )
        outs = fwd(batch, knn) if knn is not None else fwd(batch)
        rows = local_result_rows(outs, with_att)
        n = 0
        for b, (name, num) in enumerate(zip(names, orinums)):
            res = rows[b][:num]
            stem = os.path.splitext(name)[0]
            if save_all or not with_att:
                write_to_bin(np.float32(res),
                             os.path.join(save_dir, f"{stem}_res.bin"))
            elif perform_nms:
                xyz = res[:, 0:3]
                attention = 1 - res[:, -1]  # reference inversion
                max_idx = nms_keypoint_indices(
                    xyz, attention, nms_radius=nms_rad,
                    min_response_ratio=nms_min_ratio,
                    max_keypoints=nms_max_kp,
                    backend=nms_backend,
                    parity_check=nms_parity_check,
                )
                write_to_bin(np.float32(res[max_idx, :]),
                             os.path.join(save_dir, f"{stem}_nms_res.bin"))
            else:
                write_to_bin(np.float32(res),
                             os.path.join(save_dir, f"{stem}_res.bin"))
            n += 1
        buf.clear(); names.clear(); orinums.clear(); knns.clear()
        return n

    total = 0
    for item in dataset:
        cloud, name, ori_num = item[0], item[1], item[2]
        buf.append(np.asarray(cloud, np.float32))
        names.append(name)
        orinums.append(int(ori_num))
        knns.append(item[3] if len(item) > 3 else None)
        if len(buf) == batch_size:
            total += flush()
    total += flush()
    return total


def extract_global(cfg, variables, dataset: Iterable, save_dir,
                   batch_size=4, model=None):
    """Per-cloud 256-f32 global descriptors
    (`globaldesc_extract.py:81-100`).  dataset yields [cloud, name]."""
    os.makedirs(save_dir, exist_ok=True)
    fwd = make_forward(cfg, variables, model)

    buf, names = [], []

    def flush():
        if not buf:
            return 0
        batch = np.stack(buf)
        pad = batch_size - batch.shape[0]
        if pad > 0:
            batch = np.concatenate(
                [batch, np.zeros((pad,) + batch.shape[1:], np.float32)]
            )
        gd = np.asarray(fwd(batch)["global_desc"])
        n = 0
        for b, name in enumerate(names):
            out = os.path.join(save_dir,
                               os.path.splitext(name)[0] + ".bin")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            write_to_bin(np.float32(gd[b]), out)
            n += 1
        buf.clear(); names.clear()
        return n

    total = 0
    for cloud, name in dataset:
        buf.append(np.asarray(cloud, np.float32))
        names.append(name)
        if len(buf) == batch_size:
            total += flush()
    total += flush()
    return total
