"""Config presets, mirroring `core/configs.py`.

Same two-tier design as the reference: named presets composed by dict
update (`core/configs.py:146-153`) over a `dotdict` whose missing keys read
as None (`core/configs.py:22-26`) — the model relies on that behavior.
"""

from __future__ import annotations

import json


class dotdict(dict):
    """dot.notation dict with silent-None missing keys
    (`core/configs.py:22-26`)."""

    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__


def basic_config():
    """Local-descriptor training preset (`core/configs.py:35-86`)."""
    return dotdict(
        # train
        training_local=True,
        extract_global=False,
        detection=False,
        freezedetection=False,
        freezebackbone=False,
        freezeglobal=False,
        local_backbone="backbone_local_dilate",
        add_batch_norm=True,
        loadpath=None,
        start_lr=5e-4,
        decay_step=5 * 2000,
        decay_rate=0.5,
        add_weight_decay=True,
        train_weight_decay=1e-5,
        # model
        init_feat_dim=32,
        featdim=128,
        knn_num=8,
        # data
        num_points=8192,
        batch_size=10,
        num_pos=1,
        num_neg=0,
        other_neg=False,
        input_R=True,
        data_aug=["Jitter"],
        sampled_kpnum=512,
        data_basedir=None,
        # loss
        add_local_loss=True,
        add_det_loss=False,
        add_global_loss=False,
        margin=1.0,
        neg_weight=5.0,
        local_loss="desc_local_loss",
        pos_r=0.5,
        search_r=20.0,
        local_loss_weight=1.0,
        savemodel_every_k_steps=200,
        # extensions beyond the reference (see SURVEY.md §2.3)
        num_devices=1,          # data-parallel mesh size
        compute_dtype="float32",  # 'bfloat16' for mixed precision
        # all-gather global descriptors across the mesh and mine hardest
        # negatives over the global batch
        cross_device_mining=False,
        augment_on_device=False,  # jitted augmentation (global training)
        remat=False,              # rematerialize the backbone in backward
        # local training: generate rotation/FPS-anchors/1-NN inside the
        # jitted step (data/pairgen.py) instead of the host loader loop
        device_pairgen=False,
        rot_maxv=3.141592653589793,
        prefetch=2,               # host batch prefetch depth (0 = off)
        # run the forward on clouds sorted along the Z-order curve (FPS
        # keeps the sorted order); outputs return in input order in eval
        morton_order=True,
        # input clouds (and any sample/knn indices) are already Z-order
        # sorted by the loader; skip the in-graph sort (training only)
        morton_presorted=False,
        grad_clip_norm=None,      # optional global-norm gradient clip
    )


def detection_config():
    """Joint detector preset (`core/configs.py:88-102`)."""
    cfg = basic_config()
    cfg.detection = True
    cfg.detection_block = "detection_block"
    cfg.loadpath = None
    cfg.add_det_loss = True
    cfg.detection_loss = "local_detection_loss_nn"
    cfg.ar_th = 0.4
    cfg.det_k = 16
    cfg.ar_nn_k = 5
    cfg.det_loss_weight = 0.2
    # strict-parity fidelity toggle: reproduce the reference's
    # hardest-negative slot-index gather bug (`core/losses.py:94-98`)
    # instead of the corrected keypoint-id -> cloud-point-id mapping
    # (losses/losses.py, PARITY.md "detection loss hardest-negative
    # gather") — for A/B runs against a faithful reproduction.
    cfg.reproduce_ref_detloss_bug = False
    return cfg


def global_config():
    """Global-descriptor preset (`core/configs.py:104-144`)."""
    cfg = basic_config()
    cfg.training_local = False
    cfg.detection = False
    cfg.extract_global = True
    cfg.freezebackbone = True
    cfg.freezedetection = True
    cfg.start_lr = 5e-4
    cfg.decay_step = 20000
    cfg.decay_rate = 0.9
    cfg.global_backbone = "global_before_assemble"
    cfg.global_assemble = "global_netvald_block"
    cfg.concat_xyz = False
    cfg.sampled_kpnum = -1
    cfg.global_subsample = -1
    cfg.gl_dilate = 8
    cfg.gl_dims = [256]
    cfg.batch_size = 2
    cfg.num_pos = 2
    cfg.num_neg = 8
    cfg.other_neg = True
    cfg.input_R = False
    cfg.data_aug = ["Rotate1D", "Jitter", "RotateSmall"]
    cfg.add_local_loss = False
    cfg.add_det_loss = False
    cfg.add_global_loss = True
    cfg.global_loss = "lazy_quadruplet_loss"
    cfg.global_triplet_margin = 0.5
    cfg.global_quadruplet_margin = 0.2
    cfg.global_loss_weight = 1.0
    return cfg


_FACTORY = {
    "basic_config": basic_config,
    "detection_config": detection_config,
    "global_config": global_config,
}


def get_config(name: str) -> dotdict:
    """ConfigFactory(name).getconfig() equivalent
    (`core/configs.py:146-153`)."""
    if name not in _FACTORY:
        raise KeyError(f"unknown config '{name}'; have {sorted(_FACTORY)}")
    return _FACTORY[name]()


def save_config(cfg: dotdict, path: str):
    """Dump config json into the run dir (`core/utils.py:71-84`); that json
    is the source of truth for eval-time model config."""
    with open(path, "w") as f:
        json.dump({k: v for k, v in cfg.items()}, f, indent=2, default=str)


def load_config(path: str) -> dotdict:
    """Configs saved before a key was retired still load: the model reads
    only the keys it knows (e.g. `morton_exact`, `oob_cap_scale`,
    `fast_grads` in `models/demo_stage*.config.json`)."""
    with open(path) as f:
        return dotdict(json.load(f))
