"""Training: jitted train step, 3-stage curriculum freezing, optimizer,
checkpointing.

Reference training loop: tensorpack `SimpleTrainer` with Adam + staircase
exponential LR decay (`core/model.py:248-255`), weight decay as an L2 cost
over Conv2D kernels only ('.*/W', `core/model.py:239-241`), curriculum
freezing via variable-collection exclusion (`core/tf_utils.py:144-153`,
configs `freezebackbone/freezedetection/freezeglobal`), warm start with
shape-mismatch tolerance (`train.py:52-53` SmartInit), periodic ModelSaver
(`train.py:35-38`).

Realization: one `jax.jit`-compiled step over a data-parallel mesh (batch
sharded, params replicated — XLA emits the grad all-reduce); freezing via
`optax.multi_transform` masks + running-average BN for frozen trunks (the
model handles the latter); `.npz` files keyed by variable path for
checkpoints.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from dh3d_tpu.config import dotdict
from dh3d_tpu.losses import compute_total_loss
from dh3d_tpu.nn import DH3D


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["step", "params", "batch_stats", "opt_state"],
                   meta_fields=["tx"])
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    batch_stats: Any
    opt_state: Any
    tx: optax.GradientTransformation  # static: part of the jit cache key

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, grads, new_batch_stats):
        updates, new_opt = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(
            step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            batch_stats=new_batch_stats,
            opt_state=new_opt,
        )


def lr_schedule(cfg):
    """Staircase exponential decay (`core/model.py:249-253`), with an
    optional linear warmup (cfg.warmup_steps) — a stage-3 stabilizer for
    the hinge losses, which see violently violated margins at a freshly
    initialized NetVLAD head (RESULTS.md r2: oscillation on the demo GT)."""
    decay = optax.exponential_decay(
        init_value=cfg.start_lr,
        transition_steps=cfg.decay_step,
        decay_rate=cfg.decay_rate,
        staircase=True,
    )
    warmup = int(cfg.get("warmup_steps") or 0)
    if warmup <= 0:
        return decay
    return optax.join_schedules(
        [optax.linear_schedule(0.0, cfg.start_lr, warmup), decay],
        boundaries=[warmup],
    )


# frozen-subtree names per config flag; module names as in nn/model.py
_FREEZE_GROUPS = {
    "freezebackbone": ("local_backbone",),
    "freezedetection": ("detection_block",),
    "freezeglobal": ("global_backbone", "globalatt", "global_assemble"),
}


def param_labels(cfg, params):
    """'frozen' / 'trainable' label tree for optax.multi_transform —
    the `backbone_scope(freeze)` equivalent (`core/tf_utils.py:144-153`)."""
    frozen_tops = set()
    for flag, groups in _FREEZE_GROUPS.items():
        if cfg.get(flag):
            frozen_tops.update(groups)

    def label_tree(tree, top):
        if isinstance(tree, dict):
            return {k: label_tree(v, top if top else k) for k, v in tree.items()}
        return "frozen" if top in frozen_tops else "trainable"

    return label_tree(params, None)


def make_optimizer(cfg, params):
    tx = optax.adam(lr_schedule(cfg))
    if cfg.get("grad_clip_norm"):
        # optional stabilizer for tiny-dataset stage-3 runs (see
        # RESULTS.md: quadruplet loss oscillates on the 21-sample demo GT)
        tx = optax.chain(
            optax.clip_by_global_norm(float(cfg["grad_clip_norm"])), tx
        )
    labels = param_labels(cfg, params)
    if any(
        leaf == "frozen" for leaf in jax.tree_util.tree_leaves(labels)
    ):
        tx = optax.multi_transform(
            {"trainable": tx, "frozen": optax.set_to_zero()}, labels
        )
    return tx


def kernel_l2(params):
    """Sum of squares over Dense kernels only — the reference regularizes
    '.*/W' (tensorpack Conv2D weights), which map to our `kernel` leaves;
    flexconv thetas / NetVLAD matrices / BN are excluded
    (`core/model.py:239-241`)."""
    total = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        if path and getattr(path[-1], "key", None) == "kernel":
            total = total + jnp.sum(jnp.square(leaf))
    return total


def init_state(cfg, rng, sample_batch=None) -> TrainState:
    """Initialize model + optimizer.  Variable shapes follow from the
    config alone (`nn.init_variables`); `sample_batch` is not needed."""
    from dh3d_tpu.nn import init_variables

    variables = init_variables(cfg, rng)
    params = variables["params"]
    batch_stats = variables["batch_stats"]
    tx = make_optimizer(cfg, params)
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        batch_stats=batch_stats,
        opt_state=tx.init(params),
        tx=tx,
    )


def loss_and_updates(params, batch_stats, batch, cfg, model):
    if "pc1" in batch:
        # on-device local pair generation (data/pairgen.py): the host
        # supplied only the two unrotated augmented copies; rotation, FPS
        # anchors and 1-NN correspondences are computed here, inside jit.
        import math

        from dh3d_tpu.data.pairgen import device_local_pairs

        pc1, pc2 = batch["pc1"], batch["pc2"]
        if cfg.augment_on_device and "aug_key" in batch:
            # independent per-copy augmentation BEFORE correspondence
            # search, like the host loader (`core/datasets.py:130-131`)
            from dh3d_tpu.data.augment import jax_augment

            both = jnp.concatenate([pc1, pc2])
            keys = jax.random.split(batch["aug_key"], both.shape[0])
            both = jax.vmap(
                lambda k, pc: jax_augment(k, pc, tuple(cfg.data_aug))
            )(keys, both)
            pc1, pc2 = jnp.split(both, 2)
        rot_maxv = cfg.rot_maxv if cfg.rot_maxv is not None else math.pi
        pair = device_local_pairs(
            batch["pairgen_key"], pc1, pc2, cfg.sampled_kpnum,
            rot_maxv=rot_maxv,
        )
        batch = {
            k: v for k, v in batch.items()
            if k not in ("pc1", "pc2", "pairgen_key", "aug_key")
        }
        batch.update(pair)

    points = batch["points"]
    if cfg.augment_on_device and "aug_key" in batch:
        # on-device augmentation: the reference jitters/rotates per cloud
        # on the host (`core/datasets.py:122-124`); here it runs inside the
        # jitted step.  Only valid when clouds are independent (global
        # training) — the local self-pair correspondence warp R is built
        # before augmentation, so input_R configs keep host augmentation.
        from dh3d_tpu.data.augment import jax_augment

        keys = jax.random.split(batch["aug_key"], points.shape[0])
        points = jax.vmap(
            lambda k, pc: jax_augment(k, pc, tuple(cfg.data_aug))
        )(keys, points)

    variables = {"params": params, "batch_stats": batch_stats}
    outs, mutated = model.apply(
        variables,
        points,
        sample_inds=batch.get("sample_inds"),
        train=True,
        mutable=["batch_stats"],
    )
    if "R" in batch:
        outs["R"] = batch["R"]
    total, metrics = compute_total_loss(outs, cfg, kernel_l2(params))
    return total, (metrics, mutated["batch_stats"])


def make_train_step(cfg, model=None, donate=False):
    """Build the jitted train step.  Call with (state, batch).

    donate=True donates the previous state's buffers (params/opt-state
    update in place on device instead of copying) — use in production
    loops; the old state object becomes invalid after the call.
    """
    model = model or DH3D(cfg)
    cfg = dotdict(dict(cfg))

    @functools.partial(jax.jit, donate_argnums=(0,) if donate else ())
    def train_step(state: TrainState, batch: Dict[str, jnp.ndarray]):
        grad_fn = jax.value_and_grad(loss_and_updates, has_aux=True)
        (loss, (metrics, new_bs)), grads = grad_fn(
            state.params, state.batch_stats, batch, cfg, model
        )
        new_state = state.apply_gradients(grads, new_bs)
        return new_state, metrics

    return train_step


def make_eval_step(cfg, model=None):
    model = model or DH3D(cfg)

    @jax.jit
    def eval_step(params, batch_stats, batch):
        variables = {"params": params, "batch_stats": batch_stats}
        return model.apply(
            variables,
            batch["points"],
            sample_inds=batch.get("sample_inds"),
            train=False,
        )

    return eval_step


def smart_init(init_params, loaded_params):
    """SmartInit(ignore_mismatch=True) equivalent (`train.py:52-53`): merge
    loaded params into freshly initialized ones wherever path AND shape
    match; new variables keep their fresh init — this is how the 3-stage
    curriculum hands off (local -> +detector -> global)."""
    init_params = jax.tree_util.tree_map(lambda x: x, init_params)
    n_loaded = [0]

    def merge(dst, src):
        for k, v in src.items():
            if k not in dst:
                continue
            if isinstance(v, dict) and isinstance(dst[k], dict):
                merge(dst[k], v)
            elif hasattr(v, "shape") and hasattr(dst[k], "shape"):
                if v.shape == dst[k].shape:
                    dst[k] = v
                    n_loaded[0] += 1

    merge(init_params, loaded_params)
    return init_params, n_loaded[0]


# ----------------------------- checkpointing -----------------------------
#
# The reference checkpoints via tensorpack ModelSaver every
# `savemodel_every_k_steps` (`train.py:35-38`); full-state checkpoints here
# additionally carry the optimizer state so training resumes exactly.  One
# `.npz` per checkpoint, keyed by variable path ("params/a/b/kernel",
# "batch_stats/...", "step", and "opt_state" + the optimizer leaf's tree
# path) — the format of the committed `models/*.npz`.

def flatten_tree(tree, prefix, out):
    """Nested dicts -> {"prefix/a/b": leaf} (numpy) into `out`."""
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flatten_tree(v, key, out)
        else:
            out[key] = np.asarray(v)
    return out


def _opt_leaves(opt_state):
    return [("opt_state" + jax.tree_util.keystr(path), leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(opt_state)]


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    step: Optional[int] = None, include_opt: bool = True):
    """Write `<ckpt_dir>/step_<step>.npz`; returns its path."""
    step = int(state.step) if step is None else step
    flat = {"step": np.asarray(jax.device_get(state.step))}
    flatten_tree(jax.device_get(state.params), "params", flat)
    flatten_tree(jax.device_get(state.batch_stats), "batch_stats", flat)
    if include_opt:
        for key, leaf in _opt_leaves(state.opt_state):
            flat[key] = np.asarray(jax.device_get(leaf))
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)  # a crash mid-write leaves no truncated file
    return path


def resolve_model(path: str):
    """Load a trained model from either surface the framework produces:
    a training logdir (config.json + ckpt/step_*.npz) or a packaged
    `<stem>.npz` + `<stem>.config.json` pair (scripts/package_checkpoint.py).

    Returns (cfg, variables) ready for `DH3D(cfg).apply(variables, ...)` —
    the load pattern every eval CLI shares (the reference reads its
    config.json the same way, `globaldesc_extract.py:51-58`)."""
    from dh3d_tpu import config as cfglib

    if path.endswith(".npz") or os.path.isfile(path + ".npz"):
        stem = path[:-4] if path.endswith(".npz") else path
        cfg = cfglib.load_config(stem + ".config.json")
        loaded = load_checkpoint(stem + ".npz")
    else:
        cfg = cfglib.load_config(os.path.join(path, "config.json"))
        loaded = load_checkpoint(latest_checkpoint(path))
    variables = {"params": loaded["params"],
                 "batch_stats": loaded["batch_stats"]}
    return cfg, variables


def latest_checkpoint(logdir: str) -> str:
    ckpt = os.path.join(logdir, "ckpt")
    steps = sorted(f for f in os.listdir(ckpt)
                   if f.startswith("step_") and f.endswith(".npz")
                   and not f.endswith(".tmp.npz"))
    if not steps:
        raise FileNotFoundError(f"no step_*.npz checkpoint in {ckpt}")
    return os.path.join(ckpt, steps[-1])


def load_checkpoint(path: str):
    """Load a `.npz` checkpoint into {"params", "batch_stats", "step"}
    nested dicts, plus the flat optimizer leaves under "opt_state" when
    the file has them."""
    flat = np.load(path)
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}, "opt_state": {}}
    for key in flat.files:
        if key == "step":
            out["step"] = int(flat[key])
        elif key.startswith("opt_state"):
            out["opt_state"][key] = flat[key]
        else:
            parts = key.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return out



def restore_state(path: str, state: TrainState) -> TrainState:
    """Exact-resume restore into a freshly initialized TrainState (same
    config): params, batch stats, step, and optimizer state when the
    checkpoint has it."""
    loaded = load_checkpoint(path)
    as_like = lambda new, old: jax.tree_util.tree_map(
        lambda n, o: jnp.asarray(n, o.dtype), new, old)
    new = state.replace(
        params=as_like(loaded["params"], state.params),
        batch_stats=as_like(loaded["batch_stats"], state.batch_stats),
        step=jnp.asarray(loaded["step"], jnp.int32),
    )
    if loaded["opt_state"]:
        keys = _opt_leaves(state.opt_state)
        treedef = jax.tree_util.tree_structure(state.opt_state)
        leaves = [jnp.asarray(loaded["opt_state"][key], jnp.result_type(x))
                  for key, x in keys]
        new = new.replace(
            opt_state=jax.tree_util.tree_unflatten(treedef, leaves))
    return new
