"""The DH3D model: one jit-compiled forward pass -> dense local descriptors,
keypoint detection scores, and an attention-aggregated NetVLAD global
descriptor.

Mirrors `core/model.py:33-255` (class DH3D).  The Siamese tuple is
flattened along the batch axis before entry (`core/model.py:139-146`), so the
model itself sees one [B_total, N, 3] cloud tensor — exactly the
data-parallel-friendly layout for a device mesh.

Variables are `{"params": ..., "batch_stats": ...}` nested dicts (paths as
in `models/demo_stage*.npz`); `model_spec` describes them from the config
alone and `forward` is a plain function of them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dh3d_tpu import ops
from dh3d_tpu.config import dotdict
from dh3d_tpu.nn import backbones
from dh3d_tpu.nn.layers import init_from_spec, l2_normalize


def _global_backbone(cfg):
    return cfg.global_backbone or "global_before_assemble"


def model_spec(cfg):
    """Variable spec of the whole model (see nn/layers.py): every shape is
    a function of the config, not of the cloud size."""
    cfg = dotdict(cfg)
    spec = {"local_backbone": backbones.backbone_local_dilate_spec(
        cfg.featdim)}
    if cfg.detection:
        spec["detection_block"] = backbones.detection_block_spec(cfg.featdim)
    if cfg.extract_global:
        gl_dims = tuple(cfg.gl_dims or (256,))
        if _global_backbone(cfg) == "global_before_assemble":
            spec["global_backbone"] = backbones.global_before_assemble_spec(
                cfg.featdim, gl_dims, bool(cfg.concat_xyz))
        else:
            spec["global_backbone"] = \
                backbones.global_before_assemble_conv1d_spec(
                    cfg.featdim, gl_dims, bool(cfg.concat_xyz))
        spec["globalatt"] = backbones.global_att_block_spec(gl_dims[-1])
        spec["global_assemble"] = backbones.netvlad_spec(
            gl_dims[-1], add_batch_norm=bool(cfg.add_batch_norm))
    return spec


def init_variables(cfg, rng):
    """Fresh variables for `cfg`, from its shapes alone (no forward)."""
    return init_from_spec(model_spec(cfg), rng)


def forward(cfg, params, batch_stats, points, knn_inds=None,
            sample_inds=None, train=False):
    """Forward graph of `DH3D.build_graph` (`core/model.py:135-206`).

    Args:
      points: [B_total, N, 3] tuple-flattened clouds ('pointclouds').
      knn_inds: optional precomputed [B_total, N, knn_num] indices —
        parity with the reference's host-knn input path
        (`core/model.py:148-156`); unnecessary here (no 8192 cap) but
        kept for API compatibility.
      sample_inds: optional [B_total, sampled_kpnum] int32 keypoint ids
        ('sample_ind_anchor/pos' concatenated, `core/model.py:159-163`).
      train: BN batch-stats mode (frozen curriculum stages keep their
        running averages).

    Returns (outs, new_batch_stats): `outs` is the reference's dict
    contract — xyz, feat, local_desc, attention?, xyz_sampled?,
    feat_sampled?, att_sampled?, global_desc?
    """
    cfg = dotdict(cfg)
    new_stats = dict(batch_stats)
    compute_dtype = jnp.dtype(cfg.compute_dtype or "float32")
    dt = None if compute_dtype == jnp.float32 else compute_dtype

    # Morton (Z-order) mode: sort each cloud along the space-filling curve
    # and run every per-point computation in sorted space (FPS then keeps
    # its selection in sorted order).  Sampled-keypoint ids are remapped
    # on entry; dense per-point outputs are un-permuted on exit in eval
    # mode (training losses are permutation-equivariant, so the sorted
    # order is kept there — no unpermute gathers in the train step).
    inv_perm = None
    if cfg.morton_order and not cfg.morton_presorted:
        perm, inv_perm = ops.morton_perm(points)
        points = jnp.take_along_axis(points, perm[..., None], axis=1)
        if sample_inds is not None:
            sample_inds = jnp.take_along_axis(
                inv_perm, sample_inds.reshape(points.shape[0], -1), axis=1)
        if knn_inds is not None:
            # host-provided knn refers to original order: reorder rows
            # into sorted space, then map neighbor ids through inv_perm
            rows = jnp.take_along_axis(knn_inds, perm[..., None], axis=1)
            knn_inds = jax.vmap(lambda iv, r: iv[r])(inv_perm, rows)
    # with `morton_presorted` the loader already sorted the clouds and
    # their indices on the host; outputs stay in sorted order (training)
    sorted_order = bool(cfg.morton_order)

    if knn_inds is None:
        knn_inds, _ = ops.knn_bruteforce(points, cfg.knn_num)

    def unpermute(x):
        """Sorted space -> original point order (eval only)."""
        if inv_perm is None or train:
            return x
        return jnp.take_along_axis(
            x, inv_perm[..., None].astype(jnp.int32), axis=1)

    outs = {"xyz": unpermute(points), "knn_indices": knn_inds}

    # ---- local backbone (`core/model.py:99-108,176`)
    # points stay f32: all geometry (knn/FPS/three_nn/deltas) needs full
    # precision; layers cast features to the compute dtype internally
    def local(p, s, pts, knn):
        return backbones.backbone_local_dilate(
            p, s, pts, knn, train and not cfg.freezebackbone,
            dilate2=cfg.dilate or 8, dtype=dt, sorted_order=sorted_order)

    if cfg.remat:
        # trade recompute for activation memory in the backward pass
        local = jax.checkpoint(local)
    newpoints, localdesc, level_cache, new_stats["local_backbone"] = local(
        params["local_backbone"], batch_stats["local_backbone"], points,
        knn_inds)
    # stage2 and the global stage subsample the SAME full-resolution
    # cloud; when their dilates match, the level geometry — FPS selection,
    # 3-NN interpolation, and kNN when the knn counts also match (stage2
    # is knn8, the global stage uses cfg.knn_num) — is computed once.
    share_level = bool(
        cfg.extract_global
        and _global_backbone(cfg) == "global_before_assemble"
        and (cfg.gl_dilate or 8) == (cfg.dilate or 8) > 1
        and cfg.share_level_cache is not False
    )
    if not share_level:
        level_cache = None
    elif (cfg.knn_num or 8) != 8:
        level_cache = {k: v for k, v in level_cache.items()
                       if k in ("kp_idx", "interp")}

    localdesc = localdesc.astype(jnp.float32)
    localdesc_l2 = l2_normalize(localdesc, axis=-1, epsilon=1e-8)
    outs["feat"] = unpermute(localdesc)
    outs["local_desc"] = unpermute(localdesc_l2)
    outs["xyz_feat"] = unpermute(
        jnp.concatenate([newpoints, localdesc_l2], axis=-1))

    # ---- detector head (`core/model.py:184-188`)
    if cfg.detection:
        det_att, new_stats["detection_block"] = backbones.detection_block(
            params["detection_block"], batch_stats["detection_block"],
            localdesc, train and not cfg.freezedetection,
            use_softplus=bool(cfg.use_softplus), dtype=dt)
        outs["attention"] = unpermute(det_att)
        outs["xyz_feat_att"] = unpermute(jnp.concatenate(
            [newpoints, localdesc_l2, det_att], axis=-1))

    # ---- keypoint subsample (`core/model.py:190-200`)
    if cfg.sampled_kpnum and cfg.sampled_kpnum > 0:
        if sample_inds is None:
            raise ValueError(
                "sampled_kpnum > 0 requires sample_inds "
                "(concat of sample_ind_anchor & sample_ind_pos)"
            )
        xyz_s, feat_s, kp_idx = ops.subsample(
            points, localdesc_l2, cfg.sampled_kpnum, kp_idx=sample_inds
        )
        outs["sample_nodes_concat"] = sample_inds
        outs["xyz_sampled"] = xyz_s
        outs["feat_sampled"] = feat_s
        if cfg.detection:
            outs["att_sampled"] = ops.gather_point(det_att, kp_idx)[..., 0]

    # ---- global head (`core/model.py:112-133,202-206`)
    if cfg.extract_global:
        train_g = train and not cfg.freezeglobal
        gl_dims = tuple(cfg.gl_dims or (256,))
        if _global_backbone(cfg) == "global_before_assemble":
            gpoints, forglobal, new_stats["global_backbone"] = \
                backbones.global_before_assemble(
                    params["global_backbone"], batch_stats["global_backbone"],
                    newpoints, localdesc, train_g,
                    gl_dilate=cfg.gl_dilate or 8, knn_num=cfg.knn_num,
                    gl_dims=gl_dims, concat_xyz=bool(cfg.concat_xyz),
                    dtype=dt, sorted_order=sorted_order,
                    level_cache=level_cache)
        else:
            gpoints, forglobal, new_stats["global_backbone"] = \
                backbones.global_before_assemble_conv1d(
                    params["global_backbone"], batch_stats["global_backbone"],
                    newpoints, localdesc, train_g, gl_dims=gl_dims,
                    concat_xyz=bool(cfg.concat_xyz))
        forglobal = forglobal.astype(jnp.float32)

        if cfg.global_subsample and cfg.global_subsample > 0:
            gpoints, forglobal, _ = ops.subsample(
                gpoints, forglobal, cfg.global_subsample
            )

        global_att, new_stats["globalatt"] = backbones.detection_block(
            params["globalatt"], batch_stats["globalatt"], forglobal,
            train_g, dtype=dt)
        globaldesc, new_stats["global_assemble"] = backbones.netvlad(
            params["global_assemble"], batch_stats["global_assemble"],
            forglobal, global_att, train_g)
        outs["global_desc"] = l2_normalize(
            globaldesc, axis=-1, epsilon=1e-8
        )

    return outs, new_stats


class DH3D:
    """The model bound to its config: `init` makes variables, `apply` runs
    the forward on them."""

    def __init__(self, config):
        self.config = dotdict(config)

    def init(self, rng, *unused_inputs, **unused_kwargs):
        """Variables from the config's shapes; inputs are not needed."""
        return init_variables(self.config, rng)

    def apply(self, variables, points, knn_inds=None, sample_inds=None,
              train=False, mutable=False):
        """Run the forward.  With `mutable` (e.g. ["batch_stats"]) also
        return the updated `{"batch_stats": ...}`."""
        outs, new_stats = forward(
            self.config, variables["params"],
            variables.get("batch_stats", {}), points, knn_inds=knn_inds,
            sample_inds=sample_inds, train=train)
        if mutable:
            return outs, {"batch_stats": new_stats}
        return outs


def concat_tuple_clouds(cfg, anchor, pos=None, neg=None, otherneg=None):
    """Flatten the Siamese tuple along the batch axis
    (`core/model.py:139-146`): [anchor | pos | neg | otherneg] each
    reshaped to [-1, num_points, 3].
    """
    n = cfg.num_points
    parts = [anchor]
    if pos is not None and cfg.num_pos > 0:
        parts.append(pos.reshape(-1, n, 3))
    if neg is not None and cfg.num_neg > 0:
        parts.append(neg.reshape(-1, n, 3))
    if otherneg is not None and cfg.other_neg:
        parts.append(otherneg)
    return jnp.concatenate(parts, axis=0)
