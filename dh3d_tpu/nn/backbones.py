"""Network blocks/backbones, mirroring `core/backbones.py`.

Every block takes channel-last tensors and comes as a `<block>_spec` /
`<block>` pair (see nn/layers.py); `train` toggles BN batch-stats mode.
The wiring of each block cites the reference lines it reproduces.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.nn import initializers as init

from dh3d_tpu import ops
from dh3d_tpu.nn.layers import (
    batch_norm,
    batch_norm_spec,
    conv1x1,
    conv1x1_spec,
    conv_pointset_bn,
    conv_pointset_bn_spec,
    dense,
    dense_spec,
    flexconv_bn,
    flexconv_bn_spec,
    l2_normalize,
    param,
    se_res_bottleneck,
    se_res_bottleneck_spec,
)


def flex_conv_dilate_spec(din, outdims, concat=True, add_se="max_pool"):
    spec = {}
    for i, d in enumerate(outdims):
        spec[f"flexconv_{i}"] = flexconv_bn_spec(din if i == 0 else
                                                 outdims[i - 1], d)
    if add_se:
        spec["se"] = se_res_bottleneck_spec(outdims[-1])
    if concat:
        spec["concat_conv1d"] = conv1x1_spec(outdims[-1] + din, outdims[-1])
    return spec


def flex_conv_dilate(p, s, xyz, feat, train, *, dilate, knn, outdims,
                     concat=True, add_se="max_pool", upsample=True,
                     dtype=None, sorted_order=False, knn_indices=None,
                     level_cache=None):
    """flex_conv_dilate (`core/backbones.py:58-101`):
    [FPS subsample by `dilate`] -> knn -> stacked FlexConv+BN -> SE ->
    [3-NN inverse-distance upsample] -> [concat + 1x1].

    `sorted_order` keeps the subsampled set in the parent's (Morton)
    order: the FPS *selection* is unchanged, only its order, which is
    internal to this stage (features are upsampled back to full
    resolution before leaving).

    level_cache: geometry computed by ANOTHER call on the SAME xyz with
    the same dilate (and same knn count for the knn entry) — FPS
    selection, subsampled kNN and 3-NN interpolation are functions of xyz
    alone, so stages that share a resolution level share them verbatim
    (stage2 and the global stage both subsample the full cloud by 8).
    Keys: kp_idx, knn_indices, interp=(dist, idx).

    Returns (xyz, new_feat, cache, new_s)."""
    num_point = xyz.shape[1]
    npoint = num_point // dilate
    lc = dict(level_cache) if level_cache else {}
    cache = {}
    new_s = dict(s)

    if dilate > 1:
        points_s, feat_s, kp_idx = ops.subsample(
            xyz, feat, npoint, kp_idx=lc.get("kp_idx"),
            sorted_order=sorted_order)
        cache["kp_idx"] = kp_idx
    else:
        points_s, feat_s = xyz, feat

    if knn_indices is None:
        knn_indices = lc.get("knn_indices")
    if knn_indices is None:
        knn_indices, _ = ops.knn_bruteforce(points_s, knn)
    cache["knn_indices"] = knn_indices

    x = feat_s
    for i in range(len(outdims)):
        name = f"flexconv_{i}"
        x, new_s[name] = flexconv_bn(p[name], s[name], x, points_s,
                                     knn_indices, train, dtype)

    if add_se == "max_pool":
        x_pool, _ = ops.flex_pool(x, knn_indices)
        x = se_res_bottleneck(p["se"], x, x_pool)
    elif add_se == "avg_pool":
        # flex_avg neighborhood sum scaled by 1/knn
        # (`core/backbones.py:81-83`)
        x_pool = ops.flex_avg(x, knn_indices) * (1.0 / knn)
        x = se_res_bottleneck(p["se"], x, x_pool)

    new_feat = x
    if upsample and dilate > 1:
        interp = lc.get("interp")
        if interp is None:
            interp = ops.three_nn(xyz, points_s)
            cache["interp"] = interp
        dist, idx = interp
        weight = ops.inverse_distance_weights(dist)
        new_feat = ops.three_interpolate(new_feat, idx, weight)

    if concat:
        new_feat = jnp.concatenate([new_feat, feat], axis=-1)
        new_feat, new_s["concat_conv1d"] = conv1x1(
            p["concat_conv1d"], s["concat_conv1d"], new_feat, train,
            dtype=dtype)
    return xyz, new_feat, cache, new_s


def backbone_local_dilate_spec(featdim=128):
    spec = {
        "initconv": conv_pointset_bn_spec(3, 32),
        "stage1": flex_conv_dilate_spec(32, (64, 64), concat=False),
        "before_stage2_conv1d": conv1x1_spec(64, 64),
        "stage2": flex_conv_dilate_spec(64, (128, 128), concat=True),
        "local_stage1_shortcut": conv1x1_spec(64, 128),
    }
    if featdim < 128:
        spec["final_fc"] = conv1x1_spec(128, featdim)
    return spec


def backbone_local_dilate(p, s, points, knn_ind, train, *, dilate2=8,
                          dtype=None, sorted_order=False):
    """backbone_local_dilate (`core/backbones.py:104-127`).

    Returns (points, feat, stage2 level cache, new_s)."""
    new_s = dict(s)
    nn_8 = knn_ind[..., :8]

    # initconv: conv_pointset on raw xyz + BN/relu, then flex max-pool
    # (`core/backbones.py:108-110`)
    init_f, new_s["initconv"] = conv_pointset_bn(
        p["initconv"], s["initconv"], points, nn_8, train)
    init_f, _ = ops.flex_pool(init_f, nn_8)

    # stage 1: full resolution, knn8, dims [64, 64], SE max-pool
    _, x1, _, new_s["stage1"] = flex_conv_dilate(
        p["stage1"], s["stage1"], points, init_f, train, dilate=1, knn=8,
        outdims=(64, 64), concat=False, dtype=dtype, knn_indices=nn_8)

    # stage 2: dilate 8, dims [128, 128], concat + 1x1
    x2, new_s["before_stage2_conv1d"] = conv1x1(
        p["before_stage2_conv1d"], s["before_stage2_conv1d"], x1, train,
        dtype=dtype)
    _, x2, cache, new_s["stage2"] = flex_conv_dilate(
        p["stage2"], s["stage2"], points, x2, train, dilate=dilate2, knn=8,
        outdims=(128, 128), concat=True, dtype=dtype,
        sorted_order=sorted_order)

    # combine with stage-1 shortcut (`core/backbones.py:123`)
    shortcut, new_s["local_stage1_shortcut"] = conv1x1(
        p["local_stage1_shortcut"], s["local_stage1_shortcut"], x1, train,
        dtype=dtype)
    feat = shortcut + x2

    if "final_fc" in p:
        feat, new_s["final_fc"] = conv1x1(p["final_fc"], s["final_fc"],
                                          feat, train)
    return points, feat, cache, new_s


def detection_block_spec(din, conv_dims=(128, 256, 1024)):
    """detection_block (`core/backbones.py:132-151`): 1x1 conv stack ->
    1-logit head (bias init 1/8)."""
    spec = {}
    for i, d in enumerate(conv_dims):
        spec[f"detec_conv{i}"] = conv1x1_spec(din, d)
        din = d
    spec["detec_conv_fc"] = dense_spec(din, 1,
                                       bias_init=init.constant(1.0 / 8))
    return spec


def detection_block(p, s, features, train, use_softplus=False, dtype=None):
    """Keypoint score: sigmoid (or softplus) of the 1-logit head."""
    x, new_s = features, dict(s)
    i = 0
    while f"detec_conv{i}" in p:
        name = f"detec_conv{i}"
        x, new_s[name] = conv1x1(p[name], s[name], x, train, dtype=dtype)
        i += 1
    logits = dense(p["detec_conv_fc"], x)
    act = jax.nn.softplus if use_softplus else jax.nn.sigmoid
    return act(logits), new_s


def global_att_block_spec(featdim):
    """globalatt_block (`core/backbones.py:156-173`): a detection block
    with a width-dependent conv stack and a zero-initialized head bias;
    applied by `detection_block` (sigmoid)."""
    spec = detection_block_spec(
        featdim, (256, 1024) if featdim > 256 else (1024,))
    spec["detec_conv_fc"]["bias"] = param((1,), init.zeros)
    return spec


def global_before_assemble_spec(din, gl_dims=(256,), concat_xyz=False):
    """global_before_assemble (`core/backbones.py:178-186`): one dilated
    flexconv stage (no SE) + upsample."""
    return {"global_before_assemble": flex_conv_dilate_spec(
        din + 3 * bool(concat_xyz), tuple(gl_dims), concat=False, add_se="")}


def global_before_assemble(p, s, points, localdesc, train, *, gl_dilate=8,
                           knn_num=8, gl_dims=(256,), concat_xyz=False,
                           dtype=None, sorted_order=False, level_cache=None):
    if concat_xyz:
        localdesc = jnp.concatenate([points, localdesc], axis=-1)
    name = "global_before_assemble"
    points, x, _, sub = flex_conv_dilate(
        p[name], s[name], points, localdesc, train, dilate=gl_dilate,
        knn=knn_num, outdims=tuple(gl_dims), concat=False, add_se="",
        dtype=dtype, sorted_order=sorted_order, level_cache=level_cache)
    return points, x, {name: sub}


def global_before_assemble_conv1d_spec(din, gl_dims=(256,),
                                       concat_xyz=False):
    """global_before_assemble_conv1d (`core/backbones.py:189-196`)."""
    din += 3 * bool(concat_xyz)
    spec = {}
    for i, d in enumerate(gl_dims):
        spec[f"global_before_assemble_conv1{i}"] = conv1x1_spec(din, d)
        din = d
    return spec


def global_before_assemble_conv1d(p, s, points, localdesc, train,
                                  gl_dims=(256,), concat_xyz=False):
    if concat_xyz:
        localdesc = jnp.concatenate([points, localdesc], axis=-1)
    x, new_s = localdesc, dict(s)
    for i in range(len(gl_dims)):
        name = f"global_before_assemble_conv1{i}"
        x, new_s[name] = conv1x1(p[name], s[name], x, train)
    return points, x, new_s


def context_gating_spec(dim, add_batch_norm=True):
    """context_gating (`core/backbones.py:282-320`)."""
    normal = init.normal(stddev=1.0 / math.sqrt(dim))
    spec = {"gating_weights": param((dim, dim), normal)}
    if add_batch_norm:
        spec["gating_bn"] = batch_norm_spec(dim)
    else:
        spec["gating_biases"] = param((dim,), normal)
    return spec


def context_gating(p, s, x, train):
    gates = x @ p["gating_weights"]
    new_s = dict(s)
    if "gating_bn" in p:
        # slim.batch_norm default decay 0.999 (`core/backbones.py:303-309`)
        gates, new_s["gating_bn"] = batch_norm(
            p["gating_bn"], s["gating_bn"], gates, train, momentum=0.999)
    else:
        gates = gates + p["gating_biases"]
    return x * jax.nn.sigmoid(gates), new_s


def netvlad_spec(D, cluster_size=64, output_dim=256, add_batch_norm=True,
                 gating=True):
    """global_netvald_block (`core/backbones.py:202-279`)."""
    K = cluster_size
    normal_d = init.normal(stddev=1.0 / math.sqrt(D))
    spec = {"cluster_weights": param((D, K), normal_d)}
    if add_batch_norm:
        spec["cluster_bn"] = batch_norm_spec(K)
    else:
        spec["cluster_biases"] = param((K,), normal_d)
    spec["cluster_weights2"] = param((1, D, K), normal_d)
    spec["hidden1_weights"] = param(
        (D * K, output_dim), init.normal(stddev=1.0 / math.sqrt(K)))
    spec["hidden_bn"] = batch_norm_spec(output_dim)
    if gating:
        spec["gating"] = context_gating_spec(output_dim, add_batch_norm)
    return spec


def netvlad(p, s, features, att, train):
    """PCAN-style attention-reweighted NetVLAD aggregation + FC + BN +
    context gating."""
    B, N, D = features.shape
    K = p["cluster_weights"].shape[-1]
    new_s = dict(s)
    x = l2_normalize(features, axis=-1)  # per-point l2 (`:209`)

    act = jnp.einsum("bnd,dk->bnk", x, p["cluster_weights"],
                     precision="highest",
                     preferred_element_type=jnp.float32)
    if "cluster_bn" in p:
        # slim.batch_norm default decay 0.999 (`core/backbones.py:218-223`)
        act, new_s["cluster_bn"] = batch_norm(
            p["cluster_bn"], s["cluster_bn"], act, train, momentum=0.999)
    else:
        act = act + p["cluster_biases"]
    act = jax.nn.softmax(act, axis=-1)
    act = act * att  # attention reweighting (`:232-236`), att [B,N,1]

    a_sum = jnp.sum(act, axis=1, keepdims=True)  # [B,1,K]
    a = a_sum * p["cluster_weights2"]  # [B,D,K]

    vlad = jnp.einsum("bnk,bnd->bdk", act, x,
                      precision="highest",
                      preferred_element_type=jnp.float32)  # [B,D,K]
    vlad = vlad - a
    vlad = l2_normalize(vlad, axis=1)  # intra-normalize over D (`:258`)
    vlad = vlad.reshape(B, D * K)
    vlad = l2_normalize(vlad, axis=-1)

    vlad = vlad @ p["hidden1_weights"]
    # tf.contrib.layers.batch_norm default decay 0.999
    # (`core/backbones.py:275-279`)
    vlad, new_s["hidden_bn"] = batch_norm(p["hidden_bn"], s["hidden_bn"],
                                          vlad, train, momentum=0.999)
    if "gating" in p:
        vlad, new_s["gating"] = context_gating(p["gating"], s["gating"],
                                               vlad, train)
    return vlad, new_s
