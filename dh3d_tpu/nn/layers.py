"""Layers as plain JAX functions over nested parameter dicts.

Mirrors the reference layer surface (`core/layers.py`, `core/tf_utils.py`):
FlexConv/ConvPointset with their BatchNorm-sandwich helpers
(`core/tf_utils.py:48-83`), the 1x1 feature conv (`core/tf_utils.py:99-109`),
and the SE bottleneck (`core/backbones.py:45-55`).

Every layer comes as a pair:
  - `<layer>_spec(...)` describes its variables: a nested dict whose leaves
    are `Var(collection, shape, init)`; `init_from_spec` turns it into the
    `{"params": ..., "batch_stats": ...}` trees from a key and the shapes
    alone, with no forward trace;
  - `<layer>(p, s, ...)` applies it to its params `p` and batch stats `s`
    and returns `(y, new_s)`; `train=False` returns `s` unchanged.

Variable paths and shapes are the ones the committed checkpoints use
(`models/demo_stage*.npz`).  Parameter shapes/initializers follow
`core/layers.py:252-288`:
  theta (position_theta) [Dp, Din, Dout]  glorot_uniform (Keras default)
  position_bias          [Din, Dout]      zeros
  feature_bias           [Dout]           zeros
BatchNorm is over the channel axis (reference: NCHW BN over dim 1 ==
channel; here channel-last, so axis=-1), momentum 0.9, eps 1e-5.  Under a
jit over a data-parallel mesh its batch statistics are global-batch (sync
BN): the mean over the sharded batch axis is a cross-device reduction.
"""

from __future__ import annotations

import zlib
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.nn import initializers as init

from dh3d_tpu import ops


class Var(NamedTuple):
    """Spec leaf: one variable of a collection."""

    collection: str  # "params" | "batch_stats"
    shape: tuple
    init: Callable  # (key, shape, dtype) -> array


def param(shape, initializer):
    return Var("params", tuple(shape), initializer)


def init_from_spec(spec, rng):
    """Materialize a spec into {"params": ..., "batch_stats": ...}.

    Each variable's key is `rng` folded with a hash of its path, so a value
    depends on the seed and its path, not on the order of construction."""
    out = {"params": {}, "batch_stats": {}}

    def walk(node, path):
        for name, v in node.items():
            if isinstance(v, Var):
                key = jax.random.fold_in(
                    rng, zlib.crc32("/".join(path + (name,)).encode()))
                dst = out[v.collection]
                for p in path:
                    dst = dst.setdefault(p, {})
                dst[name] = v.init(key, v.shape, jnp.float32)
            else:
                walk(v, path + (name,))

    walk(spec, ())
    return out


def l2_normalize(x, axis=-1, epsilon=1e-8):
    """tf.nn.l2_normalize semantics: x / sqrt(max(sum(x^2), eps))
    (`core/model.py:177,205`)."""
    sq = jnp.sum(jnp.square(x), axis=axis, keepdims=True)
    return x * (1.0 / jnp.sqrt(jnp.maximum(sq, epsilon)))


# ------------------------------- BatchNorm -------------------------------

def batch_norm_spec(c):
    return {"bn": {"scale": param((c,), init.ones),
                   "bias": param((c,), init.zeros),
                   "mean": Var("batch_stats", (c,), init.zeros),
                   "var": Var("batch_stats", (c,), init.ones)}}


def batch_norm(p, s, x, train, momentum=0.9, epsilon=1e-5):
    """Channel BN (statistics over every axis but the last, in float32).

    Train mode normalizes with the batch statistics (variance as
    E[x^2] - E[x]^2, clipped at 0) and returns the running averages
    updated with `momentum`; eval mode uses the running averages."""
    p, s = p["bn"], s["bn"]
    x = x.astype(jnp.float32)
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axes)
        var = jnp.maximum(0.0, jnp.mean(jnp.square(x), axes)
                          - jnp.square(mean))
        s = {"mean": momentum * s["mean"] + (1.0 - momentum) * mean,
             "var": momentum * s["var"] + (1.0 - momentum) * var}
    else:
        mean, var = s["mean"], s["var"]
    y = x - mean
    mul = jax.lax.rsqrt(var + epsilon) * p["scale"]
    return y * mul + p["bias"], {"bn": s}


# ------------------------------ dense layers ------------------------------

def dense_spec(din, dout, kernel_init=init.he_normal(),
               bias_init=init.zeros):
    return {"kernel": param((din, dout), kernel_init),
            "bias": param((dout,), bias_init)}


def dense(p, x, dtype=None):
    """x @ kernel + bias, in `dtype` (default: the promoted input type)."""
    kernel, bias = p["kernel"], p["bias"]
    dtype = dtype or jnp.result_type(x, kernel, bias)
    x, kernel, bias = (a.astype(dtype) for a in (x, kernel, bias))
    return jnp.dot(x, kernel) + bias


def conv1x1_spec(din, dout, bn=True):
    spec = {"dense": dense_spec(din, dout)}
    if bn:
        spec["norm"] = batch_norm_spec(dout)
    return spec


def conv1x1(p, s, x, train, act=jax.nn.relu, dtype=None):
    """feature_conv1d_1 (`core/tf_utils.py:99-109`): pointwise Dense, then
    BN when the spec has one, then `act` (default relu: tensorpack's
    BNReLU; `act=None` leaves it linear)."""
    x = dense(p["dense"], x, dtype)
    if "norm" in p:
        x, s = batch_norm(p["norm"], s["norm"], x, train)
        s = {"norm": s}
    if act is not None:
        x = act(x)
    return x, s


# --------------------------- point-cloud layers ---------------------------

def flexconv_bn_spec(din, dout, dp=3):
    """flexconv_withBatchnorm (`core/tf_utils.py:48-64`)."""
    return {
        "flexconv": {
            "position_theta": param(
                (dp, din, dout),
                init.glorot_uniform(in_axis=(0, 1), out_axis=2)),
            "position_bias": param((din, dout), init.zeros),
            "feature_bias": param((dout,), init.zeros),
        },
        "norm": batch_norm_spec(dout),
    }


def flexconv_bn(p, s, feat, pos, nbh, train, dtype=None):
    """Flex convolution (`core/layers.py:178-339`) -> BN -> relu.

    `dtype` is the compute dtype (mixed precision): params are stored f32
    and cast at use; the neighbor gather + moment matmul run in `dtype`
    with f32 accumulation.  Positions stay f32 (geometric precision; the
    op casts the deltas after subtraction).  BN/activation stay f32."""
    fp = p["flexconv"]
    theta, pos_bias = fp["position_theta"], fp["position_bias"]
    if dtype is not None:
        feat, theta, pos_bias = (a.astype(dtype)
                                 for a in (feat, theta, pos_bias))
    y = ops.flex_conv(feat, pos, nbh, theta, pos_bias) + fp["feature_bias"]
    y, s = batch_norm(p["norm"], s["norm"], y, train)
    return jax.nn.relu(y), {"norm": s}


def conv_pointset_bn_spec(din, dout):
    """convolution_pointset_withBatchnorm (`core/tf_utils.py:67-83`);
    theta [Din, Dout], bias [Dout] (`core/layers.py:564-`)."""
    return {"conv": {"theta": param((din, dout), init.glorot_uniform()),
                     "bias": param((dout,), init.zeros)},
            "norm": batch_norm_spec(dout)}


def conv_pointset_bn(p, s, feat, nbh, train):
    y = ops.conv_pointset(feat, nbh, p["conv"]["theta"], p["conv"]["bias"])
    y, s = batch_norm(p["norm"], s["norm"], y, train)
    return jax.nn.relu(y), {"norm": s}


def se_res_bottleneck_spec(ch_out):
    """se_res_bottleneck (`core/backbones.py:45-55`)."""
    return {"f1": conv1x1_spec(ch_out, ch_out // 4, bn=False),
            "f2": conv1x1_spec(ch_out // 4, ch_out, bn=False)}


def se_res_bottleneck(p, x, pool_x):
    """Per-point squeeze-excite on pooled features, residual, relu.

    Unlike classic SE there is NO global pooling — `pool_x` is the
    neighborhood-pooled feature map and the two 1x1 convs act per point.
    The squeeze convs are PLAIN conv + activation — no BatchNorm: the
    reference passes `ac_func=tf.nn.relu`/`tf.nn.sigmoid` to
    `feature_conv1d_1` (`core/backbones.py:37-38`), which *replaces* the
    default BNReLU activation (`core/tf_utils.py:99,105`)."""
    s = jax.nn.relu(dense(p["f1"]["dense"], pool_x))
    s = jax.nn.sigmoid(dense(p["f2"]["dense"], s))
    return jax.nn.relu(x + x * s)
