"""FlexConv op family.

The reference implements these as hand-written CUDA kernels with atomicAdd
scatter backward passes (`user_ops/kernels/*.cu.cc`).  Here every op is
re-expressed as gather -> moment reduction -> one matmul, and JAX autodiff
derives the backward pass (gather transposes to a scatter-add, which XLA
may implement with atomics on a GPU, so gradient sums can differ in the
last bits from run to run).

Ground-truth semantics (CPU reference kernels):
  flex_conv      `user_ops/kernels/flex_conv_kernel.cc:25-167`
  flex_pool      `user_ops/kernels/flex_pool_kernel.cc:23-97`
  flex_deconv    `user_ops/kernels/flex_deconv_kernel.cc:24-70`
  conv_pointset  `user_ops/kernels/conv_pointset_kernel.cc:26-66`

Key identity used for flex_conv: with neighborhood N(n) (k=0 == self n0),
    out[n, dout] = sum_k sum_din (bias[din,dout]
                     + sum_dp theta[dp,din,dout] * (pos[nk]-pos[n0])[dp])
                   * feat[nk, din]
               = M[n, :] @ W     where
    M[n] = sum_k  [1, (pos[nk]-pos[n0])] (outer) feat[nk]   # [(1+Dp)*Din]
    W    = stack([bias, theta])                              # [(1+Dp)*Din, Dout]
i.e. one neighborhood moment reduction followed by a single [B*N, (1+Dp)Din]
x [(1+Dp)Din, Dout] matmul.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_neighbors(values, neighborhood):
    """values [B, N, C], neighborhood [B, M, K] int -> [B, M, K, C]."""
    return jax.vmap(lambda v, idx: v[idx])(values, neighborhood)


def _flex_moments(features, positions, neighborhood):
    """Neighborhood moments for flex_conv.

    features [B,N,Din], positions [B,N,Dp], neighborhood [B,N,K]
    -> M [B, N, (1+Dp)*Din] with layout [p, din] flattened p-major, matching
    W = concat([bias[None], theta], axis=0).reshape((1+Dp)*Din, Dout).
    """
    f_k = gather_neighbors(features, neighborhood)  # [B,N,K,Din]
    p_k = gather_neighbors(positions, neighborhood)  # [B,N,K,Dp]
    # delta relative to the *first* neighborhood entry (== self for knn),
    # `flex_conv_kernel.cc:59-60`.  Computed in the POSITION dtype (keep
    # positions f32 under mixed precision: absolute coordinates ~100 m in
    # bf16 would quantize deltas at ~0.5 m), then cast to the feature
    # compute dtype for the moment matmul.
    delta = (p_k - p_k[:, :, :1, :]).astype(f_k.dtype)  # [B,N,K,Dp]
    m0 = jnp.sum(f_k, axis=2)  # [B,N,Din]
    m1 = jnp.einsum("bnkp,bnkd->bnpd", delta, f_k,
                    precision="highest", preferred_element_type=jnp.float32)  # [B,N,Dp,Din]
    B, N, Dp, Din = m1.shape
    return jnp.concatenate([m0[:, :, None, :], m1], axis=2).reshape(
        B, N, (1 + Dp) * Din
    )


def flex_conv(features, positions, neighborhood, theta, bias):
    """Flex convolution: linear-in-position dynamic filter over neighborhoods.

    Args:
      features: [B, N, Din] (reference: [B, Din, N]).
      positions: [B, N, Dp].
      neighborhood: [B, N, K] int32, entry k=0 must be the center point.
      theta: [Dp, Din, Dout] spatial weights.
      bias: [Din, Dout] position-independent weights.

    Returns:
      [B, N, Dout].
    """
    Dp, Din, Dout = theta.shape
    m = _flex_moments(features, positions, neighborhood)
    w = jnp.concatenate([bias[None], theta], axis=0)  # [1+Dp, Din, Dout]
    w = w.reshape((1 + Dp) * Din, Dout)
    return jnp.einsum("bnc,cd->bnd", m, w, precision="highest",
                      preferred_element_type=jnp.float32)


def flex_avg(features, neighborhood):
    """Neighborhood sum — the `Flex_Avg` layer (`core/layers.py:342-436`):
    a flex_conv with zero theta and identity bias reduces to
    out[n] = sum_k feat[nk]; the caller scales by 1/K (`core/backbones.py:82`).
    """
    return jnp.sum(gather_neighbors(features, neighborhood), axis=2)


def flex_pool(features, neighborhood):
    """Max-pool over each point's neighborhood.

    features [B,N,D], neighborhood [B,M,K] -> (out [B,M,D], argmax [B,M,D]
    int32 holding *global* point ids, `flex_pool_kernel.cc:50-55`).
    """
    f_k = gather_neighbors(features, neighborhood)  # [B,M,K,D]
    out = jnp.max(f_k, axis=2)
    arg_k = jnp.argmax(f_k, axis=2)  # [B,M,D] in-neighborhood slot
    argmax = jnp.take_along_axis(
        neighborhood[..., None].astype(jnp.int32),
        arg_k[:, :, None, :].astype(jnp.int32),
        axis=2,
    )[:, :, 0, :]
    return out, argmax


def flex_deconv(features, positions, neighborhood, theta, bias):
    """Transpose flex convolution: each point n scatters W(n,k) * feat[n0]
    into its neighbors nk (`flex_deconv_kernel.cc:49-69`).

    features [B,N,Din], positions [B,N,Dp], neighborhood [B,N,K],
    theta [Dp,Din,Dout], bias [Din,Dout] -> [B,N,Dout].
    """
    B, N, K = neighborhood.shape
    Dp, Din, Dout = theta.shape
    self_idx = neighborhood[:, :, 0]  # [B,N]
    f_self = jnp.take_along_axis(features, self_idx[..., None], axis=1)  # [B,N,Din]
    p_k = gather_neighbors(positions, neighborhood)  # [B,N,K,Dp]
    p_self = jnp.take_along_axis(positions, self_idx[..., None], axis=1)
    delta = p_k - p_self[:, :, None, :]  # [B,N,K,Dp]
    # contribution[b,n,k,dout] = (bias + delta . theta) . f_self
    w = jnp.concatenate(
        [jnp.ones((B, N, K, 1), features.dtype), delta], axis=-1
    )  # [B,N,K,1+Dp]
    wmat = jnp.concatenate([bias[None], theta], axis=0)  # [1+Dp,Din,Dout]
    contrib = jnp.einsum("bnkp,bnd,pde->bnke", w, f_self, wmat,
                         precision="highest", preferred_element_type=jnp.float32)
    # scatter-add into neighbor slots (an XLA segment sum)
    flat_idx = (neighborhood + (jnp.arange(B, dtype=neighborhood.dtype)
                                * N)[:, None, None]).reshape(-1)
    out = jax.ops.segment_sum(
        contrib.reshape(B * N * K, Dout), flat_idx, num_segments=B * N
    )
    return out.reshape(B, N, Dout)


def conv_pointset(features, neighborhood, theta, bias):
    """1x1 conv on neighborhood feature *differences* ("conv_relative",
    DH3D's own op, `conv_pointset_kernel.cc:49-64`):

      out[n, dout] = sum_k sum_din theta[din,dout]*(feat[nk]-feat[n0])[din]
                     + bias[dout]           # bias added once (at k_==0)

    features [B,N,Din], neighborhood [B,N,K], theta [Din,Dout], bias [Dout]
    -> [B,N,Dout].
    """
    f_k = gather_neighbors(features, neighborhood)  # [B,N,K,Din]
    f0 = f_k[:, :, :1, :]
    diff_sum = jnp.sum(f_k - f0, axis=2)  # [B,N,Din]
    return (
        jnp.einsum("bnd,de->bne", diff_sum, theta,
                   precision="highest", preferred_element_type=jnp.float32)
        + bias
    )
