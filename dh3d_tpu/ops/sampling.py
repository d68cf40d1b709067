"""Point sampling ops (PointNet++ family).

Ground-truth semantics: `tf_ops/sampling/tf_sampling_g.cu` —
  farthest_point_sample  `:105-170` (seed index 0, iterative max-of-min-dist)
  gather_point           `:172-180`
  prob_sample            `:7-104` (cumsum + inverse-CDF binary search)
Python surface: `tf_ops/sampling/tf_sampling.py:15-74`.

FPS is inherently sequential (m dependent iterations).  On the GPU it runs
as one Triton kernel with one program per cloud and the whole loop inside
it — the reference CUDA kernel's design (one block per cloud, cloud
resident on chip).  Elsewhere it is a `lax.fori_loop` over the [B, N]
running min-distance, which on a GPU would launch several tiny kernels
per step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton


def farthest_point_sample(points, npoint):
    """Iterative farthest point sampling.

    Args:
      points: [B, N, 3] coordinates.
      npoint: number of samples m (<= N).

    Returns:
      [B, m] int32 indices.  Seeded at index 0 like the reference kernel
      (`tf_sampling_g.cu:114-116`); the next sample is always the point
      maximizing the min distance to all previously chosen ones.  The
      implementation is chosen by the platform the call is lowered for:
      the Triton kernel on CUDA, the `fori_loop` everywhere else.
    """
    return jax.lax.platform_dependent(
        points,
        cuda=functools.partial(fps_triton, npoint=npoint),
        default=functools.partial(_fps_xla, npoint=npoint),
    )


def _sqdist(x, y, z, lx, ly, lz):
    # one expression shared by both implementations, so the GPU kernel and
    # the XLA loop round identically and pick the same argmax
    dx, dy, dz = x - lx, y - ly, z - lz
    return dx * dx + dy * dy + dz * dz


@functools.partial(jax.jit, static_argnames=("npoint",))
def _fps_xla(points, npoint):
    B, N, _ = points.shape
    x, y, z = (points[..., c] for c in range(3))

    def body(j, carry):
        mindist, idxs, last = carry
        pick = lambda c: jnp.take_along_axis(c, last[:, None], axis=1)
        d = _sqdist(x, y, z, pick(x), pick(y), pick(z))  # [B, N]
        mindist = jnp.minimum(mindist, d)
        nxt = jnp.argmax(mindist, axis=-1).astype(jnp.int32)  # [B]
        idxs = idxs.at[:, j].set(nxt)
        return mindist, idxs, nxt

    init_idx = jnp.zeros((B, npoint), jnp.int32)
    init_last = jnp.zeros((B,), jnp.int32)
    mindist = jnp.full((B, N), jnp.inf, points.dtype)
    _, idxs, _ = jax.lax.fori_loop(1, npoint, body,
                                   (mindist, init_idx, init_last))
    return idxs


def _fps_kernel(x_ref, y_ref, z_ref, o_ref, *, npoint):
    """One cloud: coordinates [n] each, indices [m] (n, m powers of two)."""
    x, y, z = x_ref[...], y_ref[...], z_ref[...]
    n, m = x.shape[0], o_ref.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    slot = jax.lax.broadcasted_iota(jnp.int32, (m,), 0)

    def body(j, carry):
        mind, last, out = carry
        # the last pick's coordinates by masked reduction (exact: one
        # nonzero term)
        sel = lane == last
        pick = lambda c: jnp.sum(jnp.where(sel, c, 0.0))
        d = _sqdist(x, y, z, pick(x), pick(y), pick(z))
        mind = jnp.minimum(mind, d)
        nxt = jnp.argmax(mind).astype(jnp.int32)  # lowest index on ties
        return mind, nxt, jnp.where(slot == j, nxt, out)

    init = (jnp.full((n,), jnp.inf, jnp.float32), jnp.int32(0),
            jnp.zeros((m,), jnp.int32))
    _, _, out = jax.lax.fori_loop(1, npoint, body, init)
    o_ref[...] = out


def _fps_num_warps(n):
    """Warps per program: 32 points per thread (8192 points -> 8 warps;
    on an H100 at [20,8192]->1024: 8 warps 1.79 ms, 16 1.98, 32 2.37,
    4 7.04)."""
    return max(4, min(32, n // 1024))


@functools.partial(jax.jit, static_argnames=("npoint", "interpret"))
def fps_triton(points, npoint, interpret=False):
    """points [B, N, 3] float32 -> [B, npoint] int32 FPS indices.

    One Triton program per cloud keeps the cloud and its running
    min-distance in registers for all `npoint` steps.  Triton blocks are
    powers of two: N is padded with copies of point 0, whose min-distance
    is 0 from the first step on, so they are never picked while
    npoint <= N; the index block is padded and sliced.
    """
    points = points.astype(jnp.float32)
    B, N, _ = points.shape
    if npoint > N:
        raise ValueError(f"npoint={npoint} exceeds N={N}")
    n = pl.next_power_of_2(N)
    m = pl.next_power_of_2(npoint)
    if n > N:
        points = jnp.concatenate(
            [points, jnp.broadcast_to(points[:, :1], (B, n - N, 3))], axis=1)
    coords = [points[..., c] for c in range(3)]  # 3 x [B, n]
    spec = pl.BlockSpec((None, n), lambda b: (b, 0))
    idx = pl.pallas_call(
        functools.partial(_fps_kernel, npoint=npoint),
        out_shape=jax.ShapeDtypeStruct((B, m), jnp.int32),
        grid=(B,),
        in_specs=[spec, spec, spec],
        out_specs=pl.BlockSpec((None, m), lambda b: (b, 0)),
        compiler_params=pltriton.CompilerParams(
            num_warps=_fps_num_warps(n), num_stages=1),
        backend="triton",
        interpret=interpret,
        name="fps_triton",
    )(*coords)
    return idx[:, :npoint]


def gather_point(points, idx):
    """points [B, N, C], idx [B, M] -> [B, M, C] (`tf_sampling_g.cu:172-180`)."""
    return jnp.take_along_axis(points, idx[..., None], axis=1)


def prob_sample(inp, inp_r):
    """Inverse-CDF categorical sampling (`tf_sampling_g.cu:7-104`).

    inp: [B, N] unnormalized distribution; inp_r: [B, M] uniforms in [0, sum).
    Returns [B, M] int32 sampled indices.
    """
    cdf = jnp.cumsum(inp, axis=-1)  # [B, N]
    idx = jax.vmap(lambda c, r: jnp.searchsorted(c, r, side="left"))(cdf, inp_r)
    return jnp.clip(idx, 0, inp.shape[-1] - 1).astype(jnp.int32)


def subsample(points, feat, targetnum, kp_idx=None, sorted_order=False):
    """FPS (or provided indices) + gather of xyz and features.

    Mirrors `core/tf_utils.py:86-96`.  kp_idx: [B, M] or [B, M, 1] int.
    `sorted_order=True` returns the FPS selection in ascending-index order
    (keeps a Morton-sorted parent's order; the selected SET is identical).
    Returns (xyz_sampled [B,M,3], feat_sampled [B,M,C], kp_indices [B,M]).
    """
    if kp_idx is None:
        kp_indices = farthest_point_sample(points, targetnum)
        if sorted_order:
            kp_indices = jnp.sort(kp_indices, axis=-1)
    else:
        kp_indices = kp_idx.reshape(kp_idx.shape[0], -1)
    return (
        gather_point(points, kp_indices),
        gather_point(feat, kp_indices),
        kp_indices,
    )
