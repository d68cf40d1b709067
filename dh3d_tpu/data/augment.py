"""Point-cloud augmentations.

Host (numpy) versions mirror `core/augment.py` (from 3DFeatNet) with the
same distributions/defaults; each also has an on-device JAX counterpart
(`jax_*`) so the whole augmentation pipeline can run inside the jitted
train step — an upgrade (the reference augments per-cloud in the
Python dataflow, a host hot loop, SURVEY.md §3.1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# -------------------------- host (numpy) versions --------------------------

class Augmentation:
    def apply(self, data, rng=None):
        raise NotImplementedError


class Jitter(Augmentation):
    """Gaussian position jitter, sigma 0.05 clipped at 0.1
    (`core/augment.py:41-55`)."""

    def __init__(self, sigma=0.05, clip=0.1):
        self.sigma, self.clip = sigma, clip

    def apply(self, data, rng=None):
        rng = rng or np.random
        noise = np.clip(self.sigma * rng.randn(*data.shape),
                        -self.clip, self.clip)
        return data + noise


class Shift(Augmentation):
    """Uniform global shift +-0.1 (`core/augment.py:58-67`)."""

    def __init__(self, shift_range=0.1):
        self.shift_range = shift_range

    def apply(self, data, rng=None):
        rng = rng or np.random
        return data + rng.uniform(-self.shift_range, self.shift_range, 3)


def _rot_z(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def _rot_y(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


class RotateZ(Augmentation):
    """Full-revolution rotation about z (`core/augment.py:70-84`)."""

    def apply(self, data, rng=None):
        rng = rng or np.random
        return np.dot(data, _rot_z(rng.uniform() * 2 * np.pi))


class RotateY(Augmentation):
    """Full-revolution rotation about y (`core/augment.py:87-101`)."""

    def apply(self, data, rng=None):
        rng = rng or np.random
        return np.dot(data, _rot_y(rng.uniform() * 2 * np.pi))


class RotateSmall(Augmentation):
    """Small all-axis rotation, sigma 0.06 clip 0.18
    (`core/augment.py:104-128`)."""

    def __init__(self, angle_sigma=0.06, angle_clip=0.18):
        self.angle_sigma, self.angle_clip = angle_sigma, angle_clip

    def apply(self, data, rng=None):
        rng = rng or np.random
        a = np.clip(self.angle_sigma * rng.randn(3),
                    -self.angle_clip, self.angle_clip)
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(a[0]), -np.sin(a[0])],
                       [0, np.sin(a[0]), np.cos(a[0])]])
        Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])],
                       [0, 1, 0],
                       [-np.sin(a[1]), 0, np.cos(a[1])]])
        Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                       [np.sin(a[2]), np.cos(a[2]), 0],
                       [0, 0, 1]])
        return np.dot(data, Rz @ Ry @ Rx)


class Scale(Augmentation):
    """Uniform scale in [0.8, 1.25] (`core/augment.py:131-141`)."""

    def __init__(self, scale_low=0.8, scale_high=1.25):
        self.scale_low, self.scale_high = scale_low, scale_high

    def apply(self, data, rng=None):
        rng = rng or np.random
        return data * rng.uniform(self.scale_low, self.scale_high)


def get_augmentations_from_list(str_list, upright_axis=2):
    """String-list selection (`core/augment.py:7-32`)."""
    if str_list is None:
        return []
    augs = []
    if "Rotate1D" in str_list:
        augs.append(RotateY() if upright_axis == 1 else RotateZ())
    if "Jitter" in str_list:
        augs.append(Jitter())
    if "Scale" in str_list:
        augs.append(Scale())
    if "RotateSmall" in str_list:
        augs.append(RotateSmall())
    if "Shift" in str_list:
        augs.append(Shift())
    return augs


# ------------------------- on-device (jax) versions ------------------------

def jax_jitter(key, data, sigma=0.05, clip=0.1):
    noise = jnp.clip(sigma * jax.random.normal(key, data.shape), -clip, clip)
    return data + noise


def jax_shift(key, data, shift_range=0.1):
    return data + jax.random.uniform(
        key, (3,), minval=-shift_range, maxval=shift_range
    )


def jax_rotate_z(key, data):
    a = jax.random.uniform(key) * 2 * jnp.pi
    c, s = jnp.cos(a), jnp.sin(a)
    rot = jnp.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    # precision: the default on a GPU (TF32, 10 mantissa bits) would
    # quantize rotated coordinates (~5 cm at 100 m)
    return jnp.matmul(data, rot, precision="highest")


def jax_rotate_small(key, data, angle_sigma=0.06, angle_clip=0.18):
    a = jnp.clip(angle_sigma * jax.random.normal(key, (3,)),
                 -angle_clip, angle_clip)
    cx, sx = jnp.cos(a[0]), jnp.sin(a[0])
    cy, sy = jnp.cos(a[1]), jnp.sin(a[1])
    cz, sz = jnp.cos(a[2]), jnp.sin(a[2])
    Rx = jnp.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], data.dtype)
    Ry = jnp.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], data.dtype)
    Rz = jnp.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], data.dtype)
    rot = jnp.matmul(jnp.matmul(Rz, Ry, precision="highest"), Rx,
                     precision="highest")
    return jnp.matmul(data, rot, precision="highest")


def jax_scale(key, data, lo=0.8, hi=1.25):
    return data * jax.random.uniform(key, minval=lo, maxval=hi)


_JAX_AUGS = {
    "Jitter": jax_jitter,
    "Shift": jax_shift,
    "Rotate1D": jax_rotate_z,
    "RotateSmall": jax_rotate_small,
    "Scale": jax_scale,
}


def jax_augment(key, data, names):
    """Apply the named augmentations on device. data: [N, 3] or [B, N, 3]
    (batched via vmap by the caller for independent per-cloud draws)."""
    for name in names:
        if name not in _JAX_AUGS:
            raise KeyError(f"unknown augmentation {name}")
        key, sub = jax.random.split(key)
        data = _JAX_AUGS[name](sub, data)
    return data
