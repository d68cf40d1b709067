"""DH3D in JAX: a point-cloud feature framework.

Re-implements the full capability surface of DH3D ("Deep Hierarchical 3D
Descriptors for Robust Large-Scale 6DoF Relocalization", ECCV 2020): every
custom CUDA op of the reference becomes an XLA formulation over
static-shape, fixed-K neighborhoods (FPS is a Pallas Triton kernel on the
GPU); the model is one jit-compiled forward pass; training is
data-parallel over a `jax.sharding.Mesh`.

Layout convention: this framework is channel-LAST ([B, N, C]) end to end,
whereas the reference CUDA ops are channel-first ([B, C, N]). Docstrings cite the
reference files that define each op's ground-truth semantics.
"""

__version__ = "0.1.0"

from dh3d_tpu import ops  # noqa: F401
