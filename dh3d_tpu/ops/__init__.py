"""Op surface — full parity with the reference's custom CUDA ops.

Reference op surface:
  `user_ops/__init__.py:50-59` (flex family + knn) and
  `tf_ops/{sampling,grouping,interpolation}` (PointNet++ family).
"""

from dh3d_tpu.ops.flex import (
    conv_pointset,
    flex_avg,
    flex_conv,
    flex_deconv,
    flex_pool,
    gather_neighbors,
)
from dh3d_tpu.ops.grouping import (
    group_point,
    knn_point,
    query_ball_point,
    query_ball_point2,
    select_top_k,
)
from dh3d_tpu.ops.interpolate import (
    inverse_distance_weights,
    three_interpolate,
    three_nn,
)
from dh3d_tpu.ops.knn import knn_bruteforce, knn_bruteforce_pairwise
from dh3d_tpu.ops.morton import morton_codes, morton_perm
from dh3d_tpu.ops.sampling import (
    farthest_point_sample,
    gather_point,
    prob_sample,
    subsample,
)

__all__ = [
    "conv_pointset",
    "flex_avg",
    "flex_conv",
    "flex_deconv",
    "flex_pool",
    "gather_neighbors",
    "group_point",
    "knn_point",
    "query_ball_point",
    "query_ball_point2",
    "select_top_k",
    "inverse_distance_weights",
    "three_interpolate",
    "three_nn",
    "knn_bruteforce",
    "knn_bruteforce_pairwise",
    "morton_codes",
    "morton_perm",
    "farthest_point_sample",
    "gather_point",
    "prob_sample",
    "subsample",
]
