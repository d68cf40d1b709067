from dh3d_tpu.nn import backbones, layers  # noqa: F401
from dh3d_tpu.nn.model import (  # noqa: F401
    DH3D,
    concat_tuple_clouds,
    forward,
    init_variables,
    model_spec,
)
