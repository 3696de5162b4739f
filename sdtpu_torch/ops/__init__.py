from .attention import attention  # noqa: F401
from .basic import (  # noqa: F401
    conv2d,
    gelu,
    gelu_tanh,
    group_norm,
    layer_norm,
    linear,
    quick_gelu,
    rms_norm,
    silu,
    timestep_embedding,
)
