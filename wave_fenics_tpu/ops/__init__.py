from . import (  # noqa: F401
    assembled,
    element_kernels,
    gather_scatter,
    la,
    operators,
    separable,
)
