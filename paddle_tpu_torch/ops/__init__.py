"""Operators of the port (counterpart of `paddle_tpu/ops/`): importing
this package registers the op kernels of `kernels_math`,
`kernels_tensor`, `kernels_nn` and `kernels_optim` in `registry`; under
`kern/` are the hand-written CUDA kernels with their plain versions
beside them."""
from . import registry
from . import (kernels_math, kernels_nn, kernels_optim,  # noqa: F401
               kernels_tensor)
from .registry import KERNELS, get_kernel  # noqa: F401
