"""Operators of the port (counterpart of `paddle_tpu/ops/`): importing
this package registers the op kernels of `kernels_math`,
`kernels_tensor`, `kernels_nn`, `kernels_optim` and `kernels_extra` in
`registry`; under
`kern/` are the hand-written CUDA kernels with their plain versions
beside them."""
from . import registry
from . import (kernels_extra, kernels_math, kernels_nn,  # noqa: F401
               kernels_optim, kernels_tensor)
from .registry import KERNELS, get_kernel  # noqa: F401
