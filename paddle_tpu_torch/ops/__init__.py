"""Operators of the port (counterpart of `paddle_tpu/ops/`): importing
this package registers the op kernels of `kernels_math`,
`kernels_tensor` and `kernels_nn` in `registry`; under `kern/` are the
hand-written CUDA kernels with their plain versions beside them."""
from . import registry
from . import kernels_math, kernels_nn, kernels_tensor  # noqa: F401
from .registry import KERNELS, get_kernel  # noqa: F401
