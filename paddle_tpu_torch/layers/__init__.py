"""The layer function library (counterpart of
`paddle_tpu/layers/__init__.py`), as far as the port goes: the layers
the Transformer and DeepFM programs call. Operator overloading on
Variables (`math_op_patch`) and every other submodule are not ported."""
from . import io, nn, ops, sequence, tensor
from .io import *            # noqa: F401,F403
from .nn import *            # noqa: F401,F403
from .ops import *           # noqa: F401,F403
from .sequence import *      # noqa: F401,F403
from .tensor import *        # noqa: F401,F403

__all__ = (io.__all__ + nn.__all__ + ops.__all__ + sequence.__all__
           + tensor.__all__)
