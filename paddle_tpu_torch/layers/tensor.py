"""Tensor-creation layers (counterpart of `paddle_tpu/layers/tensor.py`:
`fill_constant` only; the other creation layers are not ported)."""
from ..core.dtypes import convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["fill_constant"]


def fill_constant(shape, dtype, value, force_cpu=False, out=None,
                  name=None):
    helper = LayerHelper("fill_constant", name=name)
    dtype = convert_dtype(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype, tuple(shape), True)
    helper.append_op("fill_constant", {}, {"Out": [out]},
                     {"shape": [int(s) for s in shape], "dtype": dtype,
                      "value": float(value)})
    return out
