"""Activation layers (counterpart of `paddle_tpu/layers/ops.py`, whose
layers `layer_function_generator.generate_layer_fn_noattr` builds):
`sigmoid` only, with the reference's X -> Out op; the other
activations are not ported."""
from ..layer_helper import LayerHelper

__all__ = ["sigmoid"]


def sigmoid(x, name=None):
    helper = LayerHelper("sigmoid", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("sigmoid", {"X": [x]}, {"Out": [out]}, {})
    return out
