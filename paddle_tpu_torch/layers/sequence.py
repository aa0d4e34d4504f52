"""Sequence layers on padded batches (counterpart of
`paddle_tpu/layers/sequence.py`: `sequence_mask` only; the other
sequence layers are not ported)."""
from ..layer_helper import LayerHelper

__all__ = ["sequence_mask"]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    if maxlen is None or maxlen <= 0:
        raise ValueError("sequence_mask requires a static maxlen")
    out = helper.create_variable_for_type_inference(
        dtype, (x.shape[0], maxlen), True)
    helper.append_op("sequence_mask", {"X": [x]}, {"Y": [out]},
                     {"maxlen": maxlen, "out_dtype": dtype})
    return out
