"""Input declaration (counterpart of `paddle_tpu/layers/io.py`: `data`
only; the readers, `py_reader` and `double_buffer` are not ported)."""
from ..core.dtypes import convert_dtype
from ..core.framework import default_main_program

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare an input variable; append_batch_size prepends a -1 batch
    dim, as in the reference."""
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    block = default_main_program().global_block()
    return block.create_var(
        name=name, shape=tuple(shape), dtype=convert_dtype(dtype),
        is_data=True, stop_gradient=stop_gradient, lod_level=lod_level)
