"""Dtype strings of the Program and their torch dtypes (counterpart of
`paddle_tpu/core/dtypes.py`: `convert_dtype`; `is_float`, `is_integer`
and `dtype_size` are not ported).

The Program speaks in dtype strings ("float32", "int64", ...), as in
the reference; `to_torch_dtype` is the one mapping from them to torch
dtypes. Unlike the reference's x32 mode, 64-bit dtypes stay 64-bit.
`tensor_from_numpy` moves a numpy array onto a device keeping its
dtype, including `ml_dtypes.bfloat16` arrays, which numpy knows only as
an extension type (the port does not import ml_dtypes);
`tensor_to_numpy` brings a tensor back, a bf16 one as float32.
"""
import numpy as np
import torch

__all__ = ["convert_dtype", "to_torch_dtype", "tensor_from_numpy",
           "tensor_to_numpy"]

_TORCH = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH.items()}


def convert_dtype(dtype):
    """Normalize a dtype spec (string, numpy dtype, torch dtype) to its
    canonical string; None means "float32"."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        if dtype not in _TORCH:
            raise TypeError(f"unsupported dtype string: {dtype}")
        return dtype
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise TypeError(f"unsupported dtype: {dtype}")
        return _NAMES[dtype]
    dt = np.dtype(dtype) if not hasattr(dtype, "name") else dtype
    name = getattr(dt, "name", str(dt))
    if name == "bool_":
        name = "bool"
    if name not in _TORCH:
        raise TypeError(f"unsupported dtype: {dtype}")
    return name


def to_torch_dtype(dtype):
    return _TORCH[convert_dtype(dtype)]


def tensor_from_numpy(a, device, dtype=None):
    """numpy array (or a torch tensor, passed through) -> torch tensor on
    `device`, in `dtype` (a Program dtype string) or else the array's
    own dtype. The array is copied, so the tensor never shares memory
    with it; a bfloat16 array crosses as its 16 raw bits."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.array(a)     # a copy: the tensor never aliases the caller's
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(to_torch_dtype(dtype))
    return t.to(device)


def tensor_to_numpy(t):
    """A tensor -> a numpy array on the host in its dtype; bf16 becomes
    float32 (numpy has no bfloat16 of its own)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
