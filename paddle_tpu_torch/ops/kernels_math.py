"""Math op kernels (counterpart of `paddle_tpu/ops/kernels_math.py`:
`elementwise_add`, `_sub`, `_mul`, `_div` and `_max` (:37-41) with
Fluid's `axis` broadcasting, `scale`, `relu`, `sigmoid` (:76), `mul`,
`reduce_sum` (:232), `mean` (:241) and `arg_max`; every other math op
is not ported).

Each is differentiable under `torch.autograd`, which the training
step's forward replay runs them under (core/trace.py); where
`elementwise_max` ties, both packages split the gradient in halves.

`mul` stays `torch.matmul`: in the reference it is a plain large matrix
product outside any Pallas kernel (`kernels_math.py:170`), which XLA
compiles; here cuBLAS runs it, in full fp32 (TF32 is off). `arg_max`
returns int64, the dtype its variable declares; the reference returns
int32 (its x32 mode).
"""
import numpy as np
import torch

from .registry import kernel


def _x(ins, slot="X"):
    return ins[slot][0]


def _bcast(x, y, axis):
    """Fluid elementwise broadcasting: y's shape aligns to x at `axis`."""
    if axis is None or axis == -1 or x.dim() == y.dim():
        return x, y
    shape = [1] * x.dim()
    for i, s in enumerate(y.shape):
        shape[axis + i] = s
    return x, y.reshape(shape)


def _elementwise(fn):
    def k(ctx, ins, attrs):
        x, y = _bcast(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        return {"Out": [fn(x, y)]}
    return k


kernel("elementwise_add")(_elementwise(torch.add))
kernel("elementwise_sub")(_elementwise(torch.sub))
kernel("elementwise_mul")(_elementwise(torch.mul))
kernel("elementwise_div")(_elementwise(torch.div))
kernel("elementwise_max")(_elementwise(torch.maximum))


@kernel("scale")
def _scale(ctx, ins, attrs):
    x = _x(ins)
    s = torch.tensor(attrs.get("scale", 1.0), dtype=x.dtype,
                     device=x.device)
    b = torch.tensor(attrs.get("bias", 0.0), dtype=x.dtype,
                     device=x.device)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


@kernel("relu")
def _relu(ctx, ins, attrs):
    return {"Out": [torch.relu(_x(ins))]}


@kernel("sigmoid")
def _sigmoid(ctx, ins, attrs):
    return {"Out": [torch.sigmoid(_x(ins))]}


@kernel("mul")
def _mul(ctx, ins, attrs):
    """Flatten x to 2-D at x_num_col_dims and y at y_num_col_dims, then
    one matmul."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xn])), int(np.prod(xs[xn:])))
    y2 = y.reshape(int(np.prod(ys[:yn])), int(np.prod(ys[yn:])))
    return {"Out": [torch.matmul(x2, y2).reshape(xs[:xn] + ys[yn:])]}


@kernel("reduce_sum")
def _reduce_sum(ctx, ins, attrs):
    x = _x(ins)
    dims = attrs.get("dim")
    keep = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False) or dims is None:
        out = x.sum()
        return {"Out": [out.reshape((1,) * x.dim()) if keep else out]}
    axes = tuple(d if d >= 0 else d + x.dim() for d in dims)
    return {"Out": [x.sum(dim=axes, keepdim=keep)]}


@kernel("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [_x(ins).mean()]}


@kernel("arg_max")
def _arg_max(ctx, ins, attrs):
    axis = attrs.get("axis", -1)
    out = torch.argmax(_x(ins), dim=axis)
    if attrs.get("keepdims", False):
        out = out.unsqueeze(axis)
    return {"Out": [out]}
