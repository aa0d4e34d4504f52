"""Fused LayerNorm, forward and backward (counterpart of
`paddle_tpu/ops/pallas/layer_norm.py`: `_fwd_kernel` :67 launched by
`_fwd` :151, `_bwd_kernel` :78 launched by `_bwd_vjp` :176, wrapped by
the custom VJP `layer_norm` :131 and the dispatch policy
`try_layer_norm` :209).

`layer_norm(x, scale, bias, eps)` normalizes over the last axis and
returns (y, mean, var), mean and var f32 of shape x.shape[:-1]. It is a
`torch.autograd.Function`, differentiable in x, scale and bias (mean
and var carry no gradient). For CUDA tensors its forward runs the
hand-written kernel of `csrc/layer_norm.cu` (counted in
`LAUNCHES["layer_norm"]`) and its backward `layer_norm_bwd`, the
backward kernel of the same source (counted in
`LAUNCHES["layer_norm_bwd"]`, one count for its two stages); for CPU
tensors each takes its plain PyTorch version; for a tensor on any other
device, an input the kernels do not take, or a launch that fails, it
raises. The forward kernel takes fp32 or bf16 x of any rank >= 2 with
any row count, fp32 scale and bias, and C up to `MAX_C`; the backward
kernel takes fp32 dy and x (bf16 waits for the AMP slice).

The backward is the TPU kernel's: the row's mean and rstd are
recomputed from x, x^ = (x - mean) * rstd, dx^ = dy * scale, and dx =
rstd * (dx^ - mean(dx^) - x^ * mean(dx^ * x^)); dscale = sum over rows
of dy * x^ and dbias = sum of dy, in f32. On the TPU those two sums
accumulate across a sequential grid; here every block writes its
partial sums and a second stage adds them in a fixed order, so the
result is deterministic.

`try_layer_norm` is the op's static check (`supports`): the kernel runs
for a norm over exactly the last axis with both scale and bias, and the
op runs its composition otherwise, as in the reference. The TPU's gates
(Mosaic's 128-lane rule on C, at least 8 rows, the VMEM row budget) are
not inherited.
"""
import ctypes

import torch

from . import LAUNCHES, _build, launch, on_cpu

__all__ = ["layer_norm", "layer_norm_plain", "layer_norm_bwd",
           "layer_norm_bwd_plain", "try_layer_norm",
           "supports", "LAUNCHES", "MAX_C"]

MAX_C = 8192    # 8 warps x 32 lanes x 32 registers hold one row
# the backward's first stage runs at most this many blocks, each looping
# over rows; the kernel picks its block count up to this from the row
# count and C, and the scratch for its partial sums holds this many rows
MAX_PARTIAL_BLOCKS = 512


def layer_norm_plain(x, scale, bias, eps=1e-5):
    """Plain PyTorch version of the kernel, the op's composition over
    the last axis (`kernels_nn.py:243`): f32 mean, biased f32 variance,
    y = (x - mean) * rsqrt(var + eps) * scale + bias in f32, returned in
    x's dtype. -> (y, mean, var), mean and var of shape x.shape[:-1]."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.reshape(-1).float() + bias.reshape(-1).float()
    return y.to(x.dtype), mean.squeeze(-1), var.squeeze(-1)


def _check(x, scale, bias):
    if x.dim() < 2 or scale.numel() != x.shape[-1] \
            or bias.numel() != x.shape[-1] or x.numel() == 0:
        raise ValueError(f"layer_norm wants x [..., C] of rank >= 2 and "
                         f"scale, bias of C elements; got x "
                         f"{tuple(x.shape)}, scale {tuple(scale.shape)}, "
                         f"bias {tuple(bias.shape)}")


def _rows(x, scale, bias, what):
    """The kernels' input rules: contiguous, fp32 scale and bias, C up
    to MAX_C, fewer than 2**31 rows. Returns (rows, C)."""
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes fp32 scale and bias, got "
                        f"{scale.dtype} and {bias.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError(f"{what} kernel takes contiguous inputs")
    C = x.shape[-1]
    rows = x.numel() // C
    if C > MAX_C or rows >= 2 ** 31:
        raise ValueError(f"{what} kernel takes C <= {MAX_C} and fewer "
                         f"than 2**31 rows; got C={C}, {rows} rows")
    return rows, C


def _fwd(x, scale, bias, eps):
    """The forward without autograd: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    _check(x, scale, bias)
    if on_cpu((("x", x), ("scale", scale), ("bias", bias)), "layer_norm"):
        return layer_norm_plain(x, scale, bias, eps)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm kernel takes fp32 or bf16 x, got "
                        f"{x.dtype}")
    rows, C = _rows(x, scale, bias, "layer_norm")
    p = ctypes.c_void_p
    fn = _build.function("layer_norm", "ptt_layer_norm_fwd",
                         [p] * 6 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, ctypes.c_int, p])
    y = torch.empty_like(x)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    launch("layer_norm", fn, x.device, x.data_ptr(), scale.data_ptr(),
           bias.data_ptr(), y.data_ptr(), mean.data_ptr(), var.data_ptr(),
           rows, C, float(eps), int(x.dtype == torch.bfloat16))
    return y, mean, var


def layer_norm_bwd_plain(dy, x, scale, eps=1e-5):
    """Plain PyTorch version of the backward kernel (`_bwd_kernel`):
    stats recomputed from x in f32, dx = rstd * (dx^ - mean(dx^) - x^ *
    mean(dx^ * x^)) in x's dtype, dscale = sum of dy * x^ and dbias =
    sum of dy over all rows, [C] f32."""
    xf, dyf = x.float(), dy.float()
    C = x.shape[-1]
    mean = xf.mean(dim=-1, keepdim=True)
    d = xf - mean
    rstd = torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + eps)
    xhat = d * rstd
    dxhat = dyf * scale.reshape(-1).float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return (dx.to(x.dtype), (dyf * xhat).reshape(-1, C).sum(0),
            dyf.reshape(-1, C).sum(0))


def layer_norm_bwd(dy, x, scale, eps=1e-5):
    """(dx in x's dtype, dscale [C] f32, dbias [C] f32) of LayerNorm
    over the last axis: CPU tensors go to `layer_norm_bwd_plain`, CUDA
    tensors to the two-stage backward kernel."""
    _check(x, scale, scale)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"layer_norm_bwd wants dy of x's shape "
                         f"{tuple(x.shape)}; got {tuple(dy.shape)}")
    if on_cpu((("dy", dy), ("x", x), ("scale", scale)), "layer_norm_bwd"):
        return layer_norm_bwd_plain(dy, x, scale, eps)
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError(f"layer_norm_bwd kernel takes fp32 dy and x, got "
                        f"{dy.dtype} and {x.dtype} (bf16 waits for the AMP "
                        f"slice)")
    dy = dy.contiguous()
    rows, C = _rows(x, scale, scale, "layer_norm_bwd")
    dev = x.device
    dx = torch.empty_like(x)
    part = torch.empty((2, MAX_PARTIAL_BLOCKS, C), dtype=torch.float32,
                       device=dev)
    dscale = torch.empty(C, dtype=torch.float32, device=dev)
    dbias = torch.empty_like(dscale)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("layer_norm", "ptt_layer_norm_bwd",
                         [p] * 7 + [i, i, ctypes.c_float, i, p])
    launch("layer_norm_bwd", fn, dev, dy.data_ptr(), x.data_ptr(),
           scale.data_ptr(), dx.data_ptr(), part.data_ptr(),
           dscale.data_ptr(), dbias.data_ptr(), rows, C, float(eps),
           MAX_PARTIAL_BLOCKS)
    return dx, dscale, dbias


class _LayerNorm(torch.autograd.Function):
    """Forward: `_fwd`. Backward: `layer_norm_bwd` (the kernel, or its
    plain version for CPU tensors); mean and var have no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, var = _fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(dy, x, scale, ctx.eps)
        return (dx, dscale.reshape(scale.shape).to(scale.dtype),
                dbias.reshape(scale.shape).to(scale.dtype), None)


def layer_norm(x, scale, bias, eps=1e-5):
    """x [..., C] (rank >= 2), scale and bias [C] -> (y [..., C] in x's
    dtype, mean [...] f32, var [...] f32), differentiable in x, scale
    and bias. CPU tensors go to `layer_norm_plain` (and
    `layer_norm_bwd_plain`); CUDA tensors to the CUDA kernels."""
    return _LayerNorm.apply(x, scale, bias, eps)


def supports(x, scale, bias, begin_norm_axis):
    """The op's static check: a norm over exactly the last axis of a
    rank >= 2 input, with both scale and bias."""
    return (scale is not None and bias is not None and x.dim() >= 2
            and begin_norm_axis == x.dim() - 1)


def try_layer_norm(x, scale, bias, eps, begin_norm_axis):
    """The op's entry: (y, mean, var) from `layer_norm`, with mean and
    var squeezed as the op's composition squeezes them (every dim of 1
    goes, a batch or time dim of 1 too), or None where `supports`
    rejects the inputs."""
    if not supports(x, scale, bias, begin_norm_axis):
        return None
    y, mean, var = layer_norm(x.contiguous(), scale.reshape(-1),
                              bias.reshape(-1), eps)
    return y, mean.squeeze(), var.squeeze()
