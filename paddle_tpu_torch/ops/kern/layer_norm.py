"""Fused LayerNorm forward (counterpart of
`paddle_tpu/ops/pallas/layer_norm.py`: `_fwd_kernel` :67 launched by
`_fwd` :151, wrapped by `layer_norm` :131 and the dispatch policy
`try_layer_norm` :209).

`layer_norm(x, scale, bias, eps)` normalizes over the last axis and
returns (y, mean, var), mean and var f32 of shape x.shape[:-1]. It runs
the hand-written CUDA kernel `csrc/layer_norm.cu` for CUDA tensors and
its plain PyTorch version for CPU tensors; for a tensor on any other
device, an input the kernel does not take, or a launch that fails, it
raises. The kernel takes fp32 or bf16 x of any rank >= 2 with any row
count, fp32 scale and bias, and C up to `MAX_C`. Each launch counts in
`LAUNCHES["layer_norm"]`.

`try_layer_norm` is the op's static check (`supports`): the kernel runs
for a norm over exactly the last axis with both scale and bias, and the
op runs its composition otherwise, as in the reference. The TPU's gates
(Mosaic's 128-lane rule on C, at least 8 rows, the VMEM row budget) are
not inherited. Only the forward is ported; the backward kernel
(`_bwd_kernel` :78) comes with the training slice.
"""
import ctypes

import torch

from . import LAUNCHES, _build, launch

__all__ = ["layer_norm", "layer_norm_plain", "try_layer_norm", "supports",
           "LAUNCHES", "MAX_C"]

MAX_C = 8192    # 8 warps x 32 lanes x 32 registers hold one row


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


def layer_norm(x, scale, bias, eps=1e-5):
    """x [..., C] (rank >= 2), scale and bias [C] -> (y [..., C] in x's
    dtype, mean [...] f32, var [...] f32). CPU tensors go to
    `layer_norm_plain`; CUDA tensors to the CUDA kernel."""
    if x.dim() < 2 or scale.numel() != x.shape[-1] \
            or bias.numel() != x.shape[-1] or x.numel() == 0:
        raise ValueError(f"layer_norm wants x [..., C] of rank >= 2 and "
                         f"scale, bias of C elements; got x "
                         f"{tuple(x.shape)}, scale {tuple(scale.shape)}, "
                         f"bias {tuple(bias.shape)}")
    devs = {t.device for t in (x, scale, bias)}
    if all(d.type == "cpu" for d in devs):
        return layer_norm_plain(x, scale, bias, eps)
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"layer_norm takes all-CPU or all-CUDA tensors; "
                         f"got x on {x.device}, scale on {scale.device}, "
                         f"bias on {bias.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm kernel takes fp32 or bf16 x, got "
                        f"{x.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"layer_norm kernel takes fp32 scale and bias, got "
                        f"{scale.dtype} and {bias.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("layer_norm kernel takes contiguous inputs")
    C = x.shape[-1]
    rows = x.numel() // C
    if C > MAX_C or rows >= 2 ** 31:
        raise ValueError(f"layer_norm kernel takes C <= {MAX_C} and fewer "
                         f"than 2**31 rows; got C={C}, {rows} rows")
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
