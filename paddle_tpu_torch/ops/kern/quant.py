"""Blockwise absmax int8 quantize (counterpart of
`paddle_tpu/ops/kern/quant.py`: `quantize_int8_blockwise_reference` at
:47, `dequantize_int8_blockwise` at :59 and the fused kernel
`quantize_int8_pallas` at :89).

The scheme is the reference's wire format: per-block fp32 scales
absmax / 127, codes clip(round(x / safe), -127, 127) as int8, where
`safe` is the scale, or 1 for an all-zero block. The scale returned is
the raw one, so an all-zero block stores scale 0 (and codes 0).
`quantize_int8_blockwise` runs the hand-written CUDA kernel
`csrc/quant.cu` for CUDA tensors and the plain PyTorch version for CPU
tensors; for a tensor on any other device, or a launch that fails, it
raises. Codes and scales are bit-identical between the kernel, the
plain version and the reference: the arithmetic is elementwise, with
one exact max, IEEE divisions and round half to even. A NaN in a block
makes that block's scale NaN in all three (the max keeps it); its codes
come from casting NaN to int8, which is implementation-defined in the
reference too. Each launch counts in
`LAUNCHES["quantize_int8_blockwise"]`.

Dequantize stays a plain one-liner, as in the reference: on the decode
path it is fused into the attention kernel (`dequant_attend`).
"""
import ctypes

import torch

from . import LAUNCHES, _build, launch

__all__ = ["quantize_int8_blockwise", "quantize_int8_blockwise_plain",
           "dequantize_int8_blockwise", "LAUNCHES", "MAX_BLOCK"]

MAX_BLOCK = 1024    # the kernel's lanes hold at most 32 x 32 elements


def quantize_int8_blockwise_plain(flat, block_size=256):
    """Plain PyTorch version of the kernel, the reference composition:
    flat f32 [n] -> (codes int8 [n/bs, bs], scales f32 [n/bs, 1]).
    torch.round rounds half to even, as jnp.round does. The scale
    divides by a tensor of 127s: on CUDA, PyTorch divides a tensor by a
    Python scalar by multiplying with its reciprocal, which is 1 ulp off
    the reference's quotient in some blocks."""
    blocks = flat.reshape(-1, block_size)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scales = absmax / torch.full_like(absmax, 127.0)
    safe = torch.where(scales == 0, torch.ones_like(scales), scales)
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scales


def dequantize_int8_blockwise(q, scales):
    """codes [nb, bs] + scales [nb, 1] -> flat f32 [nb*bs]."""
    return (q.float() * scales).reshape(-1)


def quantize_int8_blockwise(flat, block_size=256):
    """flat f32 [n] with n a positive multiple of `block_size` ->
    (codes int8 [n/bs, bs], scales f32 [n/bs, 1]). A CPU tensor goes to
    `quantize_int8_blockwise_plain`; a CUDA tensor (fp32, contiguous,
    block_size <= MAX_BLOCK) to the CUDA kernel."""
    bs = int(block_size)
    if flat.dim() != 1 or bs < 1 or flat.numel() == 0 \
            or flat.numel() % bs:
        raise ValueError(f"quantize_int8_blockwise wants a flat [n] input "
                         f"with n a positive multiple of block_size={bs}; "
                         f"got {tuple(flat.shape)}")
    if flat.device.type == "cpu":
        return quantize_int8_blockwise_plain(flat, bs)
    if flat.device.type != "cuda":
        raise ValueError(f"quantize_int8_blockwise takes a CPU or CUDA "
                         f"tensor; got one on {flat.device}")
    if flat.dtype != torch.float32:
        raise TypeError(f"quantize_int8_blockwise kernel takes fp32, got "
                        f"{flat.dtype}")
    if not flat.is_contiguous():
        raise ValueError("quantize_int8_blockwise kernel takes a "
                         "contiguous input")
    nb = flat.numel() // bs
    if bs > MAX_BLOCK or nb >= 2 ** 31:
        raise ValueError(f"quantize_int8_blockwise kernel takes "
                         f"block_size <= {MAX_BLOCK} and fewer than 2**31 "
                         f"blocks; got block_size={bs}, {nb} blocks")
    p = ctypes.c_void_p
    fn = _build.function("quant", "ptt_quantize_int8",
                         [p, p, p, ctypes.c_int, ctypes.c_int, p])
    codes = torch.empty((nb, bs), dtype=torch.int8, device=flat.device)
    scales = torch.empty((nb, 1), dtype=torch.float32, device=flat.device)
    launch("quantize_int8_blockwise", fn, flat.device, flat.data_ptr(),
           codes.data_ptr(), scales.data_ptr(), nb, bs)
    return codes, scales
