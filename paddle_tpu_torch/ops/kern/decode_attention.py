"""Single-token ragged decode attention over the slot-pool cache
(counterpart of `paddle_tpu/ops/kern/decode_attention.py`: `decode_attend`
at :169 and `decode_attend_reference` at :226).

The serving decoder keeps its KV cache as ``[slots, T_max, heads, Dh]``
and every slot is a request at its own position, so slot s attends to
t <= pos[s] of a fixed T_max buffer. `decode_attend` runs the hand-written
CUDA kernel `csrc/decode_attention.cu` for CUDA tensors and the plain
PyTorch version `decode_attend_plain` for CPU tensors; for a tensor on
any other device, or a CUDA launch that fails, it raises. `LAUNCHES`
counts kernel launches.

Unlike the TPU kernel, the port has no pool-depth gate (the TPU's
``MIN_T_DECODE``): on the card the kernel runs on every decode step.
"""
import ctypes

import torch

from ..kernels_nn import _attn_softmax
from . import _build

__all__ = ["decode_attend", "decode_attend_plain", "LAUNCHES", "MAX_DH"]

LAUNCHES = 0    # kernel launches; the plain version never counts

MAX_DH = 256    # the kernel's lanes stride over at most 8 x 32 elements


def decode_attend_plain(q, k, v, pos, scale=None):
    """Plain PyTorch version of the kernel: the decoder's composition
    (`decode_attend_reference`: f32 logits, -inf mask on t > pos[s],
    `_attn_softmax`, weighted sum), except that pos[s] < 0 gives an
    all-zero row, as the kernel does, where the composition gives NaN.
    q [S,H,Dh], k/v [S,T,H,Dh], pos [S] int -> [S,H,Dh]."""
    Dh = q.shape[-1]
    T = k.shape[1]
    scale = float(scale) if scale is not None else Dh ** -0.5
    logits = torch.einsum("shd,sthd->sht", q, k).float() * scale
    keep = (torch.arange(T, device=k.device)[None, None, :]
            <= pos.to(k.device).long()[:, None, None])
    logits = logits.masked_fill(~keep, float("-inf"))
    w = _attn_softmax(logits).to(q.dtype)
    out = torch.einsum("sht,sthd->shd", w, v).to(q.dtype)
    live = (pos.to(q.device) >= 0)[:, None, None]
    return torch.where(live, out, torch.zeros_like(out))


def _check(q, k, v, pos):
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4 or pos.dim() != 1:
        raise ValueError(
            f"decode_attend wants q [S,H,Dh], k/v [S,T,H,Dh], pos [S]; "
            f"got q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, pos {tuple(pos.shape)}")
    S, H, Dh = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != S \
            or k.shape[2] != H or k.shape[3] != Dh \
            or tuple(pos.shape) != (S,):
        raise ValueError(
            f"decode_attend shape mismatch: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"pos {tuple(pos.shape)}")


def _check_kernel_inputs(q, k, v, pos):
    dev = q.device
    for name, t in (("k", k), ("v", v), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"decode_attend: {name} is on {t.device}, "
                             f"q on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"decode_attend kernel takes fp32 {name}, "
                            f"got {t.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"decode_attend kernel takes int32 pos, got "
                        f"{pos.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attend kernel takes a contiguous "
                             f"{name}")
    S, H, Dh = q.shape
    T = k.shape[1]
    if min(S, H, Dh, T) < 1 or Dh > MAX_DH:
        raise ValueError(f"decode_attend kernel takes S, H, T >= 1 and "
                         f"1 <= Dh <= {MAX_DH}; got S={S} H={H} T={T} "
                         f"Dh={Dh}")
    if S * H >= 2 ** 31:
        raise ValueError(f"decode_attend kernel: S*H={S * H} blocks "
                         f"exceed the grid")


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.ptt_decode_attend_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def decode_attend(q, k, v, pos, scale=None):
    """q [S,H,Dh], k/v [S,T,H,Dh], pos [S] (attend to t <= pos[s]) ->
    [S,H,Dh]. CPU tensors go to `decode_attend_plain`; CUDA tensors
    (fp32, int32 pos, contiguous) to the CUDA kernel."""
    global LAUNCHES
    _check(q, k, v, pos)
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu" and pos.device.type == "cpu":
        return decode_attend_plain(q, k, v, pos, scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"decode_attend takes all-CPU or all-CUDA tensors; got q on "
            f"{q.device}, k on {k.device}, v on {v.device}, pos on "
            f"{pos.device}")
    _check_kernel_inputs(q, k, v, pos)
    S, H, Dh = q.shape
    T = k.shape[1]
    scale = float(scale) if scale is not None else Dh ** -0.5
    fn = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                out.data_ptr(), S, T, H, Dh, scale, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attend kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return out
