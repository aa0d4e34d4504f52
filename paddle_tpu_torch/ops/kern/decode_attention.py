"""Single-token ragged decode attention over the slot-pool cache
(counterpart of `paddle_tpu/ops/kern/decode_attention.py`:
`decode_attend` at :169 and `decode_attend_reference` at :226 for the
fp32 cache; `dequant_attend` at :194 and `dequant_attend_reference` at
:243 for the int8 cache).

The serving decoder keeps its KV cache as ``[slots, T_max, heads, Dh]``
and every slot is a request at its own position, so slot s attends to
t <= pos[s] of a fixed T_max buffer. The int8 cache holds codes of that
shape and fp32 scales ``[slots, T_max, heads, Dh/qblock]``, one per
block of qblock head elements. `decode_attend` and `dequant_attend` run
the hand-written CUDA kernels of `csrc/decode_attention.cu` for CUDA
tensors and their plain PyTorch versions for CPU tensors; for a tensor
on any other device, or a CUDA launch that fails, they raise.
`dequant_attend` never materialises a dequantized fp32 cache on the
card: its kernel reads the codes and scales and dequantizes in
registers. Each wrapper counts its kernel launches in `LAUNCHES`.

Unlike the TPU kernels, the port has no pool-depth gate (the TPU's
``MIN_T_DECODE`` / ``MIN_T_DEQUANT``): on the card the kernels run on
every decode step.
"""
import ctypes

import torch

from ..kernels_nn import _attn_softmax
from . import LAUNCHES, _build, launch, on_cpu

__all__ = ["decode_attend", "decode_attend_plain", "dequant_attend",
           "dequant_attend_plain", "LAUNCHES", "MAX_DH"]

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


def dequant_attend_plain(q, kq, ks, vq, vs, pos, scale=None):
    """Plain PyTorch version of the int8 kernel: the decoder's int8
    composition (`dequant_attend_reference`): dequantize both caches to
    fp32, code * scale broadcast over each block of qblock = Dh //
    ks.shape[-1] elements, then `decode_attend_plain` (so pos[s] < 0
    gives an all-zero row). q [S,H,Dh] f32, kq/vq [S,T,H,Dh] int8,
    ks/vs [S,T,H,Dh/qblock] f32, pos [S] int -> [S,H,Dh] f32."""
    S, T, H, Dh = kq.shape
    nb = ks.shape[-1]
    k = (kq.float().reshape(S, T, H, nb, Dh // nb)
         * ks[..., None]).reshape(S, T, H, Dh)
    v = (vq.float().reshape(S, T, H, nb, Dh // nb)
         * vs[..., None]).reshape(S, T, H, Dh)
    return decode_attend_plain(q, k, v, pos, scale)


def _check(name, q, pos, caches, scales=()):
    """Shapes: q [S,H,Dh], each cache [S,T,H,Dh] alike, each scale
    [S,T,H,nb] alike with nb dividing Dh, pos [S]."""
    shapes = ", ".join(f"{n} {tuple(t.shape)}" for n, t in
                       (("q", q), *caches, *scales, ("pos", pos)))
    if q.dim() != 3 or pos.dim() != 1 \
            or any(t.dim() != 4 for _n, t in [*caches, *scales]):
        raise ValueError(f"{name} wants q [S,H,Dh], caches [S,T,H,Dh]"
                         f"{', scales [S,T,H,Dh/qblock]' if scales else ''}"
                         f", pos [S]; got {shapes}")
    S, H, Dh = q.shape
    c0 = tuple(caches[0][1].shape)
    ok = (c0[0] == S and c0[2] == H and c0[3] == Dh
          and tuple(pos.shape) == (S,)
          and all(tuple(t.shape) == c0 for _n, t in caches))
    if scales:
        s0 = tuple(scales[0][1].shape)
        ok = ok and s0[:3] == c0[:3] and s0[3] >= 1 and Dh % s0[3] == 0 \
            and all(tuple(t.shape) == s0 for _n, t in scales)
    if not ok:
        raise ValueError(f"{name} shape mismatch: {shapes}")


def _check_kernel_inputs(name, tensors, dtypes):
    for (n, t), dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{name} kernel takes {dt} {n}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes a contiguous {n}")
    q, cache = tensors[0][1], tensors[1][1]
    S, H, Dh = q.shape
    T = cache.shape[1]
    if min(S, H, Dh, T) < 1 or Dh > MAX_DH:
        raise ValueError(f"{name} kernel takes S, H, T >= 1 and "
                         f"1 <= Dh <= {MAX_DH}; got S={S} H={H} T={T} "
                         f"Dh={Dh}")
    if S * H >= 2 ** 31:
        raise ValueError(f"{name} kernel: S*H={S * H} blocks exceed the "
                         f"grid")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def decode_attend(q, k, v, pos, scale=None):
    """q [S,H,Dh], k/v [S,T,H,Dh], pos [S] (attend to t <= pos[s]) ->
    [S,H,Dh]. CPU tensors go to `decode_attend_plain`; CUDA tensors
    (fp32, int32 pos, contiguous) to the CUDA kernel."""
    args = (("q", q), ("k", k), ("v", v), ("pos", pos))
    _check("decode_attend", q, pos, [("k", k), ("v", v)])
    if on_cpu(args, "decode_attend"):
        return decode_attend_plain(q, k, v, pos, scale)
    f32 = torch.float32
    _check_kernel_inputs("decode_attend", args,
                         (f32, f32, f32, torch.int32))
    S, H, Dh = q.shape
    T = k.shape[1]
    scale = float(scale) if scale is not None else Dh ** -0.5
    fn = _build.function("decode_attention", "ptt_decode_attend_f32",
                         [_P] * 5 + [_I] * 4 + [_F, _P])
    out = torch.empty_like(q)
    launch("decode_attend", fn, q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), pos.data_ptr(), out.data_ptr(), S, T, H, Dh, scale)
    return out


def dequant_attend(q, kq, ks, vq, vs, pos, scale=None):
    """q [S,H,Dh] f32; kq/vq [S,T,H,Dh] int8 codes; ks/vs
    [S,T,H,Dh/qblock] f32 per-block scales; pos [S] (attend to t <=
    pos[s]) -> [S,H,Dh] f32. qblock = Dh // ks.shape[-1]. CPU tensors go
    to `dequant_attend_plain`; CUDA tensors (contiguous, int32 pos) to
    the CUDA kernel, which dequantizes in registers."""
    args = (("q", q), ("kq", kq), ("ks", ks), ("vq", vq), ("vs", vs),
            ("pos", pos))
    _check("dequant_attend", q, pos, [("kq", kq), ("vq", vq)],
           [("ks", ks), ("vs", vs)])
    if on_cpu(args, "dequant_attend"):
        return dequant_attend_plain(q, kq, ks, vq, vs, pos, scale)
    f32, i8 = torch.float32, torch.int8
    _check_kernel_inputs("dequant_attend", args,
                         (f32, i8, f32, i8, f32, torch.int32))
    S, H, Dh = q.shape
    T = kq.shape[1]
    scale = float(scale) if scale is not None else Dh ** -0.5
    fn = _build.function("decode_attention", "ptt_dequant_attend_int8",
                         [_P] * 7 + [_I] * 5 + [_F, _P])
    out = torch.empty_like(q)
    launch("dequant_attend", fn, q.device, q.data_ptr(), kq.data_ptr(),
           ks.data_ptr(), vq.data_ptr(), vs.data_ptr(), pos.data_ptr(),
           out.data_ptr(), S, T, H, Dh, ks.shape[-1], scale)
    return out
