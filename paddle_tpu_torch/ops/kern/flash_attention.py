"""Flash-attention forward with the per-row logsumexp (counterpart of
`paddle_tpu/ops/pallas/flash_attention.py`: `_fwd_kernel` :234 launched
by `_fwd_call` :284, wrapped by `flash_attention_with_lse` :572,
`supports` :596, `flash_attention` :638, `flash_attention_reference`
:657 and the dispatch policy `try_flash` :675).

`flash_attention(q, k, v, bias, causal, scale, causal_offset, layout)`
returns (out, lse): out in q's layout with v's head width, lse
[B, H, T] f32. layout "bhtd" is [B, H, T, D]; "bthd" is [B, T, H, D],
what the `flash_attention` op gets from `multi_head_attention`. It runs
the hand-written CUDA kernel `csrc/flash_attention.cu` for CUDA tensors,
which reads either layout through strides (no transpose copy), and the
plain PyTorch version for CPU tensors; for a tensor on any other device,
an input the kernel does not take, or a launch that fails, it raises.
The kernel takes fp32 q, k, v with the last dim contiguous, any T and S
(T may differ from S), D and DV up to `MAX_D`, and an optional per-key
bias [B,S], [B,1,1,S], [1,S] or [1,1,1,S] shared by all heads. bf16
inputs raise until the AMP slice. Each launch counts in
`LAUNCHES["flash_attention"]`.

Semantics are the TPU kernel's: the scale multiplies q.k before the
bias is added; with `causal`, keys past the bottom-right diagonal
(offset S - T + causal_offset) score -1e30 and whole key tiles past it
are skipped; l is clamped at 1e-20. A row whose every key is masked
(possible only with a negative causal_offset) is implementation-defined
in both the kernel and the plain version, as in the reference.

`try_flash` is the op's static check (`supports`): a full [B,H,T,S]
bias, or inputs that are not 4-D, return None and the op runs its
`scaled_dot_product_attention` composition, as in the reference. The
TPU's gates (`MIN_SEQ_LEN`, the block tiling) are not inherited. The
backward kernels (`_dq_kernel` :331, `_dkv_kernel` :366) and the bf16
exp (`softmax_dtype`) come with the training slice.
"""
import ctypes

import torch

from . import LAUNCHES, _build, launch

__all__ = ["flash_attention", "flash_attention_plain", "try_flash",
           "supports", "LAUNCHES", "MAX_D"]

MAX_D = 128         # the kernel's lanes own at most 4 x 32 output columns
NEG_INF = -1e30     # _NEG_INF of the TPU kernel


def _dims(q, k, v, layout):
    """(B, H, T, D, S, DV) of q, k, v in `layout`; raises on a mismatch."""
    if layout not in ("bhtd", "bthd"):
        raise ValueError(f"flash_attention layout must be 'bhtd' or "
                         f"'bthd', got {layout!r}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants 4-D q, k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if layout == "bhtd":
        (B, H, T, D), (_, _, S, _), DV = q.shape, k.shape, v.shape[-1]
        ok = (tuple(k.shape) == (B, H, S, D)
              and tuple(v.shape[:3]) == (B, H, S))
    else:
        (B, T, H, D), (_, S, _, _), DV = q.shape, k.shape, v.shape[-1]
        ok = (tuple(k.shape) == (B, S, H, D)
              and tuple(v.shape[:3]) == (B, S, H))
    if not ok or min(B, H, T, D, S, DV) < 1:
        raise ValueError(f"flash_attention ({layout}) shape mismatch: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    return B, H, T, D, S, DV


def _bias_ok(bias, B, S):
    return bias is None or tuple(bias.shape) in (
        (B, S), (B, 1, 1, S), (1, S), (1, 1, 1, S))


def _bht_strides(x, layout):
    """Element strides of x's batch, head and time dims."""
    if layout == "bhtd":
        return x.stride(0), x.stride(1), x.stride(2)
    return x.stride(0), x.stride(2), x.stride(1)


def _heads_second(x, layout):
    return x.transpose(1, 2) if layout == "bthd" else x


def flash_attention_plain(q, k, v, bias=None, causal=False, scale=None,
                          causal_offset=0, layout="bhtd"):
    """Plain PyTorch version of the kernel, the counterpart of
    `flash_attention_reference` with the lse: f32 scores times scale,
    plus the bias, the causal part at -1e30, softmax, weighted sum.
    -> (out in q's layout, lse [B, H, T] f32)."""
    B, H, T, D, S, DV = _dims(q, k, v, layout)
    scale = float(scale) if scale is not None else D ** -0.5
    qh, kh, vh = (_heads_second(t, layout) for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh).float() * scale
    if bias is not None:
        s = s + bias.reshape(bias.shape[0], 1, 1, S).float()
    if causal:
        keep = torch.ones((T, S), dtype=torch.bool, device=q.device).tril(
            diagonal=S - T + causal_offset)
        s = s.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                       vh.float()).to(q.dtype)
    return _heads_second(out, layout), lse


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    causal_offset=0, layout="bhtd"):
    """q, k, v in `layout` -> (out in q's layout [.., DV], lse [B,H,T]
    f32). CPU tensors go to `flash_attention_plain`; CUDA tensors to the
    CUDA kernel."""
    B, H, T, D, S, DV = _dims(q, k, v, layout)
    if not _bias_ok(bias, B, S):
        raise ValueError(f"flash_attention takes a per-key bias [B,S], "
                         f"[B,1,1,S], [1,S] or [1,1,1,S]; got "
                         f"{tuple(bias.shape)}")
    tensors = [("q", q), ("k", k), ("v", v)] \
        + ([("bias", bias)] if bias is not None else [])
    devs = {t.device for _n, t in tensors}
    if all(d.type == "cpu" for d in devs):
        return flash_attention_plain(q, k, v, bias, causal, scale,
                                     causal_offset, layout)
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError("flash_attention takes all-CPU or all-CUDA "
                         "tensors; got " + ", ".join(
                             f"{n} on {t.device}" for n, t in tensors))
    for n, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention kernel takes fp32 {n}, got "
                            f"{t.dtype} (bf16 waits for the AMP slice)")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel takes {n} with a "
                             f"contiguous last dim")
    if D > MAX_D or DV > MAX_D or B * H >= 2 ** 31:
        raise ValueError(f"flash_attention kernel takes D, DV <= {MAX_D} "
                         f"and B*H < 2**31; got D={D} DV={DV} B*H={B * H}")
    scale = float(scale) if scale is not None else D ** -0.5
    if bias is not None:
        bias = bias.reshape(bias.shape[0], S).float().contiguous()
    dev = q.device
    shape = (B, H, T, DV) if layout == "bhtd" else (B, T, H, DV)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 13)(
        *(s for x in (q, k, v, out) for s in _bht_strides(x, layout)),
        0 if bias is None or bias.shape[0] == 1 else S)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("flash_attention", "ptt_flash_attention_fwd",
                         [p] * 7 + [i] * 8 + [ctypes.c_float, p])
    launch("flash_attention", fn, dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), None if bias is None else bias.data_ptr(),
           out.data_ptr(), lse.data_ptr(), strides, B, H, T, S, D, DV,
           int(bool(causal)), S - T + int(causal_offset), scale)
    return out, lse


def supports(q, k, v, bias=None, layout="bhtd"):
    """The op's static check: 4-D q, k, v and no bias or a per-key one
    ([B,S], [B,1,1,S], [1,S] or [1,1,1,S])."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return False
    S = k.shape[2] if layout == "bhtd" else k.shape[1]
    return _bias_ok(bias, q.shape[0], S)


def try_flash(q, k, v, bias=None, causal=False, scale=None,
              layout="bhtd"):
    """The op's entry: `out` from `flash_attention` (the op has no use
    for the lse), or None where `supports` rejects the inputs."""
    if not supports(q, k, v, bias, layout):
        return None
    return flash_attention(q, k, v, bias, causal, scale, 0, layout)[0]
