"""Flash attention, forward with the per-row logsumexp and backward
(counterpart of `paddle_tpu/ops/pallas/flash_attention.py`:
`_fwd_kernel` :234 launched by `_fwd_call` :284; `_dq_kernel` :331 and
`_dkv_kernel` :366 launched by `_bwd_call` :418; the custom VJPs
`_flash_lse` / `_flash_lse_bwd` :537-567, `flash_attention_with_lse`
:572, `supports` :596, `flash_attention` :638,
`flash_attention_reference` :657 and the dispatch policy `try_flash`
:675).

`flash_attention(q, k, v, bias, causal, scale, causal_offset, layout)`
returns (out, lse): out in q's layout with v's head width, lse
[B, H, T] f32. layout "bhtd" is [B, H, T, D]; "bthd" is [B, T, H, D],
what the `flash_attention` op gets from `multi_head_attention`. It is a
`torch.autograd.Function`, differentiable in q, k, v, the bias and
through the lse too. For CUDA tensors the forward runs the hand-written
kernel of `csrc/flash_attention.cu` (counted in
`LAUNCHES["flash_attention"]`) and the backward its two backward
kernels, `flash_attention_dq` and `flash_attention_dkv` (counted in
`LAUNCHES["flash_attention_dq"]` and `["flash_attention_dkv"]`); for CPU
tensors each takes its plain PyTorch version beside it; for a tensor on
any other device, an input the kernels do not take, or a launch that
fails, it raises. The kernels read either layout through strides (no
transpose copy) and take fp32 q, k, v with the last dim contiguous, any
T and S (T may differ from S), D and DV up to `MAX_D`, and an optional
per-key bias [B,S], [B,1,1,S], [1,S] or [1,1,1,S] shared by all heads.
bf16 inputs raise until the AMP slice.

Semantics are the TPU kernel's: the scale multiplies q.k before the
bias is added; with `causal`, keys past the bottom-right diagonal
(offset S - T + causal_offset) score -1e30 and whole key tiles past it
are skipped; l is clamped at 1e-20. A row whose every key is masked
(possible only with a negative causal_offset) is implementation-defined
in both the kernels and the plain versions, as in the reference.

The backward, as `_bwd_call`: delta = rowsum(dO * O), less the lse's
cotangent where the lse is used, is a torch reduction in the wrapper (the
reference computes it outside its kernels too); then p = exp(s - lse) is
recomputed, ds = p * (dp - delta) with dp = dO . v, and dq = ds . k *
scale, dk = ds^T . q * scale, dv = p^T . dO. The bias gradient is taken
only where the bias requires grad: the dk/dv kernel writes one row per
(batch, head) [B*H, S], summed over the keys' q rows in a fixed order,
and the wrapper sums the rows over heads (and over the batch for a
[1, S] bias) into the bias's own shape.

`try_flash` is the op's static check (`supports`): a full [B,H,T,S]
bias, or inputs that are not 4-D, return None and the op runs its
`scaled_dot_product_attention` composition, as in the reference. The
TPU's gates (`MIN_SEQ_LEN`, the block tiling) are not inherited. The
bf16 exp (`softmax_dtype`) comes with the AMP slice.
"""
import ctypes

import torch

from . import LAUNCHES, _build, launch, on_cpu

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_dq",
           "flash_attention_dq_plain", "flash_attention_dkv",
           "flash_attention_dkv_plain", "try_flash", "supports",
           "LAUNCHES", "MAX_D"]

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


def _check_kernel_inputs(q, k, v, D, DV, B, H):
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


def _bias_rows(bias, S):
    """The bias as [Bb, S] fp32 and its batch stride (0 for Bb = 1)."""
    if bias is None:
        return None, 0
    bias = bias.reshape(bias.shape[0], S).float().contiguous()
    return bias, 0 if bias.shape[0] == 1 else S


def _fwd(q, k, v, bias, causal, scale, causal_offset, layout):
    """The forward without autograd: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    B, H, T, D, S, DV = _dims(q, k, v, layout)
    if not _bias_ok(bias, B, S):
        raise ValueError(f"flash_attention takes a per-key bias [B,S], "
                         f"[B,1,1,S], [1,S] or [1,1,1,S]; got "
                         f"{tuple(bias.shape)}")
    tensors = [("q", q), ("k", k), ("v", v)] \
        + ([("bias", bias)] if bias is not None else [])
    if on_cpu(tensors, "flash_attention"):
        return flash_attention_plain(q, k, v, bias, causal, scale,
                                     causal_offset, layout)
    _check_kernel_inputs(q, k, v, D, DV, B, H)
    scale = float(scale) if scale is not None else D ** -0.5
    bias, bias_sb = _bias_rows(bias, S)
    dev = q.device
    shape = (B, H, T, DV) if layout == "bhtd" else (B, T, H, DV)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 13)(
        *(s for x in (q, k, v, out) for s in _bht_strides(x, layout)),
        bias_sb)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("flash_attention", "ptt_flash_attention_fwd",
                         [p] * 7 + [i] * 8 + [ctypes.c_float, p])
    launch("flash_attention", fn, dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), None if bias is None else bias.data_ptr(),
           out.data_ptr(), lse.data_ptr(), strides, B, H, T, S, D, DV,
           int(bool(causal)), S - T + int(causal_offset), scale)
    return out, lse


def _probs(q, k, bias, lse, causal, scale, causal_offset, layout):
    """p = exp(s - lse) [B, H, T, S] f32 with s as the forward scores
    it; q, k in `layout`."""
    qh, kh = _heads_second(q, layout), _heads_second(k, layout)
    T, S = qh.shape[2], kh.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh).float() * scale
    if bias is not None:
        s = s + bias.reshape(bias.shape[0], 1, 1, S).float()
    if causal:
        keep = torch.ones((T, S), dtype=torch.bool, device=q.device).tril(
            diagonal=S - T + causal_offset)
        s = s.masked_fill(~keep, NEG_INF)
    return torch.exp(s - lse[..., None])


def flash_attention_dq_plain(q, k, v, bias, dout, lse, delta, causal=False,
                             scale=None, causal_offset=0, layout="bhtd"):
    """Plain PyTorch version of the dq kernel (`_dq_kernel`): dq =
    (p * (dO . v^T - delta)) . k * scale, in q's layout. lse and delta
    are [B, H, T] f32; dout is in q's layout with v's head width."""
    D = q.shape[-1]
    scale = float(scale) if scale is not None else D ** -0.5
    p = _probs(q, k, bias, lse, causal, scale, causal_offset, layout)
    doh, vh, kh = (_heads_second(t, layout).float() for t in (dout, v, k))
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", doh, vh) - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale
    return _heads_second(dq, layout).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, bias, dout, lse, delta, causal=False,
                              scale=None, causal_offset=0, layout="bhtd",
                              bias_grad=False):
    """Plain PyTorch version of the dk/dv kernel (`_dkv_kernel`): dv =
    p^T . dO, dk = ds^T . q * scale in k's and v's layout, and with
    `bias_grad` the per-head bias-gradient rows [B*H, S] f32 (ds summed
    over the q rows), else None."""
    B, H, T, D, S, DV = _dims(q, k, v, layout)
    scale = float(scale) if scale is not None else D ** -0.5
    p = _probs(q, k, bias, lse, causal, scale, causal_offset, layout)
    doh, vh, qh = (_heads_second(t, layout).float() for t in (dout, v, q))
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", doh, vh) - delta[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, doh)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale
    db = ds.sum(dim=2).reshape(B * H, S) if bias_grad else None
    return (_heads_second(dk, layout).to(k.dtype),
            _heads_second(dv, layout).to(v.dtype), db)


def _bwd_args(q, k, v, bias, dout, lse, delta, layout, name):
    """Shared checks of the two backward wrappers: shapes, devices
    (True for all-CPU) and, for CUDA, the kernels' input rules."""
    B, H, T, D, S, DV = _dims(q, k, v, layout)
    out_shape = (B, H, T, DV) if layout == "bhtd" else (B, T, H, DV)
    if tuple(dout.shape) != out_shape or tuple(lse.shape) != (B, H, T) \
            or tuple(delta.shape) != (B, H, T) or not _bias_ok(bias, B, S):
        raise ValueError(f"{name}: dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} and delta "
                         f"{tuple(delta.shape)} do not fit q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} ({layout})")
    tensors = [("q", q), ("k", k), ("v", v), ("dout", dout), ("lse", lse),
               ("delta", delta)] \
        + ([("bias", bias)] if bias is not None else [])
    cpu = on_cpu(tensors, name)
    if not cpu:
        _check_kernel_inputs(q, k, v, D, DV, B, H)
    return cpu, (B, H, T, D, S, DV)


def _bwd_common(q, k, v, bias, dout, lse, delta, layout):
    """(bias rows [Bb,S] or None, its batch stride, dout and the stats
    as the kernels read them, the strides of q, k, v and dout)."""
    bias, bias_sb = _bias_rows(bias, k.shape[2 if layout == "bhtd" else 1])
    dout = dout.float().contiguous()
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    strides = [s for x in (q, k, v, dout) for s in _bht_strides(x, layout)]
    return bias, bias_sb, dout, lse, delta, strides


def flash_attention_dq(q, k, v, bias, dout, lse, delta, causal=False,
                       scale=None, causal_offset=0, layout="bhtd"):
    """dq of flash attention, in q's layout: CPU tensors go to
    `flash_attention_dq_plain`, CUDA tensors to the dq kernel."""
    cpu, (B, H, T, D, S, DV) = _bwd_args(q, k, v, bias, dout, lse,
                                            delta, layout,
                                            "flash_attention_dq")
    if cpu:
        return flash_attention_dq_plain(q, k, v, bias, dout, lse, delta,
                                        causal, scale, causal_offset,
                                        layout)
    scale = float(scale) if scale is not None else D ** -0.5
    bias, bias_sb, dout, lse, delta, strides = _bwd_common(
        q, k, v, bias, dout, lse, delta, layout)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    st = (ctypes.c_longlong * 16)(*strides, *_bht_strides(dq, layout),
                                  bias_sb)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("flash_attention", "ptt_flash_attention_dq",
                         [p] * 9 + [i] * 8 + [ctypes.c_float, p])
    launch("flash_attention_dq", fn, q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), None if bias is None else bias.data_ptr(),
           dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
           st, B, H, T, S, D, DV, int(bool(causal)),
           S - T + int(causal_offset), scale)
    return dq


def flash_attention_dkv(q, k, v, bias, dout, lse, delta, causal=False,
                        scale=None, causal_offset=0, layout="bhtd",
                        bias_grad=False):
    """(dk, dv, per-head bias-gradient rows [B*H, S] f32 or None) of
    flash attention, the rows only with `bias_grad` and a bias: CPU
    tensors go to `flash_attention_dkv_plain`, CUDA tensors to the dk/dv
    kernel."""
    cpu, (B, H, T, D, S, DV) = _bwd_args(q, k, v, bias, dout, lse,
                                            delta, layout,
                                            "flash_attention_dkv")
    bias_grad = bias_grad and bias is not None
    if cpu:
        return flash_attention_dkv_plain(q, k, v, bias, dout, lse, delta,
                                         causal, scale, causal_offset,
                                         layout, bias_grad)
    scale = float(scale) if scale is not None else D ** -0.5
    bias, bias_sb, dout, lse, delta, strides = _bwd_common(
        q, k, v, bias, dout, lse, delta, layout)
    dev = q.device
    dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(v.shape, dtype=torch.float32, device=dev)
    db = torch.empty((B * H, S), dtype=torch.float32, device=dev) \
        if bias_grad else None
    st = (ctypes.c_longlong * 19)(*strides, *_bht_strides(dk, layout),
                                  *_bht_strides(dv, layout), bias_sb)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("flash_attention", "ptt_flash_attention_dkv",
                         [p] * 11 + [i] * 8 + [ctypes.c_float, p])
    launch("flash_attention_dkv", fn, dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), None if bias is None else bias.data_ptr(),
           dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), None if db is None else db.data_ptr(), st, B, H,
           T, S, D, DV, int(bool(causal)), S - T + int(causal_offset),
           scale)
    return dk, dv, db


class _Flash(torch.autograd.Function):
    """Forward: `_fwd`. Backward: delta, then the dq and dk/dv kernels
    (their plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, causal_offset, layout):
        out, lse = _fwd(q, k, v, bias, causal, scale, causal_offset, layout)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (causal, scale, causal_offset, layout)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        causal, scale, off, layout = ctx.args
        if dout is None:
            dout = torch.zeros_like(out)
        # delta = rowsum(dO * O) [B, H, T]; an lse cotangent g adds
        # p * g to ds, i.e. delta - g (`_bwd_call` :428-434)
        delta = _heads_second((dout.float() * out.float()).sum(-1, True),
                              layout)[..., 0]
        if dlse is not None:
            delta = delta - dlse.float()
        bias_grad = bias is not None and ctx.needs_input_grad[3]
        dq = flash_attention_dq(q, k, v, bias, dout, lse, delta, causal,
                                scale, off, layout)
        dk, dv, db = flash_attention_dkv(q, k, v, bias, dout, lse, delta,
                                         causal, scale, off, layout,
                                         bias_grad)
        if db is not None:
            B, S = q.shape[0], db.shape[1]
            db = db.reshape(B, -1, S).sum(1)
            if bias.shape[0] == 1:
                db = db.sum(0, keepdim=True)
            db = db.reshape(bias.shape).to(bias.dtype)
        return dq, dk, dv, db, None, None, None, None


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    causal_offset=0, layout="bhtd"):
    """q, k, v in `layout` -> (out in q's layout [.., DV], lse [B,H,T]
    f32), differentiable. CPU tensors go to `flash_attention_plain` (and
    the plain backward versions); CUDA tensors to the CUDA kernels."""
    return _Flash.apply(q, k, v, bias, causal, scale, causal_offset,
                        layout)


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
