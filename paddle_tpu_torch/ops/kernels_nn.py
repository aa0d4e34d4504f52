"""Neural-network op kernels (counterpart of
`paddle_tpu/ops/kernels_nn.py`: `layer_norm` :232, `dropout` :298,
`softmax_with_cross_entropy` :363 with `_gather_label_logp` :330,
`sigmoid_cross_entropy_with_logits` :400, `square_error_cost` :409,
`sequence_mask` :680, `_attn_softmax` :741,
`scaled_dot_product_attention` :771, `add_position_encoding` :801 and
`flash_attention` :909; every other op of the module is not ported).

`layer_norm` and `flash_attention` reach the hand-written Hopper kernels
through `ctx.accel`, as the reference reaches its Pallas kernels: the
kernel's `try_*` entry runs it (its plain version on the CPU) or
returns None when the kernel's static shape check rejects the inputs,
and the op then runs its composition. `layer_norm` falls to the
composition only where the reference's does: a norm over more than the
last axis, or no scale or bias. `flash_attention` falls to the
`scaled_dot_product_attention` composition for a bias that is not a
per-key bias ([B,S], [B,1,1,S], [1,S] or [1,1,1,S]), such as a full
[B,H,T,S] one. The TPU's gates (the kernel's minimum sequence length,
Mosaic's 128-lane rule, at least 8 rows) are not inherited: on the card
every `layer_norm` and `flash_attention` op of Transformer inference
launches its kernel. Where the flash kernel ran, the op's `Weights`
output is an empty tensor, as in the reference. Both kernels are
`torch.autograd.Function`s: in the training step's forward replay
(core/trace.py) their backward kernels run too (flash dq and dk/dv,
LayerNorm backward); `layer_norm`'s `Mean` and `Variance` carry no
gradient.

Every op here is differentiable under `torch.autograd`. `dropout` in
training draws its keep mask from the op's generator, so its gradient
is that mask times 1 / (1 - p) (`upscale_in_train`) or the mask
(`downgrade_in_infer`).

The `scaled_dot_product_attention` composition masks the causal part
with -inf where the kernel uses -1e30; both give such a key weight 0,
and only a fully masked row, whose output both packages leave
implementation-defined, tells them apart.
"""
import numpy as np
import torch

from ..core.dtypes import to_torch_dtype
from .registry import kernel

__all__ = ["_attn_softmax"]


def _x(ins, slot="X"):
    return ins[slot][0]


def _opt(ins, slot):
    v = ins.get(slot)
    return v[0] if v else None


@kernel("layer_norm")
def _layer_norm(ctx, ins, attrs):
    x = _x(ins)
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    scale, bias = _opt(ins, "Scale"), _opt(ins, "Bias")
    fused = ctx.accel("layer_norm")
    if fused is not None:
        got = fused(x, scale, bias, eps, begin)
        if got is not None:
            y, mean, var = got
            return {"Y": [y], "Mean": [mean], "Variance": [var]}
    axes = tuple(range(begin, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    return {"Y": [y.to(x.dtype)], "Mean": [mean.squeeze()],
            "Variance": [var.squeeze()]}


@kernel("dropout")
def _dropout(ctx, ins, attrs):
    """Under is_test (the op's attr or the executor's mode): identity for
    upscale_in_train, a scale by 1 - p for downgrade_in_infer. In
    training, each element is kept with probability 1 - p, drawn from
    the op's generator."""
    x = _x(ins)
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test or p == 0.0:
        out = x * (1.0 - p) if (impl == "downgrade_in_infer" and p) else x
        return {"Out": [out], "Mask": [torch.ones_like(x)]}
    keep = torch.rand(x.shape, generator=ctx.generator(),
                      device=x.device) < (1.0 - p)
    zero = torch.zeros_like(x)
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), zero)
    else:
        out = torch.where(keep, x, zero)
    return {"Out": [out], "Mask": [keep.to(x.dtype)]}


def _labels(label, logits):
    """Integer labels as int64, a trailing label dim of 1 dropped."""
    lbl = label.long()
    if lbl.dim() == logits.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    return lbl


def _gather_label_logp(logp, label, ignore_index=-100):
    """logp[..., label] per row, kept dim of 1; zero where the label is
    ignore_index or out of range (no class matches it)."""
    lbl = _labels(label, logp)
    K = logp.shape[-1]
    live = (lbl != ignore_index) & (lbl >= 0) & (lbl < K)
    picked = torch.gather(logp, -1, lbl.clamp(0, K - 1)[..., None])
    return torch.where(live[..., None], picked, torch.zeros_like(picked))


@kernel("softmax_with_cross_entropy")
def _softmax_ce(ctx, ins, attrs):
    """Cross entropy of softmax(logits) in f32. With `smooth_epsilon`
    and integer labels, the label-smoothed loss against
    (1 - eps) * onehot + eps / K in the reference's fused form,
    (1 - eps) * (lse - logit[y]) + eps * (lse - mean(logits)), zero
    for an ignored or out-of-range label; else soft-label or hard-label
    CE. Outputs Loss [..., 1] and Softmax in the logits' dtype."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    eps = attrs.get("smooth_epsilon", 0.0)
    ignore = attrs.get("ignore_index", -100)
    lg = logits.float()
    if eps and not attrs.get("soft_label", False):
        lse = torch.logsumexp(lg, dim=-1, keepdim=True)
        picked = _gather_label_logp(lg, label, ignore)
        loss = (1.0 - eps) * (lse - picked) \
            + eps * (lse - lg.mean(dim=-1, keepdim=True))
        lbl = _labels(label, lg)
        dead = ((lbl == ignore) | (lbl < 0)
                | (lbl >= lg.shape[-1]))[..., None]
        loss = torch.where(dead, torch.zeros_like(loss), loss)
        return {"Loss": [loss.to(logits.dtype)],
                "Softmax": [torch.exp(lg - lse).to(logits.dtype)]}
    logp = torch.log_softmax(lg, dim=-1)
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(dim=-1, keepdim=True)
    else:
        loss = -_gather_label_logp(logp, label, ignore)
    return {"Loss": [loss.to(logits.dtype)],
            "Softmax": [torch.exp(logp).to(logits.dtype)]}


@kernel("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, ins, attrs):
    """max(x, 0) - x * label + log1p(exp(-|x|)), zero where the label
    equals `ignore_index`; at x = 0 the max splits its gradient in
    halves, as jnp.maximum does."""
    x, label = _x(ins), ins["Label"][0]
    loss = torch.maximum(x, torch.zeros_like(x)) - x * label \
        + torch.log1p(torch.exp(-torch.abs(x)))
    ii = attrs.get("ignore_index", -100)
    loss = torch.where(label == ii, torch.zeros_like(loss), loss)
    return {"Out": [loss]}


@kernel("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    return {"Out": [torch.square(ins["X"][0] - ins["Y"][0])]}


@kernel("sequence_mask")
def _sequence_mask(ctx, ins, attrs):
    seq_len = _x(ins)
    maxlen = attrs.get("maxlen", -1)
    if maxlen <= 0:
        raise ValueError("sequence_mask requires a static maxlen > 0")
    m = torch.arange(maxlen, device=seq_len.device)[None, :] \
        < seq_len.reshape(-1, 1)
    return {"Y": [m.to(to_torch_dtype(attrs.get("out_dtype", "int64")))]}


def _attn_softmax(logits):
    """Softmax over the last dim with f32 internals, returned in the
    logits' own dtype. A fully masked row (max -inf) gets a finite
    shift of 0, as in the reference."""
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp((logits - m).float())
    return (e / e.sum(dim=-1, keepdim=True)).to(logits.dtype)


@kernel("scaled_dot_product_attention")
def _sdpa(ctx, ins, attrs):
    """softmax(q k^T * scale + mask) v, with the causal part (a
    bottom-right diagonal) at -inf; bf16 inputs compute their logits in
    bf16, everything else in f32. layout "bthd" keeps heads in the
    third dim and needs no transpose."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    mask = _opt(ins, "Mask")
    scale = attrs.get("scale", None) or (1.0 / np.sqrt(q.shape[-1]))
    bthd = attrs.get("layout", "bhtd") == "bthd"
    cdt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    sc = torch.tensor(scale, dtype=cdt, device=q.device)
    if bthd:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(cdt) * sc
    else:
        logits = torch.einsum("...qd,...kd->...qk", q, k).to(cdt) * sc
    if mask is not None:
        logits = logits + mask.to(cdt)
    if attrs.get("causal", False):
        T, S = logits.shape[-2], logits.shape[-1]
        cm = torch.ones((T, S), dtype=torch.bool,
                        device=q.device).tril(diagonal=S - T)
        logits = logits.masked_fill(~cm, float("-inf"))
    w = _attn_softmax(logits).to(q.dtype)
    if bthd:
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    else:
        out = torch.einsum("...qk,...kd->...qd", w, v)
    return {"Out": [out], "Weights": [w]}


@kernel("add_position_encoding")
def _add_position_encoding(ctx, ins, attrs):
    """x [B,T,D] plus the sinusoidal table [T,D] in f32 (sin of the
    first D/2 frequencies, then cos), as alpha*x + beta*pe."""
    x = _x(ins)
    alpha, beta = attrs.get("alpha", 1.0), attrs.get("beta", 1.0)
    _B, T, D = x.shape
    pos = torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
    i = torch.arange(D // 2, dtype=torch.float32, device=x.device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * i / D)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return {"Out": [alpha * x + beta * pe[None].to(x.dtype)]}


@kernel("flash_attention")
def _flash_attention(ctx, ins, attrs):
    """Flash attention: the hand-written kernel (its plain version on
    the CPU) for a per-key bias or none, else the sdpa composition.
    layout "bthd" (what multi_head_attention emits) or "bhtd"; the
    kernel reads either through strides, so no transpose is made."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    scale = attrs.get("scale", None) or (1.0 / np.sqrt(q.shape[-1]))
    fused = ctx.accel("flash_attention")
    if fused is not None:
        out = fused(q, k, v, bias=_opt(ins, "Mask"),
                    causal=attrs.get("causal", False), scale=scale,
                    layout=attrs.get("layout", "bhtd"))
        if out is not None:
            return {"Out": [out],
                    "Weights": [torch.zeros((0,), dtype=q.dtype,
                                            device=q.device)]}
    return _sdpa(ctx, ins, attrs)
