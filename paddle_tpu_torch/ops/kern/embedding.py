"""Fused embedding lookup + pool (counterpart of
`paddle_tpu/ops/pallas/embedding.py`: `_pool_kernel` :78 launched by
`_fwd` :100, wrapped by the custom VJP `lookup_pool` :134 with its
backward `_bwd_vjp` :149, and the dispatch policy `try_lookup_pool`
:187).

`lookup_pool(table, inv, weights=None, pool="sum")` computes

    out[r] = pool over f of weights[r, f] * table[inv[r, f]]

for table [C, D], inv [R, F] (int32 or int64; a negative entry is
padding: it contributes nothing and is left out of the mean's count
max(count, 1); an id past the table reads its last row, as the
reference's jnp composition clips it), weights [R, F] or None, pool
"sum" or "mean"; it returns [R, D] in the table's dtype, accumulated in
fp32. It is a `torch.autograd.Function`. For CUDA tensors its forward
launches the hand-written kernel of `csrc/embedding.cu` (counted in
`LAUNCHES["lookup_pool"]`; fp32 tables only, bf16 waits for the AMP
slice); for CPU tensors it takes `lookup_pool_plain`, which repeats the
kernel's arithmetic bit for bit (the sum over f in order, no fma, IEEE
division); for a tensor on any other device, or a launch that fails, it
raises. A padding position reads no row, so a NaN in the table reaches
only the rows that look it up.

The backward is plain PyTorch, as the reference's is jnp (there is no
backward TPU kernel): d(table) is the segment sum of the pooled
cotangent over inv, added in a fixed order (`kernels_optim.
segment_sum_sorted`, never `index_add_`, whose CUDA atomics add in any
order), written into a zero [C, D] table; d(weights)[r, f] is the dot of
the looked-up row with the cotangent, 0 for padding.

`try_lookup_pool` is the static shape check of the reference's entry of
the same name: it returns None for inputs the kernel cannot take (a
table or inv that is not 2-D, weights not of inv's shape, another pool,
ids that are not int32 or int64) and `lookup_pool`'s result otherwise.
It never looks at the table's dtype: a table that is not fp32 reaches
`_fwd`, which raises for it on the card. The port's own callers (the
`fused_embedding_seq_pool` op and the sharded engine) always pass 2-D
inputs and call `lookup_pool` itself. The TPU's gates (the table and a
row block within VMEM, at least 8 rows) are not inherited.
"""
import ctypes

import torch

from ..kernels_optim import segment_sum_sorted, set_rows_
from . import LAUNCHES, _build, launch, on_cpu

__all__ = ["lookup_pool", "lookup_pool_plain", "try_lookup_pool",
           "LAUNCHES"]


def lookup_pool_plain(table, inv, weights=None, pool="sum"):
    """Plain PyTorch version of the kernel: the same contributions (the
    row, w * row, or 0 for padding), summed over f in order, the mean
    divided by a tensor of counts."""
    C, D = table.shape
    R, F = inv.shape
    valid = inv >= 0
    rows = table.index_select(0, inv.reshape(-1).clamp(0, C - 1)).reshape(
        R, F, D).float()
    if weights is not None:
        rows = weights.float()[:, :, None] * rows
    contrib = torch.where(valid[:, :, None], rows, torch.zeros_like(rows))
    out = contrib[:, 0]
    for f in range(1, F):
        out = out + contrib[:, f]
    if pool == "mean":
        out = out / valid.sum(1, keepdim=True).clamp(min=1).float()
    return out.to(table.dtype)


def _check(table, inv, weights, pool):
    if table.dim() != 2 or inv.dim() != 2 or inv.shape[1] < 1 \
            or table.shape[0] < 1 or (weights is not None
                                      and weights.shape != inv.shape):
        raise ValueError(
            f"lookup_pool wants table [C, D], inv [R, F] (F >= 1) and "
            f"weights of inv's shape; got table {tuple(table.shape)}, inv "
            f"{tuple(inv.shape)}, weights "
            f"{None if weights is None else tuple(weights.shape)}")
    if pool not in ("sum", "mean"):
        raise ValueError(f"lookup_pool pool {pool!r} not in (sum, mean)")
    if inv.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lookup_pool takes int32 or int64 inv, got "
                        f"{inv.dtype}")


def _fwd(table, inv, weights, pool):
    """The forward without autograd: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    _check(table, inv, weights, pool)
    ts = (("table", table), ("inv", inv))
    if weights is not None:
        ts += (("weights", weights),)
    if on_cpu(ts, "lookup_pool"):
        return lookup_pool_plain(table, inv, weights, pool)
    if table.dtype != torch.float32:
        raise TypeError(f"lookup_pool kernel takes an fp32 table, got "
                        f"{table.dtype} (bf16 waits for the AMP slice)")
    table, inv = table.contiguous(), inv.contiguous()
    w = None if weights is None else weights.float().contiguous()
    C, D = table.shape
    R, F = inv.shape
    out = torch.empty((R, D), dtype=torch.float32, device=table.device)
    vec4 = D % 4 == 0 and table.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _build.function("embedding", "ptt_lookup_pool",
                         [p, p, i, p, p, ll, i, ll, i, i, i, p])
    launch("lookup_pool", fn, table.device, table.data_ptr(),
           inv.data_ptr(), int(inv.dtype == torch.int64),
           None if w is None else w.data_ptr(), out.data_ptr(), R, F, C, D,
           int(pool == "mean"), int(vec4))
    return out


def _bwd(table, inv, weights, pool, dy, need_table, need_w):
    """(d table [C, D] in the table's dtype or None, d weights or None)."""
    C, D = table.shape
    R, F = inv.shape
    valid = inv >= 0
    dyf = dy.float()
    if pool == "mean":
        dyf = dyf / valid.sum(1, keepdim=True).clamp(min=1).float()
    dtab = dw = None
    if need_table:
        w = torch.ones(R, F, device=dy.device) if weights is None \
            else weights.float()
        w = torch.where(valid, w, torch.zeros_like(w))
        contrib = (w[:, :, None] * dyf[:, None, :]).reshape(R * F, D)
        seg = torch.where(valid, inv.long().clamp(max=C - 1), C).reshape(-1)
        uids, sums, count = segment_sum_sorted(seg, contrib, C)
        full = torch.zeros((C + 1, D), dtype=torch.float32, device=dy.device)
        dtab = set_rows_(full, uids, sums, count)[:C].to(table.dtype)
    if need_w:
        rows = table.index_select(0, inv.reshape(-1).clamp(0, C - 1)
                                  ).reshape(R, F, D).float()
        dot = torch.einsum("rfd,rd->rf", rows, dyf)
        dw = torch.where(valid, dot, torch.zeros_like(dot)).to(weights.dtype)
    return dtab, dw


class _LookupPool(torch.autograd.Function):
    """Forward: `_fwd`. Backward: `_bwd` (plain PyTorch on either
    device); inv has no gradient."""

    @staticmethod
    def forward(ctx, table, inv, weights, pool):
        ctx.save_for_backward(table, inv, weights)
        ctx.pool = pool
        return _fwd(table, inv, weights, pool)

    @staticmethod
    def backward(ctx, dy):
        table, inv, weights = ctx.saved_tensors
        dtab, dw = _bwd(table, inv, weights, ctx.pool, dy,
                        ctx.needs_input_grad[0],
                        weights is not None and ctx.needs_input_grad[2])
        return dtab, None, dw, None


def lookup_pool(table, inv, weights=None, pool="sum"):
    """table [C, D], inv [R, F] int32/int64 (negative = padding),
    weights [R, F] or None, pool "sum" | "mean" -> [R, D] in the table's
    dtype, differentiable in table and weights."""
    return _LookupPool.apply(table, inv, weights, pool)


def try_lookup_pool(table, inv, weights=None, pool="sum"):
    """`lookup_pool`'s result, or None where the static shape check
    fails (a table or inv that is not 2-D, weights not of inv's shape,
    another pool, or ids that are not int32 or int64)."""
    if pool not in ("sum", "mean") or table.dim() != 2 or inv.dim() != 2 \
            or inv.dtype not in (torch.int32, torch.int64) \
            or (weights is not None and weights.shape != inv.shape):
        return None
    return lookup_pool(table, inv, weights, pool)
