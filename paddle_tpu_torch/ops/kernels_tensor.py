"""Tensor creation and manipulation op kernels (counterpart of
`paddle_tpu/ops/kernels_tensor.py`: `fill_constant`, `reshape`,
`squeeze` (:83), `unsqueeze`, `split`, `uniform_random`,
`gaussian_random` and `lookup_table` (:348); every other op of the
module is not ported).

The random ops draw from the op's own `torch.Generator`
(`KernelCtx.generator`, seeded from the program seed and the op's
index). They cannot give the reference's `jax.random` numbers: the
tests compare their statistics. `reshape`, `squeeze` and `unsqueeze`
return views, and do not produce the reference's empty `XShape`
output, which no layer of the port declares. Under `torch.autograd`
`lookup_table`'s table gradient is dense, as the reference's is for a
table that is not `is_sparse`, and bitwise repeatable on the CPU and
on the card: it gathers through `torch.nn.functional.embedding`, whose
backward adds repeated ids in a fixed order. (The backward of `w[ids]`,
`index_put_` with accumulate, adds them from several CPU threads in
any order.)
"""
import torch

from ..core.dtypes import to_torch_dtype
from .registry import kernel


def _x(ins, slot="X"):
    return ins[slot][0]


@kernel("fill_constant")
def _fill_constant(ctx, ins, attrs):
    return {"Out": [torch.full(tuple(attrs["shape"]),
                               attrs.get("value", 0.0),
                               dtype=to_torch_dtype(attrs.get("dtype",
                                                              "float32")),
                               device=ctx.device)]}


@kernel("reshape")
def _reshape(ctx, ins, attrs):
    """Fluid semantics: 0 copies the input's dim, -1 is inferred."""
    x = _x(ins)
    shape = [x.shape[i] if s == 0 else int(s)
             for i, s in enumerate(attrs["shape"])]
    return {"Out": [x.reshape(shape)]}


@kernel("squeeze")
def _squeeze(ctx, ins, attrs):
    x = _x(ins)
    axes = attrs.get("axes") or None
    if axes:
        return {"Out": [x.squeeze(tuple(a if a >= 0 else a + x.dim()
                                        for a in axes))]}
    return {"Out": [x.squeeze()]}


@kernel("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    out = _x(ins)
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": [out]}


@kernel("split")
def _split(ctx, ins, attrs):
    x = _x(ins)
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections")
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    num = attrs.get("num", 0)
    if num < 1 or x.shape[axis] % num:
        raise ValueError(f"split: dim {axis} of size {x.shape[axis]} does "
                         f"not split into {num} equal parts")
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@kernel("uniform_random")
def _uniform_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs["shape"]),
                      dtype=to_torch_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator())
    return {"Out": [out]}


@kernel("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs["shape"]),
                      dtype=to_torch_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)
    out.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                generator=ctx.generator())
    return {"Out": [out]}


@kernel("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """Rows of W at Ids (clipped to the table, as the reference's
    jnp.take; a trailing ids dim of 1 is dropped); rows whose id is
    padding_idx are zero. An `is_sparse` lookup's `SparseDelta` (the
    row-gradient tap: a scalar zero outside the training replay, zeros
    of the gathered shape inside it) is added before the padding mask,
    so padded positions get zero row gradients (`kernels_tensor.py:356`)."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() >= 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    ids = ids.long()
    out = torch.nn.functional.embedding(ids.clamp(0, w.shape[0] - 1), w)
    if ins.get("SparseDelta"):
        out = out + ins["SparseDelta"][0]
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return {"Out": [out]}

