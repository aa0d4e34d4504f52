"""Extra op kernels (counterpart of `paddle_tpu/ops/kernels_extra.py`:
the `fused_embedding_seq_pool` op :410; every other op of the module is
not ported).

`fused_embedding_seq_pool` (ref operators/fused/
fused_embedding_seq_pool_op.h) is lookup_table and sequence_pool in one
op: ids [R, F(, 1)] (or [R]) are clipped to the table, the padding id
maps to -1, and out[r] pools the looked-up rows over f, by sum or by
mean ("mean" / "average"), with an optional `Weight` [R, F] per
position, reshaped to the ids' [R, F] (the reference reshapes only a
Weight of rank > 2, so its [R] Weight beside [R] ids broadcasts to
[R, R] and every row is scaled by the sum of all weights; the port
weights row r by Weight[r]). It calls the hand-written kernel's wrapper
`ops/kern/embedding.lookup_pool`, which launches `csrc/embedding.cu` on
CUDA tensors and runs its plain version, `lookup_pool_plain`, on CPU
tensors: a negative id contributes nothing and is left out of the
mean's count. The reference's jnp composition `lookup_pool_reference`
:387 is not ported as a second body: `lookup_pool_plain` computes the
same function (held against it in tests/test_torch_embedding_pool.py).
"""
import torch

from .kern.embedding import lookup_pool
from .registry import kernel

__all__ = []


@kernel("fused_embedding_seq_pool")
def _fused_embedding_seq_pool(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    if ids.dim() == 1:
        ids = ids[:, None]
    weights = ins["Weight"][0] if ins.get("Weight") else None
    if weights is not None:
        weights = weights.reshape(ids.shape)
    pool = attrs.get("pooltype", attrs.get("combiner", "sum")).lower()
    if pool not in ("sum", "mean", "average"):
        raise NotImplementedError(
            f"fused_embedding_seq_pool pooltype {pool!r} (sum/mean only)")
    pool = "mean" if pool in ("mean", "average") else "sum"
    padding_idx = attrs.get("padding_idx", -1)
    inv = ids.long().clamp(0, w.shape[0] - 1)
    if padding_idx is not None and padding_idx >= 0:
        inv = torch.where(ids == padding_idx, -1, inv)
    return {"Out": [lookup_pool(w, inv, weights, pool)]}
