"""Optimizer-update op kernels (counterpart of
`paddle_tpu/ops/kernels_optim.py`: `sgd` :23, `adam` :44, and the
row-sparse updates of embedding tables :360-470: `_dedup_rows` /
`dedup_rows`, `_merge_taps`, `sgd_row_update`, `adam_row_update`,
`sparse_sgd` and `sparse_adam`; every other update and metric op is not
ported).

An update op names the same variables as its inputs and outputs (the
parameter and its accumulators); the Executor writes the outputs back
to the scope. The moments and the update run in float32 whatever the
parameter's dtype, in the reference's order of operations.

The row-sparse ops update their table and moments IN PLACE, writing the
touched rows only (`index_copy_`): a table of 1e8 rows is never copied
to change a few thousand. A caller that keeps the scope's tensor from
before a run sees it change. Their row merge (`dedup_rows`) adds each
row's gradients in a fixed order, the order of a stable sort of the
ids (`torch.segment_reduce` over the sorted stream), never with
`index_add_`, whose CUDA atomics add in any order: a step repeats bit
for bit. Nothing in them waits for the device: the number of distinct
ids stays a tensor.
"""
import torch

from .registry import kernel

__all__ = ["dedup_rows", "segment_sum_sorted", "set_rows_",
           "sgd_row_update", "adam_row_update"]


def _lr(ins):
    return ins["LearningRate"][0].float().reshape(())


@kernel("sgd")
def _sgd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": [(p.float() - _lr(ins) * g.float()).to(p.dtype)]}


@kernel("adam")
def _adam(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins)
    gf = g.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * torch.square(gf)
    b1p_new = b1p * b1
    b2p_new = b2p * b2
    lr_t = lr * torch.sqrt(1 - b2p_new) / (1 - b1p_new)
    p_new = p.float() - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return {"ParamOut": [p_new.to(p.dtype)], "Moment1Out": [m_new],
            "Moment2Out": [v_new], "Beta1PowOut": [b1p_new],
            "Beta2PowOut": [b2p_new]}


# ---------------------------------------------------------------------------
# row-sparse (lazy) updates for embedding tables
# ---------------------------------------------------------------------------
def segment_sum_sorted(ids, rows, pad):
    """Merge the rows of equal ids: ids [N] int, rows [N, D] ->
    (uids [N] int64, sums [N, D] f32, count 0-d int64). The ids are
    stably sorted; uids[:count] are the distinct ids ascending and
    uids[count:] == `pad`; sums[s] adds the rows of uids[s] in the
    order they came in, and sums[count:] are zero."""
    n = ids.shape[0]
    sid, order = torch.sort(ids.long(), stable=True)
    srows = rows.float().index_select(0, order)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1
    # every position of a segment writes the same id
    uids = torch.full_like(sid, pad).scatter_(0, seg, sid)
    bounds = torch.searchsorted(
        seg, torch.arange(n + 1, device=ids.device))
    sums = torch.segment_reduce(srows, "sum", lengths=bounds.diff(),
                                axis=0, unsafe=True)
    return uids, sums, seg[-1] + 1


def dedup_rows(ids, rows, vocab):
    """The reference's static-shape duplicate-id merge (SelectedRows
    MergeAdd): ids clipped to [0, vocab) first, as the forward lookup
    clips them; -> (uids [N] padded with `vocab`, summed [N, D] f32)."""
    flat = ids.reshape(-1).long().clamp(0, vocab - 1)
    uids, sums, _count = segment_sum_sorted(
        flat, rows.reshape(flat.shape[0], -1), vocab)
    return uids, sums


def set_rows_(dst, idx, rows, count):
    """dst[idx[i]] = rows[i] for i < count, in place, where idx[:count]
    are distinct valid rows and idx[count:] padding (count a 0-d
    tensor, read on the device). Padding positions repeat the last
    valid entry, so duplicate writes carry equal bytes; with count 0
    they write row 0 back unchanged."""
    n = idx.shape[0]
    j = torch.minimum(torch.arange(n, device=idx.device),
                      (count - 1).clamp(min=0))
    ok = j < count
    at = torch.where(ok, idx.index_select(0, j), 0)
    src = torch.where(ok[:, None], rows.index_select(0, j).to(dst.dtype),
                      dst[:1])
    dst.index_copy_(0, at, src)
    return dst


def _merge_taps(ins, dim):
    """Every (Ids, Grad) tap of a table as one (ids, rows) stream, so a
    table read by several lookups is updated once."""
    ids = torch.cat([i.reshape(-1) for i in ins["Ids"]])
    rows = torch.cat([g.reshape(-1, dim) for g in ins["Grad"]])
    return ids, rows


def sgd_row_update(p_rows, gsum, lr):
    """The row-sparse SGD formula, shared by `sparse_sgd` and the
    sharded engine (parallel/sparse.py). fp32."""
    return p_rows.float() - lr * gsum


def adam_row_update(p_rows, m_rows, v_rows, gsum, lr, b1, b2, eps,
                    b1p_new, b2p_new):
    """The lazy row-sparse Adam formula (adam_op.h SparseAdamFunctor),
    shared by `sparse_adam` and the sharded engine; b1p_new / b2p_new
    are the beta powers already advanced. -> (p, m, v) rows in fp32."""
    m_new = b1 * m_rows + (1 - b1) * gsum
    v_new = b2 * v_rows + (1 - b2) * torch.square(gsum)
    lr_t = lr * torch.sqrt(1 - b2p_new.reshape(())) \
        / (1 - b1p_new.reshape(()))
    p_new = p_rows.float() - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return p_new, m_new, v_new


def _dedup_taps(ins, p):
    vocab = p.shape[0]
    ids, g = _merge_taps(ins, p.shape[-1])
    uids, gsum, count = segment_sum_sorted(
        ids.long().clamp(0, vocab - 1), g, vocab)
    return uids, uids.clamp(max=vocab - 1), gsum, count


@kernel("sparse_sgd")
def _sparse_sgd(ctx, ins, attrs):
    """Row-sparse SGD: only the rows named by Ids change. Grad holds
    the gathered row gradients [..., D], never [V, D]."""
    p = ins["Param"][0]
    uids, safe, gsum, count = _dedup_taps(ins, p)
    new = sgd_row_update(p.index_select(0, safe), gsum, _lr(ins))
    return {"ParamOut": [set_rows_(p, uids, new, count)]}


@kernel("sparse_adam")
def _sparse_adam(ctx, ins, attrs):
    """Lazy row-sparse Adam: moments and parameter change on the rows
    in Ids only; untouched rows keep their moments (the reference's
    lazy mode), and the beta powers advance every step."""
    p = ins["Param"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p_new = ins["Beta1Pow"][0] * attrs.get("beta1", 0.9)
    b2p_new = ins["Beta2Pow"][0] * attrs.get("beta2", 0.999)
    uids, safe, gsum, count = _dedup_taps(ins, p)
    p_new, m_new, v_new = adam_row_update(
        p.index_select(0, safe), m.index_select(0, safe),
        v.index_select(0, safe), gsum, _lr(ins), attrs.get("beta1", 0.9),
        attrs.get("beta2", 0.999), attrs.get("epsilon", 1e-8), b1p_new,
        b2p_new)
    return {"ParamOut": [set_rows_(p, uids, p_new, count)],
            "Moment1Out": [set_rows_(m, uids, m_new, count)],
            "Moment2Out": [set_rows_(v, uids, v_new, count)],
            "Beta1PowOut": [b1p_new], "Beta2PowOut": [b2p_new]}
