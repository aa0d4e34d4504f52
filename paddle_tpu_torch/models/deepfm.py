"""DeepFM CTR model (counterpart of `paddle_tpu/models/deepfm.py`:
`deepfm` and `build_program`), built with the port's layers into the
reference's program, op for op.

A first-order table [vocab, 1] and a factor table [vocab, embed_dim]
are looked up at every field's id; the logit adds the first-order term
sum_f w_f x_f, the FM term 0.5 ((sum_f v_f x_f)^2 - sum_f (v_f x_f)^2)
and a deep tower of fc + relu layers over the flattened v x. With
is_sparse=True (the default) both tables get row gradients and
row-sparse updates; is_distributed=True also marks them for the sharded
engine (`ParallelExecutor(sparse="shard")`, parallel/sparse.py).
"""
from .. import layers

__all__ = ["deepfm", "build_program"]


def deepfm(feat_ids, feat_vals, num_fields, vocab_size, embed_dim=10,
           deep_layers=(400, 400, 400), is_sparse=True,
           is_distributed=False):
    """feat_ids / feat_vals: [B, num_fields(, 1)] ids and values ->
    the logit [B, 1]."""
    first_w = layers.embedding(feat_ids, size=[vocab_size, 1],
                               is_sparse=is_sparse,
                               is_distributed=is_distributed)
    vals = layers.unsqueeze(feat_vals, [2]) \
        if len(feat_vals.shape) == 2 else feat_vals
    first = layers.reduce_sum(
        layers.elementwise_mul(layers.squeeze(first_w, [2]),
                               layers.squeeze(vals, [2])), dim=1,
        keep_dim=True)
    emb = layers.embedding(feat_ids, size=[vocab_size, embed_dim],
                           is_sparse=is_sparse,
                           is_distributed=is_distributed)
    vx = layers.elementwise_mul(emb, vals)
    sum_vx = layers.reduce_sum(vx, dim=1)
    sum_sq = layers.elementwise_mul(sum_vx, sum_vx)
    sq = layers.elementwise_mul(vx, vx)
    sq_sum = layers.reduce_sum(sq, dim=1)
    second = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=1,
                          keep_dim=True), 0.5)
    deep = layers.reshape(vx, [0, num_fields * embed_dim])
    for width in deep_layers:
        deep = layers.fc(deep, size=width, act="relu")
    deep_out = layers.fc(deep, size=1)
    return layers.elementwise_add(layers.elementwise_add(first, second),
                                  deep_out)


def build_program(num_fields=26, vocab_size=100000, embed_dim=10,
                  is_sparse=True, is_distributed=False):
    """Data vars, the mean sigmoid cross-entropy loss and the click
    probability: ([feat_ids, feat_vals, label], loss, prob)."""
    feat_ids = layers.data("feat_ids", shape=[num_fields], dtype="int64")
    feat_vals = layers.data("feat_vals", shape=[num_fields],
                            dtype="float32")
    label = layers.data("label", shape=[1], dtype="float32")
    logit = deepfm(feat_ids, feat_vals, num_fields, vocab_size, embed_dim,
                   is_sparse=is_sparse, is_distributed=is_distributed)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, label))
    return [feat_ids, feat_vals, label], loss, layers.sigmoid(logit)
