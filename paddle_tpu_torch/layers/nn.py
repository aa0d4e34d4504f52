"""Neural-network layers (counterpart of `paddle_tpu/layers/nn.py`).

Same op types, attrs, parameter names and variable names as the
reference, so a model built with these layers has the reference's
program description. The signatures are the reference's less the
arguments it accepts and ignores: `fc(is_test)`, `dropout(seed)`,
`reshape(actual_shape, act, inplace)`, `multi_head_attention(cache)`
and the `name` of `squeeze` and `reduce_sum` are not ported, and the
arguments after them are keyword-only, so a caller who passes one gets
a TypeError, not a silent no-op; the
reference's `softmax_with_cross_entropy(numeric_stable_mode=False)`,
which it ignores too, raises NotImplementedError. Ported: `fc`,
`embedding` (:120, with `is_sparse` and `is_distributed`),
`layer_norm`, `dropout`, `multi_head_attention` (fused and unfused
q/k/v, `use_flash`), `add_position_encoding`, `argmax`, `scale`,
`elementwise_add`, `reshape`, `split` and `unsqueeze` (what
Transformer inference and `greedy_decode` call), the training loss's
`softmax_with_cross_entropy` (:466), `squeeze` (:863), `reduce_sum`
(:1080) and `elementwise_mul` / `_div` / `_max` (:1142-1150), DeepFM's
`sigmoid_cross_entropy_with_logits` (:487), `mean` (:1060) and
`elementwise_sub` (:1138), and `square_error_cost` (:496). Every other
layer of the reference's module is left out, among them `fc` over a
list of inputs, the other losses, convolutions, pooling, RNNs and the
other reductions.
"""
import numpy as np

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "layer_norm", "dropout",
           "multi_head_attention", "add_position_encoding", "argmax",
           "scale", "elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "reshape", "split",
           "squeeze", "unsqueeze", "reduce_sum", "mean",
           "softmax_with_cross_entropy",
           "sigmoid_cross_entropy_with_logits", "square_error_cost"]


def _dims(shape):
    return [int(s) for s in shape]


def _simple(helper_name, op_type, x, out_shape=None, attrs=None,
            extra=None, out_slot="Out", dtype=None, stop_gradient=False):
    helper = LayerHelper(helper_name)
    out = helper.create_variable_for_type_inference(
        dtype or x.dtype, out_shape if out_shape is not None else x.shape,
        stop_gradient)
    ins = {"X": [x]}
    if extra:
        ins.update(extra)
    helper.append_op(op_type, ins, {out_slot: [out]}, attrs or {})
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, *, name=None):
    """Fully-connected layer: mul + elementwise_add (bias) + activation.
    The reference's list of inputs (one weight each, summed) is not
    ported."""
    if isinstance(input, (list, tuple)):
        raise NotImplementedError("fc over a list of inputs is not ported")
    helper = LayerHelper("fc", name=name, act=act, bias_attr=bias_attr)
    dtype = input.dtype
    in_dim = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, shape=[in_dim, size],
                                dtype=dtype)
    tmp = helper.create_variable_for_type_inference(
        dtype, tuple(input.shape[:num_flatten_dims]) + (size,))
    helper.append_op("mul", {"X": [input], "Y": [w]}, {"Out": [tmp]},
                     {"x_num_col_dims": num_flatten_dims,
                      "y_num_col_dims": 1})
    tmp = helper.append_bias_op(tmp, dim_start=num_flatten_dims,
                                bias_attr=bias_attr, size=size)
    return helper.append_activation(tmp, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32",
              name=None):
    """lookup_table over a [vocab, dim] table initialized N(0, 0.02).

    is_sparse=True gives the table row gradients, as the reference's
    SelectedRows path does: the lookup adds a zero "delta" input of the
    gathered shape (its own variable, `SparseDelta`), core/trace.py
    differentiates the delta instead of the table, and the optimizer
    appends one `sparse_sgd` / `sparse_adam` op that updates only the
    looked-up rows. The taps are recorded on the parameter as
    `_sparse_lookup` [{"ids", "delta"}]. is_distributed=True marks the
    table for the sharded engine (parallel/sparse.py,
    `ParallelExecutor(sparse="shard")`)."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, shape=_dims(size), dtype=dtype,
                                default_initializer=NormalInitializer(0.0,
                                                                      0.02))
    in_shape = input.shape
    if in_shape and in_shape[-1] == 1:
        out_shape = tuple(in_shape[:-1]) + (size[1],)
    else:
        out_shape = tuple(in_shape) + (size[1],)
    out = helper.create_variable_for_type_inference(dtype, out_shape)
    inputs = {"W": [w], "Ids": [input]}
    attrs = {"padding_idx": -1 if padding_idx is None else padding_idx}
    if is_distributed:
        attrs["is_distributed"] = True
    if is_sparse:
        delta = helper.create_variable_for_type_inference(dtype, out_shape)
        inputs["SparseDelta"] = [delta]
        attrs["is_sparse"] = True
        taps = getattr(w, "_sparse_lookup", None) or []
        taps.append({"ids": input.name, "delta": delta.name})
        w._sparse_lookup = taps
    helper.append_op("lookup_table", inputs, {"Out": [out]}, attrs)
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", name=name, act=act)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    ins = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            param_attr, shape=norm_shape, dtype="float32",
            default_initializer=ConstantInitializer(1.0))
        ins["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, shape=norm_shape,
                                    dtype="float32", is_bias=True)
        ins["Bias"] = [b]
    out = helper.create_variable_for_type_inference(dtype, input.shape)
    mean = helper.create_variable_for_type_inference("float32", (), True)
    var = helper.create_variable_for_type_inference("float32", (), True)
    helper.append_op("layer_norm", ins,
                     {"Y": [out], "Mean": [mean], "Variance": [var]},
                     {"epsilon": epsilon,
                      "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out, act)


def dropout(x, dropout_prob, is_test=False, *, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    mask = helper.create_variable_for_type_inference(x.dtype, x.shape, True)
    helper.append_op("dropout", {"X": [x]}, {"Out": [out], "Mask": [mask]},
                     {"dropout_prob": dropout_prob, "is_test": is_test,
                      "dropout_implementation": dropout_implementation})
    return out


def reshape(x, shape, *, name=None):
    shape = list(shape)
    resolved = []
    for i, s in enumerate(shape):
        s = int(s)
        resolved.append(x.shape[i] if s == 0 else s)
    return _simple("reshape", "reshape", x, tuple(resolved),
                   {"shape": shape})


def squeeze(input, axes=None):
    shape = list(input.shape)
    if axes:
        out_shape = tuple(s for i, s in enumerate(shape)
                          if i not in [a % len(shape) for a in axes])
    else:
        out_shape = tuple(s for s in shape if s != 1)
    return _simple("squeeze", "squeeze", input, out_shape,
                   {"axes": list(axes or [])})


def unsqueeze(input, axes, name=None):
    shape = list(input.shape)
    for a in sorted(axes):
        shape.insert(a, 1)
    return _simple("unsqueeze", "unsqueeze", input, tuple(shape),
                   {"axes": list(axes)})


def argmax(x, axis=-1, keepdims=False, name=None):
    shape = list(x.shape)
    ax = axis % len(shape) if shape else 0
    if keepdims:
        shape[ax] = 1
    else:
        shape.pop(ax)
    return _simple("arg_max", "arg_max", x, tuple(shape),
                   {"axis": axis, "keepdims": keepdims}, dtype="int64",
                   stop_gradient=True)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    axis = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        sections = None
        sizes = [input.shape[axis] // n] * n if input.shape[axis] > 0 \
            else [-1] * n
    else:
        sections = list(num_or_sections)
        sizes = sections
        n = len(sections)
    outs = []
    for s in sizes:
        shape = list(input.shape)
        shape[axis] = s
        outs.append(helper.create_variable_for_type_inference(
            input.dtype, tuple(shape)))
    attrs = {"axis": axis}
    if sections:
        attrs["sections"] = sections
    else:
        attrs["num"] = n
    helper.append_op("split", {"X": [input]}, {"Out": outs}, attrs)
    return outs


def _elementwise_layer(op, x, y, axis, act, name):
    helper = LayerHelper(op, name=name, act=act)
    out_shape = x.shape if len(x.shape) >= len(y.shape) else y.shape
    out = helper.create_variable_for_type_inference(x.dtype, out_shape)
    helper.append_op(op, {"X": [x], "Y": [y]}, {"Out": [out]},
                     {"axis": axis})
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise_layer("elementwise_max", x, y, axis, act, name)


def reduce_sum(input, dim=None, keep_dim=False):
    shape = list(input.shape)
    if dim is None:
        out_shape = ()
    else:
        dims = [d % len(shape)
                for d in ([dim] if isinstance(dim, int) else dim)]
        if keep_dim:
            out_shape = tuple(1 if i in dims else s
                              for i, s in enumerate(shape))
        else:
            out_shape = tuple(s for i, s in enumerate(shape)
                              if i not in dims)
    return _simple("reduce_sum", "reduce_sum", input, out_shape,
                   {"dim": [dim] if isinstance(dim, int) else dim,
                    "keep_dim": keep_dim, "reduce_all": dim is None})


def mean(x, name=None):
    return _simple("mean", "mean", x, ())


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, smooth_epsilon=0.0):
    """Softmax cross entropy over the last dim: Loss [..., 1] (and the
    Softmax with `return_softmax`). `smooth_epsilon` > 0 with integer
    labels is label-smoothed CE in one op, never materializing the
    [..., K] targets."""
    if not numeric_stable_mode:
        raise NotImplementedError(
            "softmax_with_cross_entropy(numeric_stable_mode=False) is not "
            "ported: the op always computes in the stable form")
    helper = LayerHelper("softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(
        logits.dtype, tuple(logits.shape[:-1]) + (1,))
    sm = helper.create_variable_for_type_inference(logits.dtype,
                                                   logits.shape)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": [logits], "Label": [label]},
                     {"Loss": [loss], "Softmax": [sm]},
                     {"soft_label": soft_label, "ignore_index": ignore_index,
                      "smooth_epsilon": smooth_epsilon})
    if return_softmax:
        return loss, sm
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     {"X": [x], "Label": [label]}, {"Out": [out]},
                     {"ignore_index": ignore_index})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op("square_error_cost", {"X": [input], "Y": [label]},
                     {"Out": [out]}, {})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op("scale", {"X": [x]}, {"Out": [out]},
                     {"scale": float(scale), "bias": float(bias),
                      "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def multi_head_attention(queries, keys, values, attn_bias=None, d_key=64,
                         d_value=64, d_model=512, n_head=8,
                         dropout_rate=0.0, causal=False, param_attr=None,
                         name=None, *, use_flash=True, fused_qkv=None):
    """Transformer multi-head attention. q/k/v [B, T, d_model]; attn_bias
    broadcastable to [B, n_head, Tq, Tk]. fused_qkv projects q/k/v (or
    k/v, for cross attention) with one weight named `<name>_qkv`
    (`<name>_kv`); it is opt-in, as in the reference. Heads stay in the
    [B, T, H, Dh] layout: the attention op gets layout "bthd"."""
    if fused_qkv is None:
        fused_qkv = False
    if fused_qkv and param_attr is not None:
        raise ValueError(
            "fused_qkv shares one weight across q/k/v and cannot honor "
            "an explicit param_attr naming; pass fused_qkv=False")
    if fused_qkv and d_key == d_value and queries is keys \
            and keys is values:
        qkv = fc(queries, 3 * d_key * n_head, num_flatten_dims=2,
                 param_attr=param_attr, bias_attr=False,
                 name=f"{name}_qkv" if name else None)
        q, k, v = split(qkv, 3, dim=2)
    elif fused_qkv and d_key == d_value and keys is values:
        q = fc(queries, d_key * n_head, num_flatten_dims=2,
               param_attr=param_attr, bias_attr=False,
               name=f"{name}_q" if name else None)
        kv = fc(keys, 2 * d_key * n_head, num_flatten_dims=2,
                param_attr=param_attr, bias_attr=False,
                name=f"{name}_kv" if name else None)
        k, v = split(kv, 2, dim=2)
    else:
        if fused_qkv:
            import warnings
            warnings.warn(
                "fused_qkv=True requested but the fused projection needs "
                "d_key == d_value and q/k/v (or at least k/v) to be the "
                f"SAME tensor object (got d_key={d_key}, d_value="
                f"{d_value}); falling back to the UNFUSED per-projection "
                "weights", stacklevel=2)
        q = fc(queries, d_key * n_head, num_flatten_dims=2,
               param_attr=param_attr, bias_attr=False,
               name=f"{name}_q" if name else None)
        k = fc(keys, d_key * n_head, num_flatten_dims=2,
               param_attr=param_attr, bias_attr=False,
               name=f"{name}_k" if name else None)
        v = fc(values, d_value * n_head, num_flatten_dims=2,
               param_attr=param_attr, bias_attr=False,
               name=f"{name}_v" if name else None)
    q = reshape(q, [0, 0, n_head, d_key])
    k = reshape(k, [0, 0, n_head, d_key])
    v = reshape(v, [0, 0, n_head, d_value])
    helper = LayerHelper("multi_head_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype, q.shape)
    wshape = (q.shape[0], n_head, q.shape[1], k.shape[1])
    wvar = helper.create_variable_for_type_inference(q.dtype, wshape, True)
    ins = {"Q": [q], "K": [k], "V": [v]}
    if attn_bias is not None:
        ins["Mask"] = [attn_bias]
    helper.append_op(
        "flash_attention" if use_flash else "scaled_dot_product_attention",
        ins, {"Out": [out], "Weights": [wvar]},
        {"causal": causal, "scale": d_key ** -0.5, "layout": "bthd"})
    out = reshape(out, [0, 0, n_head * d_value])
    if dropout_rate:
        out = dropout(out, dropout_rate,
                      dropout_implementation="upscale_in_train")
    return fc(out, d_model, num_flatten_dims=2, param_attr=param_attr,
              bias_attr=False, name=f"{name}_o" if name else None)


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _simple("add_position_encoding", "add_position_encoding", input,
                   input.shape, {"alpha": alpha, "beta": beta})
