"""append_backward, the gradient section of a Program (counterpart of
`paddle_tpu/core/backward.py`: `append_backward` :14).

As in the reference, one `backward_macro` op marks the boundary between
the forward ops and the update ops; `core/trace.py` runs the forward
under `torch.autograd` and takes every gradient at once. The op carries
the reference's attrs (`param_names`, `loss_name`, `sparse_params`,
`is_backward_op`), so the two packages build equal programs.

Parameters split as in the reference (:56-129): a table whose every
consumer is an `is_sparse` lookup tap (`layers.embedding(is_sparse=
True)`) gets row gradients, one `<delta>@GRAD` variable per tap of the
gathered shape, listed in `sparse_params` as {"param", "taps": [{"ids",
"delta", "grad"}]}; every other parameter gets a dense gradient. A table
also read by another op stays dense, with a warning, and its
`_sparse_lookup` is cleared so the optimizer treats it as dense too.
`grad_sync` (the parallel slice) and `callbacks` raise
NotImplementedError. Left out: `gradients`.
"""
import warnings

import numpy as np

from .framework import grad_var_name

__all__ = ["append_backward"]


def _only_sparse_consumers(program, p):
    """True when every op reading `p` (the backward macro aside) reads
    it as the table of an is_sparse lookup with a delta tap."""
    for blk in program.blocks:
        for op in blk.ops:
            if op.type == "backward_macro":
                continue
            for slot, names in op.inputs.items():
                if p.name not in names:
                    continue
                if not (op.attrs.get("is_sparse") and slot == "W"
                        and op.inputs.get("SparseDelta")):
                    return False
    return True


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, grad_sync=None):
    """Append the backward section for the scalar `loss`; returns
    [(param, grad_var)] for every trainable parameter (or those in
    `parameter_list`) not in `no_grad_set`: the dense ones first, then
    each row-sparse table with its first tap's row-gradient var."""
    if grad_sync is not None:
        raise NotImplementedError(
            "append_backward(grad_sync=...) belongs to the port's "
            "parallel slice, which is not ported yet")
    if callbacks is not None:
        raise NotImplementedError("append_backward(callbacks=...) is not "
                                  "ported")
    program = loss.block.program
    block = program.global_block()
    no_grad = {n.name if hasattr(n, "name") else n
               for n in (no_grad_set or ())}
    if parameter_list:
        params = [block.var(p.name if hasattr(p, "name") else p)
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]
    params = [p for p in params if p.name not in no_grad]
    if not params:
        raise ValueError("append_backward: no trainable parameters found")
    loss_elems = int(np.prod(loss.shape)) if loss.shape else 1
    if loss_elems not in (0, 1):
        raise ValueError(
            f"loss {loss.name!r} has shape {loss.shape}; reduce it to a "
            f"scalar (e.g. layers.mean) before minimize/append_backward")

    dense, sparse = [], []
    for p in params:
        if not getattr(p, "_sparse_lookup", None):
            dense.append(p)
        elif _only_sparse_consumers(program, p):
            sparse.append(p)
        else:
            warnings.warn(
                f"parameter {p.name!r} has is_sparse lookups but is "
                "also consumed by other ops; falling back to DENSE "
                "gradients/updates so no contribution is lost")
            p._sparse_lookup = None
            dense.append(p)

    pnames = [p.name for p in dense]
    gnames = [grad_var_name(n) for n in pnames]
    for p, g in zip(dense, gnames):
        block.create_var(name=g, shape=p.shape, dtype=p.dtype,
                         stop_gradient=True)
    sparse_specs, sparse_gnames = [], []
    for p in sparse:
        taps = []
        for tap in p._sparse_lookup:
            dvar = block.var(tap["delta"])
            gname = grad_var_name(tap["delta"])
            block.create_var(name=gname, shape=dvar.shape,
                             dtype=dvar.dtype, stop_gradient=True)
            taps.append({"ids": tap["ids"], "delta": tap["delta"],
                         "grad": gname})
            sparse_gnames.append(gname)
        sparse_specs.append({"param": p.name, "taps": taps})
    block.append_op(
        type="backward_macro",
        inputs={"Loss": [loss.name]},
        outputs={"Grads": gnames + sparse_gnames},
        attrs={"param_names": pnames, "loss_name": loss.name,
               "sparse_params": sparse_specs, "is_backward_op": True})
    program._backward_sections.append(
        {"loss": loss.name, "params": pnames + [p.name for p in sparse]})
    pairs = [(p, block.var(g)) for p, g in zip(dense, gnames)]
    pairs += [(p, block.var(grad_var_name(p._sparse_lookup[0]["delta"])))
              for p in sparse]
    return pairs
