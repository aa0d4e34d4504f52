"""append_backward, the gradient section of a Program (counterpart of
`paddle_tpu/core/backward.py`: `append_backward` :14).

As in the reference, one `backward_macro` op marks the boundary between
the forward ops and the update ops; `core/trace.py` runs the forward
under `torch.autograd` and takes every gradient at once. The op carries
the reference's attrs (`param_names`, `loss_name`, `sparse_params`,
`is_backward_op`), so the two packages build equal programs.

Dense parameters only: the port's `embedding` refuses `is_sparse`, so
no parameter needs the reference's row-sparse partition (the sparse
slice). `grad_sync` (the parallel slice) and `callbacks` raise
NotImplementedError. Left out: `gradients`.
"""
import numpy as np

from .framework import grad_var_name

__all__ = ["append_backward"]


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, grad_sync=None):
    """Append the backward section for the scalar `loss`; returns
    [(param, grad_var)] for every trainable parameter (or those in
    `parameter_list`) not in `no_grad_set`."""
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

    pnames = [p.name for p in params]
    gnames = [grad_var_name(n) for n in pnames]
    for p, g in zip(params, gnames):
        block.create_var(name=g, shape=p.shape, dtype=p.dtype,
                         stop_gradient=True)
    block.append_op(
        type="backward_macro",
        inputs={"Loss": [loss.name]},
        outputs={"Grads": gnames},
        attrs={"param_names": pnames, "loss_name": loss.name,
               "sparse_params": [], "is_backward_op": True})
    program._backward_sections.append({"loss": loss.name,
                                       "params": pnames})
    return [(p, block.var(g)) for p, g in zip(params, gnames)]
