"""Optimizer-update op kernels (counterpart of
`paddle_tpu/ops/kernels_optim.py`: `adam` :44; every other update and
metric op is not ported).

An update op names the same variables as its inputs and outputs (the
parameter and its accumulators); the Executor writes the outputs back
to the scope. The moments and the update run in float32 whatever the
parameter's dtype, in the reference's order of operations.
"""
import torch

from .registry import kernel


def _lr(ins):
    return ins["LearningRate"][0].float().reshape(())


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
