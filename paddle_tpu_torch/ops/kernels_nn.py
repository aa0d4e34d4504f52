"""Neural-network helpers of the port's serving path (counterpart of
`paddle_tpu/ops/kernels_nn.py`; only `_attn_softmax`, forward only —
serving needs no gradient)."""
import torch

__all__ = ["_attn_softmax"]


def _attn_softmax(logits):
    """Softmax over the last dim with f32 internals, returned in the
    logits' own dtype (`paddle_tpu/ops/kernels_nn.py:741`). A fully
    masked row (max -inf) gets a finite shift of 0, as in the
    reference."""
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp((logits - m).float())
    return (e / e.sum(dim=-1, keepdim=True)).to(logits.dtype)
