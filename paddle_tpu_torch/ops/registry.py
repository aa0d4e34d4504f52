"""Op kernel registry (counterpart of `paddle_tpu/ops/registry.py`:
`kernel`, `get_kernel`, `KernelCtx`, `KERNELS` and `accel`).

Each op type maps to one torch function

    fn(ctx, ins: {slot: [Tensor]}, attrs: dict) -> {slot: [Tensor]}

and programs stay serializable because operators carry only the type
string. `ctx` (KernelCtx) gives the op its device, the executor's mode
(`is_test`), its seed (`generator()` builds a `torch.Generator` on the
device seeded from the program seed and the op's index) and the
hand-written-kernel seam `accel`.

`accel(op_type)` is where the layer_norm and flash_attention ops reach
their Hopper kernels: for "layer_norm" and "flash_attention" it returns the `try_*` entry of
`ops/kern/layer_norm.py` / `ops/kern/flash_attention.py`; each runs
the kernel's wrapper (the CUDA kernel on the card, its plain version on
the CPU) or returns None when the shapes fail the kernel's static check
(`supports`), and the op then runs its composition. A caught exception
never decides it. The `fused_embedding_seq_pool` op and the sharded
engine (parallel/sparse.py) call `ops/kern/embedding.lookup_pool`
directly: their inputs are always 2-D, so a static check has nothing
to reject. The reference's `PADDLE_TPU_KERN` switch, which turns
every kernel off, is not ported: the port has no switch that turns a
kernel off. `has_kernel`, `autocast` (AMP) and `closest_kernels` are
not ported either.
"""

import torch

__all__ = ["kernel", "get_kernel", "KernelCtx", "KERNELS", "accel"]

KERNELS = {}


def accel(op_type):
    """The `try_*` callable of the hand-written kernel for `op_type`, or
    None when the port has none."""
    if op_type == "layer_norm":
        from .kern.layer_norm import try_layer_norm
        return try_layer_norm
    if op_type == "flash_attention":
        from .kern.flash_attention import try_flash
        return try_flash
    return None


class KernelCtx:
    def __init__(self, seed=0, is_test=False, device=None, accel=accel):
        self.seed = seed
        self.is_test = is_test
        self.device = device
        self.accel = accel

    def generator(self):
        """A fresh `torch.Generator` on this op's device, seeded from
        (program seed, op index): the same numbers on every run of the
        op, other numbers for every other op."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        return g


def kernel(*types):
    """Decorator registering fn under one or more op type names."""
    def deco(fn):
        for t in types:
            if t in KERNELS:
                raise ValueError(f"duplicate kernel registration: {t}")
            KERNELS[t] = fn
        return fn
    return deco


def get_kernel(type):
    fn = KERNELS.get(type)
    if fn is None:
        raise NotImplementedError(
            f"no kernel registered for op type {type!r} in the port "
            f"(registered: {sorted(KERNELS)})")
    return fn

