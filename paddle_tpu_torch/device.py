"""Device resolution for the port (counterpart of
`paddle_tpu/core/place.py`).

The JAX package resolves a Place to a jax device and falls back to the
CPU when no accelerator is found. The port does not fall back: the card
is the default, the CPU is used only when the caller asks for it, and a
missing card raises.
"""
import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """`None` -> the current CUDA device (raises without CUDA);
    ``"cpu"`` / ``"cuda[:i]"`` / a `torch.device` -> itself, after
    checking that it exists. Returns a `torch.device`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # the JAX reference computes fp32 matmuls in full fp32; TF32
        # would keep ~3 decimal digits and break logit parity, so the
        # entry points turn it off for both cuBLAS and cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
