"""Hand-written Hopper kernels (counterpart of `paddle_tpu/ops/kern/`).

Each kernel module holds the wrapper that launches the CUDA kernel for
CUDA tensors, its plain PyTorch version (taken for CPU tensors only),
and counts its launches in `LAUNCHES`, keyed by the wrapper's name.
Sources live in `paddle_tpu_torch/csrc/` and are built at first use by
`_build`."""
import torch

# kernel launches per wrapper; the plain versions never count
LAUNCHES = {"decode_attend": 0, "dequant_attend": 0,
            "quantize_int8_blockwise": 0, "layer_norm": 0,
            "flash_attention": 0}


def launch(name, fn, device, *args):
    """Call the C entry point `fn(*args, stream)` on `device`'s current
    stream; raise if it reports a CUDA error, else count one launch of
    kernel `name`."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
