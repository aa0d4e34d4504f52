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
            "layer_norm_bwd": 0, "flash_attention": 0,
            "flash_attention_dq": 0, "flash_attention_dkv": 0,
            "lookup_pool": 0}


def on_cpu(tensors, name):
    """True when every tensor of `tensors` ((name, tensor) pairs) lies
    on the CPU, False when all lie on one CUDA device; raises for any
    other mix, so a non-CPU tensor never reaches a plain version."""
    devs = {t.device for _n, t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name} takes all-CPU or all-CUDA tensors; got "
                         + ", ".join(f"{n} on {t.device}"
                                     for n, t in tensors))
    return False


def launch(name, fn, device, *args):
    """Call the C entry point `fn(*args, stream)` on `device`'s current
    stream; raise if it reports a CUDA error, else count one launch of
    kernel `name`."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
