"""Hand-written Hopper kernels (counterpart of `paddle_tpu/ops/kern/`).

Each kernel module holds the wrapper that launches the CUDA kernel for
CUDA tensors, its plain PyTorch version (taken for CPU tensors only),
and a launch count. Sources live in `paddle_tpu_torch/csrc/` and are
built at first use by `_build`."""
