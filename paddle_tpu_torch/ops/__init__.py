"""Operators of the port (counterpart of `paddle_tpu/ops/`): plain
PyTorch functions on tensors, and under `kern/` the hand-written CUDA
kernels with their plain versions beside them."""
