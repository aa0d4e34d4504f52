"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`, for one
NVIDIA H100 (counterpart of `paddle_tpu/__init__.py`).

The port grows slice by slice beside the JAX package, which stays the
reference: `paddle_tpu_torch/<path>.py` ports `paddle_tpu/<path>.py`.
The port imports `torch` and numpy, never `jax` and nothing of
`paddle_tpu`. It serves Transformer-base greedy decode through the
continuous-batching scheduler, with an fp32 or an int8 KV cache:

    serving.decode.ContinuousScheduler -> serving.decode.DecodeEngine
      -> models.transformer.IncrementalDecoder
      -> ops.kern.decode_attention.decode_attend (CUDA, sm_90a), or
         ops.kern.quant.quantize_int8_blockwise and
         ops.kern.decode_attention.dequant_attend (CUDA, sm_90a)

and runs Fluid programs built with its own front-end (`core.framework`,
`layers`, `layer_helper`, `initializer`) through its Executor:

    models.transformer.build_infer_program / greedy_decode
      -> core.executor.Executor.run -> core.trace (op by op, eagerly)
      -> ops.registry op kernels (ops.kernels_math, kernels_tensor,
         kernels_nn), of which layer_norm and flash_attention launch
         ops.kern.layer_norm and ops.kern.flash_attention (CUDA, sm_90a)

with training (`optimizer.SGD` / `Adam` `minimize`: the forward under
autograd, then the update ops), and trains DeepFM with row-sparse
tables through that Executor or through the sharded embedding engine
on one card:

    models.deepfm.build_program(is_distributed=True)
      -> parallel.ParallelExecutor(sparse="shard").run
      -> parallel.sparse.SparseEngine (dedup, exchange, row updates)
      -> ops.kern.embedding.lookup_pool (CUDA, sm_90a)

Entry points run on the card unless the caller passes ``device="cpu"``
(an Executor: ``CPUPlace()``; a ParallelExecutor: ``use_cuda=False``);
without CUDA and without an explicit CPU device they raise.
"""
__version__ = "0.1.0"
