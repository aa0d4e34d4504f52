"""paddle_tpu_torch.serving.decode — continuous-batching autoregressive
decode over a static-shape KV-cache slot pool with multi-tenant QoS
(counterpart of `paddle_tpu/serving/decode/__init__.py`).

- `DecodeEngine` (engine.py): bucketed prefill plus one single-token
  step over a ``[num_slots, T_max, heads, dim]`` KV cache, around
  `models.transformer.IncrementalDecoder`.
- `SlotPool` (slots.py): host bookkeeping for the static decode batch.
- `ContinuousScheduler` (scheduler.py): per-iteration retire / admit /
  step with bounded-queue admission control and a supervised loop.
- `QosPolicy` (qos.py): weighted-fair-queuing admission classes with
  optional fair-share preemption.
"""
from .engine import DecodeEngine, DecodeEngineConfig
from .qos import QosPolicy, TenantClass
from .scheduler import (ContinuousScheduler, DecodeConfig,
                        DecodeRequest, DecodeResult)
from .slots import Slot, SlotPool
from ..batcher import PreemptedError

__all__ = ["DecodeEngine", "DecodeEngineConfig", "QosPolicy",
           "TenantClass", "ContinuousScheduler", "DecodeConfig",
           "DecodeRequest", "DecodeResult", "Slot", "SlotPool",
           "PreemptedError"]
