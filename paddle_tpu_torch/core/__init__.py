"""The port's core (counterpart of `paddle_tpu/core/`): the Program IR
(`framework`), places, the scope, the op-by-op tracer and the
Executor."""
