"""paddle_tpu_torch.serving — the serving tier of the port (counterpart
of `paddle_tpu/serving/__init__.py`). This slice ports the continuous
decode tier (`serving.decode`) and the admission-control vocabulary it
raises; the model server, HTTP frontend, farm, guard and autoscaler
follow in later slices."""
from .batcher import (CancelledError, DeadlineExceeded, Future,
                      PreemptedError, RejectedError, ServerClosed)

__all__ = ["Future", "RejectedError", "DeadlineExceeded",
           "PreemptedError", "ServerClosed", "CancelledError"]
