"""Admission-control vocabulary of the serving tier (counterpart of
`paddle_tpu/serving/batcher.py:42-158`; only the error classes and
`Future` — the dynamic batcher itself is not part of this slice)."""
import threading
import time

__all__ = ["Future", "RejectedError", "DeadlineExceeded", "ServerClosed",
           "PreemptedError", "CancelledError"]


class RejectedError(RuntimeError):
    """Request refused by admission control (queue full / oversized)."""


class ServerClosed(RejectedError):
    """Request refused because the server is draining or stopped."""


class DeadlineExceeded(RejectedError):
    """Request deadline expired before a result was produced."""


class PreemptedError(RejectedError):
    """Request evicted from its decode slot by a QoS admission in
    favor of a tenant below its fair share (HTTP 429: retry — the
    service is up, this tenant is just over its share right now).
    Lives here with the rest of the admission-control vocabulary so
    the HTTP layer never has to import the decode package."""


class CancelledError(RejectedError):
    """Request cancelled by the caller side — normally the losing leg
    of a hedged request after the other replica already delivered.
    Clients never see this; it resolves the abandoned future so
    nothing blocks on it forever."""


class Future:
    """Caller-side handle for one queued request."""

    __slots__ = ("_event", "_result", "_error", "_deadline")

    def __init__(self, deadline):
        self._event = threading.Event()
        self._result = None
        self._error = None
        self._deadline = deadline          # monotonic seconds or None

    def done(self):
        return self._event.is_set()

    def set_result(self, result):
        self._result = result
        self._event.set()

    def set_error(self, exc):
        self._error = exc
        self._event.set()

    def result(self, timeout=None):
        """Block for the fetch rows. Respects the request deadline:
        waiting never outlives it by more than a scheduling tick."""
        wait = timeout
        if self._deadline is not None:
            to_deadline = max(0.0, self._deadline - time.monotonic())
            # small grace so a worker that *just* made the deadline can
            # still deliver instead of racing the waiter
            to_deadline += 0.05
            wait = to_deadline if wait is None else min(wait, to_deadline)
        if not self._event.wait(wait):
            if self._deadline is not None \
                    and time.monotonic() >= self._deadline:
                raise DeadlineExceeded("request deadline expired while "
                                       "waiting for a worker")
            raise TimeoutError("timed out waiting for result")
        if self._error is not None:
            raise self._error
        return self._result
