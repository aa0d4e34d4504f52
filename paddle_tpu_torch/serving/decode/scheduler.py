"""Continuous (iteration-level) batching scheduler (counterpart of
`paddle_tpu/serving/decode/scheduler.py`, without its telemetry and
chaos hooks).

Every decode **step** is a scheduling opportunity:

    retire   slots whose request hit eos / its token budget / its
             deadline / a cancel (the row is free *this* iteration);
    admit    queued requests into the freed rows, picked by weighted
             fair queuing (`qos.QosPolicy`), prefilled in row buckets;
    step     ONE step over all `num_slots` rows; only [num_slots] token
             ids come back to the host.

Admission control: a bounded queue (fast `RejectedError` on overload),
per-request deadlines (`DeadlineExceeded`), QoS preemption
(`PreemptedError`) and cancellation (`CancelledError`).

The loop thread is supervised: a crash fails the in-flight requests,
returns every slot to the pool and respawns the loop. Tests can skip
the thread: construct, `submit`, and call `run_iteration()` by hand.
"""
import logging
import threading
import time

import numpy as np

from ..batcher import (CancelledError, DeadlineExceeded, Future,
                       PreemptedError, RejectedError, ServerClosed)
from .qos import QosPolicy
from .slots import SlotPool

_LOG = logging.getLogger("paddle_tpu_torch.serving.decode")

__all__ = ["DecodeConfig", "DecodeRequest", "DecodeResult",
           "ContinuousScheduler"]


class DecodeConfig:
    def __init__(self, max_queue_requests=256, default_deadline_ms=None,
                 default_max_new_tokens=None, bos=0, eos=None,
                 idle_wait_s=0.05):
        self.max_queue_requests = int(max_queue_requests)
        self.default_deadline_ms = default_deadline_ms
        self.default_max_new_tokens = default_max_new_tokens
        self.bos = int(bos)
        self.eos = eos if eos is None else int(eos)
        self.idle_wait_s = float(idle_wait_s)


class DecodeRequest:
    __slots__ = ("src", "src_len", "tenant", "max_new_tokens",
                 "deadline", "enqueue_t", "future", "cancelled")

    def __init__(self, src, src_len, tenant, max_new_tokens, deadline):
        self.src = src
        self.src_len = src_len
        self.tenant = tenant
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline           # monotonic seconds or None
        self.enqueue_t = time.monotonic()
        self.future = Future(deadline)
        # set by cancel(): the iteration loop retires the slot (it is
        # the slot pool's single writer; cancel never frees directly)
        self.cancelled = False

    def expired(self, now):
        return self.deadline is not None and now >= self.deadline


class DecodeResult:
    """What a decode future resolves to."""

    __slots__ = ("tokens", "finish_reason", "tenant", "ttft_s",
                 "decode_s")

    def __init__(self, tokens, finish_reason, tenant, ttft_s, decode_s):
        self.tokens = tokens                # np.int32 [n_generated]
        self.finish_reason = finish_reason  # "eos" | "length"
        self.tenant = tenant
        self.ttft_s = ttft_s
        self.decode_s = decode_s

    def __repr__(self):
        return (f"DecodeResult({len(self.tokens)} tokens, "
                f"{self.finish_reason!r}, tenant={self.tenant!r})")


class ContinuousScheduler:
    """Continuous-batching decode over one `DecodeEngine`."""

    def __init__(self, engine, qos=None, config=None, name="decoder",
                 warmup=True):
        self.engine = engine
        self.qos = qos or QosPolicy()
        self.config = config or DecodeConfig()
        self.name = name
        self.pool = SlotPool(engine.num_slots)
        self.state = engine.init_state()
        # host mirrors of the per-slot decode cursor; free slots hold 0
        self._ids = np.zeros(engine.num_slots, np.int64)
        self._pos = np.zeros(engine.num_slots, np.int64)
        self._queues = {}            # tenant -> list of DecodeRequest
        self._queued = 0
        self._cond = threading.Condition()
        self._closed = False
        self._thread = None
        self._iteration = 0
        self._started = False
        self.restarts = 0
        self.preemptions = 0
        self.tokens_generated = 0
        if warmup:
            engine.warmup()

    # ------------------------------------------------------ caller side
    def submit(self, src, src_len=None, tenant="default",
               max_new_tokens=None, deadline_ms=None):
        """Enqueue one sequence; returns a Future resolving to a
        `DecodeResult`. Sheds immediately on a full queue or an
        oversized source (RejectedError)."""
        src = np.asarray(src, np.int64).reshape(-1)
        if src_len is None:
            src_len = len(src)
        src_len = int(src_len)
        if len(src) > self.engine.src_max_len:
            raise RejectedError(
                f"source of {len(src)} tokens exceeds the decode "
                f"tier's src_max_len {self.engine.src_max_len}")
        cap = self.engine.max_new_tokens
        if max_new_tokens is None:
            max_new_tokens = self.config.default_max_new_tokens or cap
        max_new_tokens = max(1, min(int(max_new_tokens), cap))
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        deadline = None if deadline_ms is None \
            else time.monotonic() + float(deadline_ms) / 1e3
        tenant = str(tenant)
        self.qos.tenant(tenant)        # strict mode rejects here
        req = DecodeRequest(src, src_len, tenant, max_new_tokens,
                            deadline)
        with self._cond:
            if self._closed:
                raise ServerClosed("decoder is draining; not "
                                   "accepting new requests")
            if self._queued >= self.config.max_queue_requests:
                raise RejectedError(
                    f"decode queue full "
                    f"({self.config.max_queue_requests} requests); "
                    f"retry later")
            backlogged = [t for t, q in self._queues.items() if q]
            if tenant not in backlogged:
                self.qos.on_backlogged(
                    tenant, backlogged
                    + list(self.pool.held_by_tenant()))
            self._queues.setdefault(tenant, []).append(req)
            self._queued += 1
            self._cond.notify()
        return req.future

    def decode(self, src, timeout=None, **kw):
        """Blocking convenience: submit + wait -> DecodeResult."""
        return self.submit(src, **kw).result(timeout=timeout)

    def cancel(self, future):
        """Best-effort cancellation of the request behind `future`. A
        queued request is removed and failed with CancelledError here;
        an admitted one is only flagged, and the iteration loop (the
        slot pool's single writer) retires it. Returns True when the
        request was still pending."""
        with self._cond:
            for q in self._queues.values():
                for req in q:
                    if req.future is future:
                        q.remove(req)
                        self._queued -= 1
                        req.future.set_error(CancelledError(
                            "cancelled while queued"))
                        return True
        slot = self.pool.find(future)
        if slot is not None:
            req = slot.request      # snapshot: loop may retire it
            if req is not None:
                req.cancelled = True
                return True
        return False

    # ------------------------------------------------------- iteration
    def run_iteration(self):
        """One retire/admit/step cycle. Returns the number of active
        slots stepped (0 = nothing to do). Single-threaded by
        contract: either the started loop thread calls this, or a
        test drives it by hand — never both."""
        now = time.monotonic()
        self._retire_deadlines(now)
        self._drop_expired_queued(now)
        self._admit()
        return self._step_active()

    def _retire_deadlines(self, now):
        for slot in self.pool.active():
            req = slot.request
            if req.cancelled:
                if not req.future.done():
                    req.future.set_error(CancelledError(
                        f"cancelled after {len(slot.tokens)} "
                        f"generated tokens; slot reclaimed"))
                self._finish_slot(slot)
                continue
            if req.expired(now):
                req.future.set_error(DeadlineExceeded(
                    f"deadline expired after {len(slot.tokens)} "
                    f"generated tokens"))
                self._finish_slot(slot)

    def _drop_expired_queued(self, now):
        with self._cond:
            for tenant, q in self._queues.items():
                live = []
                for req in q:
                    if req.expired(now):
                        req.future.set_error(DeadlineExceeded(
                            "deadline expired in decode queue"))
                        self._queued -= 1
                    else:
                        live.append(req)
                self._queues[tenant] = live

    def _admit(self):
        """Fill free slots from the queues by WFQ; preempt if allowed
        and somebody is starving below their fair share."""
        batch, slots = [], []
        while True:
            with self._cond:
                queued = [t for t, q in self._queues.items() if q]
                if not queued:
                    break
                held = self.pool.held_by_tenant()
                if self.pool.free_count() == 0:
                    victim_slot = self._pick_preemption(queued, held)
                    if victim_slot is None:
                        break
                    self._preempt(victim_slot)
                    held = self.pool.held_by_tenant()
                tenant = self.qos.pick_tenant(queued, held)
                if tenant is None:
                    break
                req = self._queues[tenant].pop(0)
                self._queued -= 1
            # WFQ charge at admission (the request's reserved token
            # budget); unconsumed budget is refunded at retirement
            self.qos.charge(tenant, req.max_new_tokens)
            slot = self.pool.alloc(req, self._iteration)
            self._ids[slot.index] = self.config.bos
            self._pos[slot.index] = 0
            batch.append(req)
            slots.append(slot.index)
        if batch:
            self.state = self.engine.admit(self.state, batch, slots)

    def _pick_preemption(self, queued, held):
        starved = self.qos.pick_tenant(queued, held)
        victim = self.qos.preemption_victim(
            starved, queued, held, self.pool.num_slots)
        if victim is None:
            return None
        cands = [s for s in self.pool.active()
                 if s.request.tenant == victim]
        if not cands:
            return None
        # evict the youngest slot: least generated work destroyed
        return max(cands, key=lambda s: (s.joined_iter, s.index))

    def _preempt(self, slot):
        slot.request.future.set_error(PreemptedError(
            f"preempted after {len(slot.tokens)} generated tokens to "
            f"admit a tenant below its fair share; retry"))
        self._finish_slot(slot)
        self.preemptions += 1

    def _step_active(self):
        active = self.pool.active()
        if not active:
            return 0
        self._iteration += 1
        nxt = self.engine.step(self.state, self._ids, self._pos,
                               seed=self._iteration)
        now = time.monotonic()
        eos = self.config.eos
        for slot in active:
            req = slot.request
            tok = int(nxt[slot.index])
            if slot.first_token_t is None:
                slot.first_token_t = now
            slot.tokens.append(tok)
            self.tokens_generated += 1
            if eos is not None and tok == eos:
                self._deliver(slot, "eos", now)
            elif len(slot.tokens) >= req.max_new_tokens:
                self._deliver(slot, "length", now)
            else:
                self._ids[slot.index] = tok
                self._pos[slot.index] += 1
        return len(active)

    def _deliver(self, slot, reason, now):
        req = slot.request
        req.future.set_result(DecodeResult(
            tokens=np.asarray(slot.tokens, np.int32),
            finish_reason=reason, tenant=req.tenant,
            ttft_s=(slot.first_token_t - req.enqueue_t
                    if slot.first_token_t else None),
            decode_s=now - slot.joined_t))
        self._finish_slot(slot)

    def _finish_slot(self, slot):
        req = slot.request
        unused = req.max_new_tokens - len(slot.tokens or ())
        if unused > 0:
            self.qos.refund(req.tenant, unused)
        self.pool.release(slot)
        self._ids[slot.index] = 0
        self._pos[slot.index] = 0

    # ------------------------------------------------------- lifecycle
    def start(self):
        """Spawn the supervised decode loop thread."""
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                self._spawn(None)
        return self

    def _spawn(self, prev):
        # under self._cond, so stop() never reads a missing or stale loop
        self._started = True
        self._thread = threading.Thread(
            target=self._loop_guarded, args=(prev,),
            name=f"ptt-decode-{self.name}", daemon=True)
        self._thread.start()

    def _loop_guarded(self, prev):
        if prev is not None:
            # the crashed loop ends before its successor runs, so
            # joining the newest loop joins every loop
            prev.join()
        try:
            self._loop()
        except BaseException as e:      # noqa: BLE001 — thread death
            if self._closed:
                return
            self._crash_recover(e)
            self.restarts += 1
            _LOG.warning(
                "decode loop %s died (%s: %s) — slots reclaimed, "
                "restarting", self.name, type(e).__name__, e)
            with self._cond:
                self._spawn(threading.current_thread())

    def _loop(self):
        while True:
            stepped = self.run_iteration()
            if stepped:
                continue
            with self._cond:
                if self._closed and self._queued == 0 \
                        and self.pool.active_count() == 0:
                    return
                # nothing active and nothing admissible: park until a
                # submit notifies (bounded, so close is re-checked)
                self._cond.wait(self.config.idle_wait_s)

    def _crash_recover(self, exc):
        """Leak-free crash cleanup: every bound slot's request fails
        with the crash error and its row returns to the pool; queued
        requests stay queued for the respawned loop."""
        for slot in self.pool.active():
            if not slot.request.future.done():
                slot.request.future.set_error(exc)
            self._finish_slot(slot)
        self.pool.check()

    def stop(self, drain=True, timeout=30.0):
        """Stop admitting; optionally let the loop drain queued +
        in-flight work before joining."""
        with self._cond:
            self._closed = True
            if not drain:
                for q in self._queues.values():
                    for req in q:
                        req.future.set_error(ServerClosed(
                            "decoder shut down before this request "
                            "ran"))
                    q.clear()
                self._queued = 0
            self._cond.notify_all()
        # a loop that crashes while we wait spawns a successor: join
        # whichever loop is newest until it stays the same
        deadline = time.monotonic() + timeout
        t = None
        while True:
            with self._cond:
                newest = self._thread
            if newest is None or newest is t:
                break
            t = newest
            t.join(max(0.0, deadline - time.monotonic()))
        if not drain:
            for slot in self.pool.active():
                slot.request.future.set_error(ServerClosed(
                    "decoder shut down mid-generation"))
                self._finish_slot(slot)

    @property
    def queued(self):
        with self._cond:
            return self._queued

    @property
    def alive(self):
        """False once a started loop has ended without a successor (a
        crashed loop respawns before it ends). A scheduler that was
        never started is driven by hand — always alive."""
        if not self._started:
            return True
        t = self._thread
        return t is not None and t.is_alive()
