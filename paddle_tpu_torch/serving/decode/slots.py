"""Slot pool: host-side bookkeeping for the static decode batch
(counterpart of `paddle_tpu/serving/decode/slots.py`, unchanged).

The device side of tpudecode is a fixed `[num_slots, ...]` KV-cache
(see `models.transformer.IncrementalDecoder`); this module tracks which
of those rows currently belongs to which request. Joining the batch is
`alloc` + a device scatter of the prefilled caches; leaving is `free` —
no reshape, no recompile, ever.

The pool is deliberately paranoid about leaks: a slot row that is
neither free nor bound to a live request is serving capacity silently
lost forever (the moral equivalent of a leaked file descriptor), so
`check()` asserts the partition invariant and the chaos test drives it
across injected scheduler crashes.
"""
import time

__all__ = ["Slot", "SlotPool"]


class Slot:
    """One row of the decode batch, bound to at most one request."""

    __slots__ = ("index", "request", "tokens", "joined_iter",
                 "joined_t", "first_token_t")

    def __init__(self, index):
        self.index = index
        self.request = None
        self.tokens = None          # generated token ids (host list)
        self.joined_iter = -1
        self.joined_t = 0.0
        self.first_token_t = None

    @property
    def busy(self):
        return self.request is not None

    def bind(self, request, iteration):
        self.request = request
        self.tokens = []
        self.joined_iter = iteration
        self.joined_t = time.monotonic()
        self.first_token_t = None

    def clear(self):
        self.request = None
        self.tokens = None
        self.joined_iter = -1
        self.first_token_t = None


class SlotPool:
    """Fixed set of `num_slots` slots; free-list allocation.

    Not thread-safe by itself — the continuous scheduler is the single
    writer (its iteration loop owns admit/retire); everyone else reads
    coarse counters.
    """

    def __init__(self, num_slots):
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self._slots = [Slot(i) for i in range(self.num_slots)]
        self._free = list(range(self.num_slots - 1, -1, -1))

    # ------------------------------------------------------ allocation
    def free_count(self):
        return len(self._free)

    def active_count(self):
        return self.num_slots - len(self._free)

    def alloc(self, request, iteration):
        """Bind `request` to a free slot; raises IndexError when full
        (callers gate on free_count)."""
        idx = self._free.pop()
        slot = self._slots[idx]
        slot.bind(request, iteration)
        return slot

    def release(self, slot):
        """Return a slot to the free list (idempotence is a bug: a
        double free would hand one row to two requests)."""
        if not slot.busy and slot.index in self._free:
            raise RuntimeError(f"double free of slot {slot.index}")
        slot.clear()
        self._free.append(slot.index)

    # ------------------------------------------------------ inspection
    def active(self):
        """Busy slots in index order (deterministic iteration)."""
        return [s for s in self._slots if s.busy]

    def slot(self, index):
        return self._slots[index]

    def find(self, future):
        """The busy slot whose bound request resolves `future`, or
        None (the cancel path's lookup; also the hedge-leak tests')."""
        for s in self._slots:
            r = s.request        # snapshot: callers read cross-thread
            if r is not None and r.future is future:
                return s
        return None

    def held_by_tenant(self):
        held = {}
        for s in self._slots:
            r = s.request        # snapshot: submit() reads cross-thread
            if r is not None:
                held[r.tenant] = held.get(r.tenant, 0) + 1
        return held

    def occupancy(self):
        return self.active_count() / self.num_slots

    def check(self):
        """Assert the free/busy partition invariant; returns True or
        raises (the slot-leak acid test after injected crashes)."""
        free = set(self._free)
        busy = {s.index for s in self._slots if s.busy}
        if free & busy or len(free) + len(busy) != self.num_slots \
                or len(free) != len(self._free):
            raise RuntimeError(
                f"slot pool corrupt: free={sorted(free)} "
                f"busy={sorted(busy)} of {self.num_slots}")
        return True
