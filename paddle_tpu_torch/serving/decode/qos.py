"""Multi-tenant QoS: weighted-fair-queuing admission over decode slots
(counterpart of `paddle_tpu/serving/decode/qos.py`, without the
`tenants` / `weights` / `lowest_classes` views that only the farm and
guard tiers read).

The unit of service in continuous decode is the *slot-iteration* (one
slot held for one decode step — one token's worth of the machine).
A request's "packet length" is its reserved token budget
(`max_new_tokens`): the scheduler charges it at ADMISSION — so
normalized virtual time moves between picks within a single admission
wave and tenants interleave at request granularity, not pool-sized
bursts — and refunds whatever an early eos/deadline/preemption leaves
unconsumed. Admission always goes to the backlogged tenant with the
least `service / weight`; over any saturated interval each tenant's
token share converges to `weight_i / sum(weights of backlogged
tenants)` — classic start-time fair queuing.

Idle tenants don't bank credit: on re-backlog a tenant's virtual time
is lifted to the minimum over currently-backlogged tenants (the SFQ
"catch up to system virtual time" rule), so a tenant that slept for an
hour competes fairly, not catastrophically.

Preemption (opt-in): when admission finds no free slot and a
backlogged tenant holds strictly less than its weighted fair share
while another holds strictly more, the over-share tenant's youngest
slot is evicted (least progress destroyed). The scheduler maps the
eviction to `PreemptedError` — HTTP 429, distinct from deadline's 504
— so clients can tell "retry later" from "too slow".
"""
import threading

__all__ = ["TenantClass", "QosPolicy"]


class TenantClass:
    """Admission class for one tenant."""

    __slots__ = ("name", "weight", "max_slots", "vtime")

    def __init__(self, name, weight=1.0, max_slots=None):
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        self.name = name
        self.weight = float(weight)
        self.max_slots = max_slots if max_slots is None \
            else int(max_slots)
        self.vtime = 0.0            # normalized service accrued

    def __repr__(self):
        return (f"TenantClass({self.name!r}, weight={self.weight}, "
                f"max_slots={self.max_slots})")


class QosPolicy:
    """WFQ accounting + admission/preemption decisions.

    Unknown tenants are auto-registered at `default_weight` (serving
    millions of users means the tenant set is open); pass
    `strict=True` to reject unknown tenants at submit instead.
    """

    def __init__(self, tenants=None, default_weight=1.0,
                 preemption=False, strict=False):
        self._tenants = {}
        self.default_weight = float(default_weight)
        self.preemption = bool(preemption)
        self.strict = bool(strict)
        self._lock = threading.Lock()
        for t in tenants or ():
            if not isinstance(t, TenantClass):
                t = TenantClass(*t) if isinstance(t, tuple) \
                    else TenantClass(t)
            self._tenants[t.name] = t

    # ------------------------------------------------------- accounts
    def tenant(self, name):
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                if self.strict:
                    raise KeyError(
                        f"unknown tenant {name!r} (strict QoS; "
                        f"classes: {sorted(self._tenants)})")
                t = TenantClass(name, weight=self.default_weight)
                self._tenants[t.name] = t
            return t

    def charge(self, name, slot_iterations):
        """Accrue service: `slot_iterations` of machine time
        reserved/used."""
        t = self.tenant(name)
        t.vtime += slot_iterations / t.weight

    def refund(self, name, slot_iterations):
        """Give back reserved service a request did not consume
        (early eos, deadline retire, preemption)."""
        t = self.tenant(name)
        t.vtime -= slot_iterations / t.weight

    def on_backlogged(self, name, backlogged_names):
        """Idle -> backlogged transition: lift the tenant's virtual
        time to the floor of the currently-backlogged set so idle
        periods don't bank unbounded credit."""
        t = self.tenant(name)
        floor = [self.tenant(o).vtime for o in backlogged_names
                 if o != name]
        if floor:
            t.vtime = max(t.vtime, min(floor))

    # ------------------------------------------------------ decisions
    def pick_tenant(self, queued_tenants, held):
        """The backlogged tenant that should get the next slot: least
        normalized service, ties broken by name for determinism.
        Tenants at their max_slots cap are skipped. Returns None when
        nobody is eligible."""
        best = None
        for name in sorted(set(queued_tenants)):
            t = self.tenant(name)
            if t.max_slots is not None \
                    and held.get(name, 0) >= t.max_slots:
                continue
            if best is None or t.vtime < best.vtime:
                best = t
        return best.name if best is not None else None

    def fair_share(self, name, demand_tenants, num_slots):
        """`name`'s weighted share of the slot pool over the tenants
        that currently want slots (hold or queue)."""
        total = sum(self.tenant(o).weight for o in set(demand_tenants))
        if total <= 0:
            return float(num_slots)
        return num_slots * self.tenant(name).weight / total

    def preemption_victim(self, starved, queued_tenants, held,
                          num_slots):
        """Which tenant (if any) should lose a slot so `starved` can
        join? Only fires when starved is strictly under its fair share
        and the victim strictly over its own — so steady fair states
        never thrash. Returns a tenant name or None."""
        if not self.preemption or starved is None:
            return None
        demand = set(queued_tenants) | set(held)
        if held.get(starved, 0) + 1 \
                > self.fair_share(starved, demand, num_slots):
            return None                     # would overshoot its share
        victim, excess = None, 0.0
        for name, n in held.items():
            if name == starved:
                continue
            over = n - self.fair_share(name, demand, num_slots)
            if over > excess + 1e-9:
                victim, excess = name, over
        return victim
