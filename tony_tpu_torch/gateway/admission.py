"""SLO-aware admission: weighted fair queuing + per-tenant quotas.

The PyTorch port's copy of ``tony_tpu/gateway/admission.py``.

The gateway's original admission queue was one FIFO deque per replica
— correct for a single cooperative client, hopeless for the
multi-tenant, priority-skewed traffic ROADMAP item 3 targets: one
tenant's batch flood parks every interactive request behind it, and
the only defense (the global ``max_queue`` bound) punishes everyone
equally. This module replaces it with the Borg/YARN-shaped answer:

- ``WFQueue``: weighted fair queuing over PRIORITY TIERS
  (``interactive`` / ``standard`` / ``batch`` by default). Each tier
  accumulates *virtual work* — token cost divided by its weight — and
  the queue always pops the non-empty tier with the least virtual
  work. A saturating ``batch`` flood therefore costs ``interactive``
  at most one request's service time per ``weight_i / weight_b``
  admissions (bounded wait, never starvation), while an otherwise-idle
  queue gives any single tier the full admission rate (the scheduler
  is work-conserving: weights shape CONTENTION, they never reserve
  idle capacity). Within a tier, tickets pop deadline-first
  (``ttl_s``-anchored; no deadline sorts last in arrival order), so a
  request about to expire is not wasted behind patient ones.
- ``TenantQuotas``: a token bucket per tenant over ESTIMATED token
  cost (prompt + max_new_tokens — the same estimate routing uses).
  A tenant past its rate gets an immediate, honest 429 with a
  ``Retry-After`` derived from its bucket's refill time: quota
  breaches are priced, not queued, so one tenant's overrun can never
  occupy queue slots other tenants need (the "never starvation"
  half of the quota contract).

Both are pure host-side data structures with no locking of their own:
the gateway serializes ``WFQueue`` access under each replica's
condition variable, and ``TenantQuotas`` carries one small lock for
the cross-thread ``submit()`` path.
"""

from __future__ import annotations

import heapq
import math
import threading
import time

# the default tier ladder: weights shape how admission interleaves
# UNDER CONTENTION (8:4:1 — interactive pops ~8x as often as batch per
# unit token cost when both queues are non-empty); an idle queue gives
# any tier its full throughput. Order is the tie-break rank.
DEFAULT_TIER_WEIGHTS: dict[str, float] = {
    "interactive": 8.0,
    "standard": 4.0,
    "batch": 1.0,
}

DEFAULT_TIER = "standard"


def parse_tier_weights(spec: str) -> dict[str, float]:
    """Parse a CLI tier spec (``"interactive=8,standard=4,batch=1"``).
    Empty spec -> the defaults. Raises ``ValueError`` on malformed
    entries or non-positive weights (a zero weight would starve the
    tier — the exact failure mode WFQ exists to rule out)."""
    if not spec.strip():
        return dict(DEFAULT_TIER_WEIGHTS)
    out: dict[str, float] = {}
    for part in spec.split(","):
        name, sep, val = part.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(f"bad tier weight {part!r} "
                             f"(want name=weight,name=weight,...)")
        try:
            w = float(val)
        except ValueError:
            raise ValueError(f"bad tier weight {part!r}: {val!r} is not "
                             f"a number") from None
        if not w > 0:
            raise ValueError(f"tier {name!r} weight must be > 0 "
                             f"(got {w}); a zero-weight tier would starve")
        out[name] = w
    return out


class WFQueue:
    """Weighted fair queue of gateway tickets over priority tiers.

    Self-clocked fair queuing over per-tier virtual work: popping a
    ticket charges its tier ``cost / weight``; ``pop()`` serves the
    non-empty tier with the least accumulated virtual work (ties break
    by tier rank — the order of the weights dict). A tier going idle
    keeps its counter, and a tier waking from idle is CAUGHT UP to the
    busiest floor (the min virtual work among non-empty tiers), so a
    long-idle tier gets priority for one scheduling round but can
    never cash in unbounded credit.

    Within a tier, order is (deadline, arrival): a ticket's deadline
    is anchored to its ORIGINAL submit time (``Ticket.deadline`` is
    derived from ``t_submit + ttl_s``), so a failover re-enqueue
    re-sorts the ticket by the deadline it always had — never a
    refreshed one.

    NOT thread-safe by design: the owning replica serializes access
    under its condition variable, same as the deque it replaces.
    """

    def __init__(self, weights: dict[str, float] | None = None):
        self.weights = dict(weights or DEFAULT_TIER_WEIGHTS)
        if not self.weights:
            raise ValueError("WFQueue needs at least one tier")
        for tier, w in self.weights.items():
            if not w > 0:
                raise ValueError(f"tier {tier!r} weight must be > 0")
        self._rank = {t: i for i, t in enumerate(self.weights)}
        self._heaps: dict[str, list] = {t: [] for t in self.weights}
        self._vwork: dict[str, float] = {t: 0.0 for t in self.weights}
        self._seq = 0
        self._n = 0

    # ------------------------------------------------------------ sizing

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def depth_by_tier(self) -> dict[str, int]:
        return {t: len(h) for t, h in self._heaps.items() if h}

    def oldest_t_queued(self) -> float | None:
        """Earliest ``t_queued`` among waiting tickets (the queue's
        oldest-wait sensor — an autoscaler's most direct pressure
        signal). O(n) scan; admission queues are small by design."""
        oldest = None
        for heap in self._heaps.values():
            for _, _, ticket in heap:
                if oldest is None or ticket.t_queued < oldest:
                    oldest = ticket.t_queued
        return oldest

    # ------------------------------------------------------------ queue

    def _key(self, ticket) -> tuple:
        deadline = ticket.deadline
        return (math.inf if deadline is None else deadline, self._seq)

    def push(self, ticket) -> int:
        """Enqueue; returns the ticket's queue position (tickets ahead
        of it across all tiers — the ``queue_pos`` metrics record).
        Unknown tiers raise ``KeyError``: the gateway validates
        priority names at submit, so a miss here is a programming
        error, not a client error."""
        heap = self._heaps[ticket.tier]
        if not heap:
            # catch-up rule: a tier waking from idle starts at the
            # busiest floor — priority for one round, no banked credit
            floor = min((self._vwork[t] for t, h in self._heaps.items()
                         if h), default=None)
            if floor is not None:
                self._vwork[ticket.tier] = max(self._vwork[ticket.tier],
                                               floor)
        key = self._key(ticket)
        self._seq += 1
        ticket._wfq_key = key
        heapq.heappush(heap, (*key, ticket))
        self._n += 1
        return self._n - 1

    def unpop(self, ticket) -> None:
        """Put a just-popped ticket back at its old position and refund
        its tier's virtual-work charge (the engine-QueueFull putback
        path: the pop never resulted in service)."""
        heapq.heappush(self._heaps[ticket.tier], (*ticket._wfq_key, ticket))
        self._vwork[ticket.tier] -= ticket.cost / self.weights[ticket.tier]
        self._n += 1

    def pop(self):
        """The WFQ decision: least virtual work among non-empty tiers
        (rank breaks ties), deadline-first within the tier. Returns
        ``None`` when empty."""
        best = None
        for tier, heap in self._heaps.items():
            if not heap:
                continue
            cand = (self._vwork[tier], self._rank[tier])
            if best is None or cand < best[0]:
                best = (cand, tier)
        if best is None:
            return None
        tier = best[1]
        ticket = heapq.heappop(self._heaps[tier])[2]
        self._vwork[tier] += ticket.cost / self.weights[tier]
        self._n -= 1
        return ticket

    def steal_all(self) -> list:
        """Remove and return every ticket in WFQ service order (the
        failover steal): tickets keep their tier, so re-enqueueing them
        on a survivor re-applies the same fairness there."""
        out = []
        while True:
            ticket = self.pop()
            if ticket is None:
                return out
            out.append(ticket)


class TenantQuotas:
    """Per-tenant token-rate quotas: one token bucket per tenant over
    estimated request cost (prompt + budget tokens).

    ``rate_tokens_per_s <= 0`` disables quotas entirely (the default:
    a single-tenant deployment should pay zero bookkeeping).
    ``burst_tokens`` is the bucket depth (default ``4 * rate``): a
    tenant may burst that many tokens instantly, then sustain
    ``rate`` tokens/s. ``admit()`` returns ``None`` to admit or the
    seconds until the bucket could cover the request — the HTTP
    layer's ``Retry-After``. A request costing more than the whole
    burst charges exactly one full burst (documented in
    docs/SERVING.md): huge requests stay admittable but empty the
    tenant's bucket.

    Buckets are created on first sight and never expire; a tenant's
    entry is ~3 floats — millions of tenants fit in memory long before
    they fit in a fleet.

    A charge whose request is then refused downstream (the admission
    bound raced full, no healthy replica) must be ``refund()``ed: the
    tenant got zero service, its bucket must not pay. Rejection
    counting lives with the gateway's other shed accounting
    (``_Stats``), not here — one authoritative counter.
    """

    def __init__(self, rate_tokens_per_s: float = 0.0,
                 burst_tokens: float = 0.0):
        self.rate = float(rate_tokens_per_s)
        self.burst = float(burst_tokens) if burst_tokens > 0 \
            else 4.0 * max(self.rate, 0.0)
        self._lock = threading.Lock()
        self._buckets: dict[str, tuple[float, float]] = {}  # level, t

    @property
    def enabled(self) -> bool:
        return self.rate > 0

    def admit(self, tenant: str | None, cost: float,
              now: float | None = None) -> float | None:
        """Charge ``cost`` to ``tenant``'s bucket. Returns ``None`` on
        admit, else the retry-after seconds. Tenant ``None`` shares
        one anonymous bucket — with quotas on, unattributed traffic is
        a tenant too, not a bypass."""
        if not self.enabled:
            return None
        key = tenant or ""
        cost = min(float(cost), self.burst)  # a request bigger than
        # the burst charges the whole burst (else it could never pass)
        if now is None:
            now = time.monotonic()
        with self._lock:
            level, last = self._buckets.get(key, (self.burst, now))
            level = min(self.burst, level + (now - last) * self.rate)
            if level >= cost:
                self._buckets[key] = (level - cost, now)
                return None
            self._buckets[key] = (level, now)
            return (cost - level) / self.rate

    def refund(self, tenant: str | None, cost: float) -> None:
        """Re-credit a charge whose request was refused downstream of
        the quota gate (queue bound, no healthy replica): zero service
        delivered means zero tokens spent. Clamped the same way the
        charge was; the bucket's refill timestamp is untouched."""
        if not self.enabled:
            return
        key = tenant or ""
        cost = min(float(cost), self.burst)
        with self._lock:
            level, last = self._buckets.get(key,
                                            (self.burst - cost,
                                             time.monotonic()))
            self._buckets[key] = (min(self.burst, level + cost), last)

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "rate_tokens_per_s": self.rate,
                "burst_tokens": self.burst,
                "tenants": len(self._buckets),
            }
