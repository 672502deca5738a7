"""Tenant-fair admission: weighted fair queueing, rate limits, shedding.

A copy of scaletorch_tpu/serving/admission.py (standard library only).

The gateway's answer to "millions of users share one decode batch":
FIFO admission lets one flooding tenant starve everyone behind it, so
the gateway queues per TENANT and serves tenants by start-time weighted
fair queueing (SFQ) — each tenant's long-run service share converges to
``weight / sum(weights of backlogged tenants)`` regardless of how hard
anyone floods, and an idle tenant's first request jumps straight to the
current virtual time instead of paying for history it never used.

Service cost is measured in TOKENS (prompt + generation budget,
``GenerateRequest.cost``), not requests — a tenant of few huge requests
and a tenant of many tiny ones get the same token share, which is the
resource the engine actually spends.

Backpressure degrades to SHEDDING before it degrades to latency
(ROADMAP): a request is refused up front — HTTP 429 with a computed
Retry-After — when (1) its tenant's token bucket is empty, (2) the
global backlog bound is hit, or (3) the engine's live page-pool gauge
(``page_pool_free`` / ``pages_in_use`` from ``EngineMetrics.snapshot``)
shows the pool under the free watermark while a backlog already exists;
queueing behind a saturated pool would only manufacture timeouts. Every
shed is one ``shed`` terminal outcome at the HTTP layer, so conservation
holds on the wire.

Pure host-side stdlib: no torch, no asyncio, not even the framework
logger — the gateway drives it from its event
loop, the tests drive it from plain code with a fake clock, and
config.py validates tenant specs through it at CLI-parse time on any
interpreter.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple


@dataclass
class TenantConfig:
    """Fairness + rate-limit knobs of one tenant. ``weight`` is the WFQ
    share; ``rate``/``burst`` are the token bucket (cost units per
    second / bucket depth), 0 = unlimited."""

    name: str
    weight: float = 1.0
    rate: float = 0.0
    burst: float = 0.0

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, "
                f"got {self.weight}")
        if self.rate < 0 or self.burst < 0:
            raise ValueError(
                f"tenant {self.name!r}: rate/burst must be >= 0, got "
                f"rate={self.rate} burst={self.burst}")


def parse_tenant_spec(spec: str) -> Dict[str, TenantConfig]:
    """``'name:weight[:rate[:burst]],...'`` -> configs (the
    ``--serve_tenants`` grammar; validated at CLI parse time)."""
    out: Dict[str, TenantConfig] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if not parts[0]:
            raise ValueError(f"tenant spec entry {entry!r}: empty name")
        if len(parts) > 4:
            raise ValueError(
                f"tenant spec entry {entry!r}: expected "
                "name:weight[:rate[:burst]]")
        try:
            weight = float(parts[1]) if len(parts) > 1 else 1.0
            rate = float(parts[2]) if len(parts) > 2 else 0.0
            burst = float(parts[3]) if len(parts) > 3 else 0.0
        except ValueError:
            raise ValueError(
                f"tenant spec entry {entry!r}: weight/rate/burst must "
                "be numbers") from None
        if parts[0] in out:
            raise ValueError(f"tenant {parts[0]!r} declared twice")
        out[parts[0]] = TenantConfig(
            name=parts[0], weight=weight, rate=rate, burst=burst)
    return out


class TokenBucket:
    """Standard token bucket over a monotonic clock; ``rate == 0`` means
    unlimited (every take succeeds)."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.rate = rate
        # an empty burst with a positive rate would deadlock every take;
        # default the depth to one second of rate
        self.burst = burst if burst > 0 else rate
        self._clock = clock
        self._level = self.burst
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._level = min(self.burst,
                          self._level + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, cost: float) -> Tuple[bool, float]:
        """(granted, retry_after_s). ``retry_after_s`` is how long until
        the bucket could cover ``cost`` — the 429 Retry-After value. A
        cost beyond the bucket's DEPTH can never be granted no matter
        how long the client waits: that returns ``inf``, which the
        admission layer converts into a terminal ``rejected`` (503)
        instead of a retry-forever 429."""
        if self.rate <= 0:
            return True, 0.0
        self._refill()
        if self._level >= cost:
            self._level -= cost
            return True, 0.0
        if cost > self.burst:
            return False, float("inf")
        return False, max((cost - self._level) / self.rate, 0.001)


class _TenantQueue:
    __slots__ = ("config", "items", "bucket", "finish_tag")

    def __init__(self, config: TenantConfig,
                 clock: Callable[[], float]) -> None:
        self.config = config
        # (virtual finish tag, item, cost)
        self.items: Deque[Tuple[float, Any, float]] = deque()
        self.bucket = TokenBucket(config.rate, config.burst, clock)
        self.finish_tag = 0.0  # virtual finish of the tenant's last enqueue


class WeightedFairQueue:
    """Start-time fair queueing over tenants (SFQ virtual time).

    ``push`` tags a request with the tenant's virtual finish time
    ``start + cost / weight`` where ``start = max(V, tenant's previous
    finish)``; ``pop`` serves the backlogged tenant whose HEAD tag is
    smallest and advances the virtual time ``V`` to it. Flooding only
    advances the flooder's own tags — other tenants' heads stay small,
    so their share is preserved (the fairness property test's subject).
    """

    def __init__(self, *,
                 tenants: Optional[Dict[str, TenantConfig]] = None,
                 default_weight: float = 1.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if default_weight <= 0:
            raise ValueError(
                f"default_weight must be > 0, got {default_weight}")
        self._configured = dict(tenants or {})
        self._default_weight = default_weight
        self._clock = clock
        self._tenants: Dict[str, _TenantQueue] = {}
        self._virtual = 0.0
        self._backlog = 0

    def _tenant(self, name: str) -> _TenantQueue:
        tq = self._tenants.get(name)
        if tq is None:
            config = self._configured.get(name) or TenantConfig(
                name=name, weight=self._default_weight)
            tq = self._tenants[name] = _TenantQueue(config, self._clock)
        return tq

    def __len__(self) -> int:
        return self._backlog

    def depths(self) -> Dict[str, int]:
        """Per-tenant queue depth — the gateway's fairness gauge."""
        return {name: len(tq.items) for name, tq in self._tenants.items()
                if tq.items}

    def rate_check(self, tenant: str, cost: float) -> Tuple[bool, float]:
        """Token-bucket gate for one arrival (before any queueing).
        Side-effect-free for unlimited tenants — an arrival that is
        then shed must not have created per-tenant state (the tenant
        name is an untrusted client string)."""
        config = self._configured.get(tenant)
        if config is None or config.rate <= 0:
            return True, 0.0
        return self._tenant(tenant).bucket.try_take(cost)

    def push(self, tenant: str, item: Any, cost: float) -> None:
        if cost <= 0:
            raise ValueError(f"cost must be > 0, got {cost}")
        tq = self._tenant(tenant)
        start = max(self._virtual, tq.finish_tag)
        tq.finish_tag = start + cost / tq.config.weight
        tq.items.append((tq.finish_tag, item, cost))
        self._backlog += 1

    def push_front(self, tenant: str, item: Any, cost: float) -> None:
        """Return an item to the head of its tenant's queue (a dispatch
        that could not land — target replica briefly out of headroom)
        WITHOUT re-tagging: its virtual position is already paid for."""
        tq = self._tenant(tenant)
        tag = tq.items[0][0] if tq.items else tq.finish_tag
        tq.items.appendleft((tag, item, cost))
        self._backlog += 1

    def peek(self) -> Optional[Tuple[str, Any, float]]:
        """(tenant, item, cost) next in fair order, without removing."""
        best: Optional[Tuple[float, str]] = None
        for name, tq in self._tenants.items():
            if tq.items and (best is None or tq.items[0][0] < best[0]):
                best = (tq.items[0][0], name)
        if best is None:
            return None
        tag, name = best
        _, item, cost = self._tenants[name].items[0]
        return name, item, cost

    def pop(self) -> Optional[Tuple[str, Any, float]]:
        head = self.peek()
        if head is None:
            return None
        name, _, _ = head
        tq = self._tenants[name]
        tag, item, cost = tq.items.popleft()
        self._virtual = max(self._virtual, tag)
        self._backlog -= 1
        self._maybe_evict(name)
        return name, item, cost

    def _maybe_evict(self, name: str) -> None:
        """Drop a drained, UNCONFIGURED tenant's queue state. The
        tenant name is an untrusted client string — without eviction a
        client rotating random tenants grows this map (and the
        peek()/pop() scan) without bound. Semantics-preserving: an
        unconfigured tenant has no rate limit (no bucket state worth
        keeping) and its finish_tag is <= the virtual time once its
        queue is empty, so a re-created queue restarts exactly where
        the old one stood (start = max(V, 0))."""
        tq = self._tenants.get(name)
        if tq is not None and not tq.items and name not in self._configured:
            del self._tenants[name]

    def depth(self, tenant: str) -> int:
        tq = self._tenants.get(tenant)
        return len(tq.items) if tq is not None else 0

    def weight(self, tenant: str) -> float:
        config = self._configured.get(tenant)
        return config.weight if config is not None else self._default_weight

    def shed_oldest(self, tenant: str) -> Optional[Tuple[Any, float]]:
        """Remove a tenant's OLDEST queued item (the engine's shed order: the
        freshest work survives overload). Returns (item, cost)."""
        tq = self._tenants.get(tenant)
        if tq is None or not tq.items:
            return None
        _tag, item, cost = tq.items.popleft()
        self._backlog -= 1
        self._maybe_evict(tenant)
        return item, cost

    def drain_all(self) -> List[Tuple[str, Any, float]]:
        """Remove everything (gateway shutdown: abort the backlog)."""
        out = []
        while True:
            entry = self.pop()
            if entry is None:
                return out
            out.append(entry)


@dataclass
class SheddingDecision:
    """Why a request was refused. ``outcome`` is ``shed`` (429 +
    Retry-After: backing off helps) or ``rejected`` (503: it never
    will — e.g. a request whose cost exceeds its tenant's bucket
    depth)."""

    reason: str
    retry_after_s: float
    outcome: str = "shed"


class AdmissionController:
    """Token bucket -> WFQ -> gauge-gated dispatch, shed-before-latency.

    ``offer`` either enqueues an arrival or returns a
    ``SheddingDecision`` (HTTP 429); ``next_ready`` hands the dispatcher
    the next request in fair order once the engine gauges show headroom.
    ``gauges_fn`` reads the LIVE ``EngineMetrics.snapshot()`` of the
    dispatch target (aggregated over replicas by the gateway) — the
    paged pool's ``page_pool_free``/``pages_in_use`` are the admission
    signal, exactly as ROADMAP prescribes.
    """

    def __init__(
        self,
        *,
        gauges_fn: Callable[[], Dict[str, float]],
        tenants: Optional[Dict[str, TenantConfig]] = None,
        default_weight: float = 1.0,
        max_backlog: int = 256,
        free_page_watermark: float = 0.05,
        max_engine_queue: int = 0,
        on_shed: Optional[Callable[[Any, SheddingDecision], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if max_backlog < 1:
            raise ValueError(f"max_backlog must be >= 1, got {max_backlog}")
        if not 0.0 <= free_page_watermark < 1.0:
            raise ValueError(
                f"free_page_watermark must be in [0, 1), "
                f"got {free_page_watermark}")
        self.queue = WeightedFairQueue(
            tenants=tenants, default_weight=default_weight, clock=clock)
        self.gauges_fn = gauges_fn
        self.max_backlog = max_backlog
        self.free_page_watermark = free_page_watermark
        self.max_engine_queue = max_engine_queue
        self.on_shed = on_shed
        self.shed_count = 0
        # which tenant each shed was charged to (the arrival's tenant,
        # or the over-share tenant a fairness eviction displaced) — the
        # gateway exposes this as a tenant-labeled counter so "who is
        # being shed?" is answerable from /metrics, not just the total
        self.shed_by_tenant: Dict[str, int] = {}

    def _count_shed(self, tenant: str) -> None:
        self.shed_count += 1
        # tenant names are untrusted client strings: cap the counter's
        # cardinality (rotating random tenants must not grow gateway
        # memory); over-cap attribution coarsens to "_other"
        if tenant not in self.shed_by_tenant \
                and len(self.shed_by_tenant) >= 64:
            tenant = "_other"
        self.shed_by_tenant[tenant] = self.shed_by_tenant.get(tenant, 0) + 1

    # -- arrival side ------------------------------------------------------
    def offer(self, tenant: str, item: Any,
              cost: float) -> Optional[SheddingDecision]:
        """Admit one arrival into the fair queue, or shed it (returns
        the decision; None = queued). A FULL backlog is arbitrated by
        weighted share, not arrival order: an arrival whose tenant is
        over its share of the backlog is the one shed; an under-share
        arrival is admitted by evicting the most over-share tenant's
        OLDEST queued request instead (delivered to ``on_shed``) — a
        flooding tenant sheds against itself and cannot lock the victim
        out of the queue."""
        granted, retry_after = self.queue.rate_check(tenant, cost)
        if not granted:
            if retry_after == float("inf"):
                # no amount of waiting makes the bucket this deep —
                # terminal rejection, not a retry-forever 429
                return SheddingDecision(
                    reason=f"request cost {cost:g} exceeds tenant "
                           f"{tenant!r}'s burst capacity",
                    retry_after_s=retry_after, outcome="rejected")
            self._count_shed(tenant)
            return SheddingDecision(
                reason=f"tenant {tenant!r} over its rate limit",
                retry_after_s=retry_after)
        if len(self.queue) >= self.max_backlog:
            decision = self._arbitrate_full_backlog(tenant)
            if decision is not None:
                self._count_shed(tenant)
                return decision
            # an over-share victim was just evicted to make room for
            # THIS arrival — shedding the arrival too (pool gate) would
            # turn one shed into two and admit nobody
            self.queue.push(tenant, item, cost)
            return None
        if len(self.queue) > 0 and self._pool_saturated():
            # a backlog already exists AND the page pool is under the
            # free watermark: more queueing can only turn into timeouts
            self._count_shed(tenant)
            return SheddingDecision(
                reason="page pool under the free watermark with a "
                       "standing backlog",
                retry_after_s=self._drain_eta())
        self.queue.push(tenant, item, cost)
        return None

    def _arbitrate_full_backlog(
            self, tenant: str) -> Optional[SheddingDecision]:
        """Backlog at capacity: decide who pays. Returns the decision
        shedding the ARRIVAL, or None after evicting an over-share
        tenant's oldest request to make room (``on_shed`` told)."""
        q = self.queue
        active = {t: d for t, d in q.depths().items() if d > 0}
        weights = {t: q.weight(t) for t in set(active) | {tenant}}
        total_w = sum(weights.values())

        def ratio(t: str, depth: int) -> float:
            share = max(1.0, self.max_backlog * weights[t] / total_w)
            return depth / share

        arrival_ratio = ratio(tenant, active.get(tenant, 0) + 1)
        over = max(active, key=lambda t: ratio(t, active[t]))
        if ratio(over, active[over]) <= arrival_ratio or over == tenant:
            return SheddingDecision(
                reason=f"gateway backlog at capacity ({self.max_backlog}) "
                       f"and tenant {tenant!r} is over its share",
                retry_after_s=self._drain_eta())
        evicted = q.shed_oldest(over)
        if evicted is None:  # cannot happen while active[over] > 0
            return SheddingDecision(
                reason=f"gateway backlog at capacity ({self.max_backlog})",
                retry_after_s=self._drain_eta())
        self._count_shed(over)
        decision = SheddingDecision(
            reason=f"shed for tenant fairness: {over!r} over its backlog "
                   f"share while the queue is at capacity",
            retry_after_s=self._drain_eta())
        if self.on_shed is not None:
            self.on_shed(evicted[0], decision)
        return None

    def _pool_saturated(self) -> bool:
        try:
            snap = self.gauges_fn()
        except Exception:
            return False
        free = float(snap.get("page_pool_free", 0.0))
        used = float(snap.get("pages_in_use", 0.0))
        total = free + used
        if total <= 0:  # dense layout: no pool gauge, no pool gate
            return False
        return free / total < self.free_page_watermark

    def _drain_eta(self) -> float:
        """Retry-After heuristic: a second per queued request ahead,
        clamped to [1, 30] — coarse but monotone in backlog."""
        return float(min(30.0, max(1.0, len(self.queue))))

    def retry_after_hint(self) -> float:
        """The backoff the gateway attaches to any ``shed`` terminal
        (including fairness evictions decided after the arrival)."""
        return self._drain_eta()

    # -- dispatch side -----------------------------------------------------
    def engine_has_headroom(self) -> bool:
        """True when the dispatch target can take one more submit
        without the gateway losing WFQ control of the ordering (the
        ENGINE queue must stay shallow — the gateway's fair queue is
        where requests wait)."""
        try:
            snap = self.gauges_fn()
        except Exception:
            return False
        limit = self.max_engine_queue or max(
            1, int(snap.get("num_slots", 0)) or 1)
        return float(snap.get("queue_depth", 0.0)) < limit

    def next_ready(self) -> Optional[Tuple[str, Any, float]]:
        """The next (tenant, item, cost) in fair order when the engine
        has headroom, else None (the dispatcher waits for a tick)."""
        if not self.engine_has_headroom():
            return None
        return self.queue.pop()

    def requeue(self, tenant: str, item: Any, cost: float) -> None:
        self.queue.push_front(tenant, item, cost)

    def depths(self) -> Dict[str, int]:
        return self.queue.depths()
