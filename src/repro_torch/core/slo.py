"""SLO-aware serving tier: per-tenant deadline admission, weighted-fair
draining, p99-targeted coalescing control and graceful degradation
(paper §4.4 "real-time coordination with adaptive resource management";
the per-stream admission / deadline-awareness / load-conditioned scaling
follows the real-time adaptive multi-stream production design, and the
degrade-quality-before-shedding order follows FusionANNS's cooperative
CPU/GPU scheduling).

The tier sits between ``engine.search``/``submit_search`` and the
coalescing dispatcher:

* **Admission** (``ServingTier.offer``): every request carries a tenant
  id (default tenant when none) and an optional absolute deadline. Each
  tenant owns a FIFO; the dispatcher drains across tenants by **stride
  scheduling** (weighted fair: a tenant's virtual time advances by
  rows/weight per admitted request), so one hot tenant can saturate only
  its weight share of dispatch rows and can never starve the others.
* **Deadline admission**: at drain time a request whose deadline cannot
  be met even if dispatched immediately (``now + est_dispatch >
  deadline``) is skipped-and-failed with ``DeadlineMissError`` instead
  of wasting a dispatch on an answer the caller already abandoned.
* **Load shedding — last resort**: admission sheds (fails the future
  with ``LoadShedError``) only when the tenant's *modeled wait* — its
  queued rows over its weighted-fair share of the measured service rate
  — exceeds ``shed_at`` x the p99 target **and** degradation is already
  at its deepest level. Quality degrades before any request is dropped.
* **Graceful degradation** (``PressureController`` + ``degrade_params``):
  a pressure signal (modeled queue wait / p99 target) walks through
  ``degrade_order``, shrinking search-quality knobs through
  ``SearchParams`` overrides — re-rank depth first, then beam width
  (hop budget riding along so the round count stays constant and the
  per-round candidate width halves), then the fused round budget. Levels
  restore one at a time after ``restore_after`` consecutive calm
  dispatches (hysteresis: no flapping at a threshold).
* **p99-targeted window control**: the dispatcher keeps a reservoir of
  per-request end-to-end latencies; the coalescing window widens only
  while the observed p99 is under ``target_p99`` (and requests actually
  merged), and shrinks when p99 overshoots or a dispatch went out
  uncoalesced — replacing the global merge-rate halve/double heuristic
  that let a hot caller widen everyone's window unboundedly.

Everything here is host-side scheduling state: one lock (``self.cv``)
guards the queues, counters and model, and **every queue pop happens
under it** — the shutdown drain is mutually exclusive with the
dispatcher's pops by construction (the coalescer shutdown race fix).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.types import SearchParams

DEFAULT_TENANT = "default"


class SLOError(RuntimeError):
    """Base for admission-control failures surfaced through futures."""


class LoadShedError(SLOError):
    """Admission shed the request: the tenant's modeled queue wait
    exceeded the SLO with degradation already at its deepest level."""


class DeadlineMissError(SLOError):
    """The dispatcher skipped the request: its deadline could not be met
    even if dispatched immediately."""


class RateLimitError(SLOError):
    """Admission rejected the request: the tenant's token bucket
    (``SLOPolicy.tenant_rate_limits``) is empty."""


_NO_KEY = object()   # _pop_next sentinel: no filter-compatibility pin


@dataclass(frozen=True)
class SLOPolicy:
    """Knobs of the serving tier (engine config: ``slo_*``)."""

    target_p99: float = 0.05        # per-request p99 target (seconds);
    #                                 <= 0 disables the SLO machinery
    #                                 (no pressure, degradation or
    #                                 shedding; admission still runs
    #                                 weighted-fair and deadlines still
    #                                 apply when a request carries one)
    default_deadline: float = 0.0   # seconds after submit applied when a
    #                                 request carries none; 0 = no deadline
    tenant_weights: Optional[dict] = None   # tenant -> fair-share weight
    default_weight: float = 1.0     # weight of unlisted tenants
    degrade_order: tuple = ("rerank_depth", "beam", "fused_rounds")
    degrade_at: float = 0.5         # pressure (modeled wait / target)
    #                                 where level 1 engages; deeper levels
    #                                 space evenly up to shed_at
    shed_at: float = 1.0            # modeled-wait/target above which a
    #                                 maxed-out-degradation tenant sheds
    restore_after: int = 4          # consecutive calm dispatches per
    #                                 one-level restore (hysteresis)
    reservoir: int = 512            # latency samples kept per reservoir
    tenant_rate_limits: Optional[dict] = None   # tenant -> requests/s,
    #                                 or (rate, burst); absent = unlimited.
    #                                 Token bucket at offer: an empty
    #                                 bucket rejects with RateLimitError
    #                                 (counted per tenant in stats())

    @property
    def enabled(self) -> bool:
        return self.target_p99 > 0

    @property
    def n_levels(self) -> int:
        return len(self.degrade_order)

    def weight(self, tenant: str) -> float:
        w = (self.tenant_weights or {}).get(tenant, self.default_weight)
        if w <= 0:
            raise ValueError(f"tenant weight must be > 0, got {w} for "
                             f"{tenant!r}")
        return float(w)

    def rate_limit(self, tenant: str):
        """``(rate, burst)`` for ``tenant`` or None (unlimited). A bare
        rate gets ``burst = max(1, rate)`` — a one-second burst window,
        never below one admittable request."""
        rl = (self.tenant_rate_limits or {}).get(tenant)
        if rl is None:
            return None
        if isinstance(rl, (tuple, list)):
            rate, burst = float(rl[0]), float(rl[1])
        else:
            rate, burst = float(rl), max(1.0, float(rl))
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate limit for {tenant!r} must be > 0, "
                             f"got rate={rate}, burst={burst}")
        return rate, burst

    def level_threshold(self, level: int) -> float:
        """Pressure at which ``level`` engages (levels 1..n_levels spread
        evenly over [degrade_at, shed_at))."""
        n = max(self.n_levels, 1)
        return self.degrade_at + (level - 1) * \
            max(self.shed_at - self.degrade_at, 0.0) / n


class LatencyReservoir:
    """Fixed-size ring of latency samples with percentile reads. The
    reservoir keeps the newest ``cap`` samples: serving control must
    react to the current regime, not the run's whole history."""

    __slots__ = ("_buf", "_n", "_i")

    def __init__(self, cap: int = 512):
        self._buf = np.zeros(max(1, cap), np.float64)
        self._n = 0
        self._i = 0

    def add(self, x: float):
        self._buf[self._i] = x
        self._i = (self._i + 1) % len(self._buf)
        self._n = min(self._n + 1, len(self._buf))

    def __len__(self) -> int:
        return self._n

    def quantile(self, q: float) -> Optional[float]:
        """q in [0, 100]; None while empty."""
        if self._n == 0:
            return None
        return float(np.percentile(self._buf[:self._n], q))


class PressureController:
    """Hysteretic pressure -> degradation-level mapping. Escalates
    immediately when pressure crosses a level's threshold (overload must
    be answered now); de-escalates one level at a time only after
    ``restore_after`` consecutive updates below the current level's
    threshold (a single calm dispatch under a bursty arrival process is
    noise, not recovery)."""

    def __init__(self, policy: SLOPolicy):
        self.policy = policy
        self.level = 0
        self._calm = 0

    def _want(self, pressure: float) -> int:
        want = 0
        for lvl in range(1, self.policy.n_levels + 1):
            if pressure >= self.policy.level_threshold(lvl):
                want = lvl
        return want

    def update(self, pressure: float) -> int:
        want = self._want(pressure)
        if want > self.level:
            self.level = want
            self._calm = 0
        elif want < self.level:
            self._calm += 1
            if self._calm >= self.policy.restore_after:
                self.level -= 1
                self._calm = 0
        else:
            self._calm = 0
        return self.level


def degrade_params(sp: SearchParams, rerank_depth: int, level: int,
                   order: tuple = ("rerank_depth", "beam", "fused_rounds"),
                   ) -> tuple:
    """Search-quality knobs at degradation ``level``: each engaged stage
    of ``order`` halves one knob, cumulatively. Pure — restoring is just
    dispatching at a lower level again. Returns ``(sp, rerank_depth)``.

    * ``"rerank_depth"``: halve the exactly re-ranked pool prefix
      (floor ``sp.k``; the 0 = whole-pool sentinel degrades from
      ``sp.pool``). PQ answers lean harder on the ADC ordering.
    * ``"beam"``: halve beam AND the hop budget together (floors 4 /
      1 round) — the round count stays constant while the per-round
      candidate width halves, which is what actually halves executor
      work (halving beam alone would double the round count).
    * ``"fused_rounds"``: halve the hop budget again (floor one beam's
      worth), halving how many rounds the fused loop runs per query.
    """
    if level <= 0:
        return sp, rerank_depth
    from repro_torch.core.search import effective_rerank_depth
    for knob in order[:level]:
        if knob == "rerank_depth":
            base = effective_rerank_depth(rerank_depth, sp.k, sp.pool)
            rerank_depth = max(sp.k, base // 2)
        elif knob == "beam":
            new_beam = max(4, sp.beam // 2)
            sp = sp._replace(beam=new_beam,
                             max_iters=max(new_beam, sp.max_iters // 2))
        elif knob == "fused_rounds":
            sp = sp._replace(max_iters=max(max(1, sp.beam),
                                           sp.max_iters // 2))
        else:
            raise ValueError(f"unknown degrade_order stage {knob!r}")
    return sp, rerank_depth


class _TenantState:
    """Per-tenant admission queue + accounting (all fields guarded by
    the owning ``ServingTier``'s lock)."""

    __slots__ = ("name", "weight", "q", "queued_rows", "vtime",
                 "submitted", "completed", "shed", "deadline_misses",
                 "lat", "tokens", "rl_t", "rate_limited")

    def __init__(self, name: str, weight: float, reservoir: int):
        self.name = name
        self.weight = weight
        self.q: deque = deque()
        self.queued_rows = 0
        self.vtime = 0.0        # stride-scheduling virtual time
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.deadline_misses = 0
        self.lat = LatencyReservoir(reservoir)
        self.tokens = 0.0       # token bucket (lazily filled at first offer)
        self.rl_t: Optional[float] = None   # last refill timestamp
        self.rate_limited = 0


class ServingTier:
    """Admission + fairness + pressure state shared with the coalescing
    dispatcher. The dispatcher calls ``collect`` (weighted-fair batch
    assembly under the lock) and ``complete`` (latency/throughput model
    + pressure controller update); clients call ``offer``."""

    def __init__(self, policy: Optional[SLOPolicy] = None):
        self.policy = policy or SLOPolicy()
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.closed = False
        self.tenants: dict[str, _TenantState] = {}
        self.controller = PressureController(self.policy)
        self.lat = LatencyReservoir(self.policy.reservoir)
        self._queued_requests = 0
        self._queued_rows = 0
        self.rows_per_s: Optional[float] = None   # EWMA service rate
        self.est_dispatch_s: Optional[float] = None  # EWMA dispatch wall
        self.shed_total = 0
        self.deadline_miss_total = 0
        self.rate_limited_total = 0
        self.overshoot_avoided = 0   # admissions deferred at the batch cap
        self.pressure = 0.0

    # -- client side ----------------------------------------------------
    def _tenant(self, name: str) -> _TenantState:
        ts = self.tenants.get(name)
        if ts is None:
            ts = _TenantState(name, self.policy.weight(name),
                              self.policy.reservoir)
            # a fresh (or long-idle) tenant must not owe the others the
            # whole history of virtual time it never consumed
            ts.vtime = self._min_vtime()
            self.tenants[name] = ts
        return ts

    def _min_vtime(self) -> float:
        act = [t.vtime for t in self.tenants.values() if t.q]
        return min(act) if act else 0.0

    def _fair_wait(self, ts: _TenantState) -> float:
        """Modeled queue wait for one more row of ``ts``: its queued rows
        over its weighted-fair share of the measured service rate. The
        share is computed over tenants that are actually contending
        (non-empty queues), so an alone-in-the-queue tenant models the
        full rate."""
        if self.rows_per_s is None or self.rows_per_s <= 0:
            return 0.0
        active_w = sum(t.weight for t in self.tenants.values()
                       if t.q or t is ts)
        share = ts.weight / max(active_w, ts.weight)
        return ts.queued_rows / (share * self.rows_per_s)

    def offer(self, fut) -> bool:
        """Admit ``fut`` (a ``_SearchFuture`` carrying ``tenant``,
        ``deadline`` and ``queries``), or shed it. Shedding completes the
        future with ``LoadShedError`` and returns False — admission
        failures ride the future so sync and async callers see one
        failure mode. Raises RuntimeError after ``close``."""
        with self.cv:
            if self.closed:
                raise RuntimeError(
                    "CoalescingScheduler is stopped (engine closed); no "
                    "further searches accepted")
            ts = self._tenant(fut.tenant)
            ts.submitted += 1
            # token-bucket rate limit (per tenant, requests/s): refill
            # from wall time, then spend one token or reject. Runs before
            # the shed check — a limit violation is the tenant's own
            # doing and must not depend on global pressure state.
            rl = self.policy.rate_limit(ts.name)
            if rl is not None:
                rate, burst = rl
                now = time.perf_counter()
                if ts.rl_t is None:
                    ts.tokens = burst           # full bucket at first sight
                else:
                    ts.tokens = min(burst,
                                    ts.tokens + (now - ts.rl_t) * rate)
                ts.rl_t = now
                if ts.tokens < 1.0:
                    ts.rate_limited += 1
                    self.rate_limited_total += 1
                    fut.error = RateLimitError(
                        f"tenant {ts.name!r} rate-limited: bucket empty "
                        f"(rate {rate:g}/s, burst {burst:g})")
                    fut._event.set()
                    return False
                ts.tokens -= 1.0
            wait = self._fair_wait(ts)
            if (self.policy.enabled
                    and self.controller.level >= self.policy.n_levels
                    and wait > self.policy.shed_at * self.policy.target_p99):
                # last resort: quality degradation is already maxed and
                # this tenant's fair-share backlog still models past the
                # SLO — admitting would only miss, so fail fast
                ts.shed += 1
                self.shed_total += 1
                fut.error = LoadShedError(
                    f"tenant {ts.name!r} shed: modeled queue wait "
                    f"{wait * 1e3:.1f} ms exceeds "
                    f"{self.policy.shed_at:.2f} x target p99 "
                    f"{self.policy.target_p99 * 1e3:.1f} ms at max "
                    f"degradation")
                fut._event.set()
                return False
            if fut.deadline is None and self.policy.default_deadline > 0:
                fut.deadline = fut.submitted + self.policy.default_deadline
            ts.q.append(fut)
            ts.queued_rows += len(fut.queries)
            self._queued_requests += 1
            self._queued_rows += len(fut.queries)
            self.cv.notify_all()
        return True

    # -- dispatcher side ------------------------------------------------
    def _pop_next(self, rows: int, max_batch: int, fkey=_NO_KEY):
        """One weighted-fair pop (caller holds the lock): pick the
        non-empty tenant with the least virtual time, fail-and-skip
        heads whose deadline is already unmeetable, and refuse (peek,
        don't admit) a head that would push the batch past ``max_batch``
        — the pow2 padding bucket must not jump a size because one more
        request squeezed in after the cap was reached.

        ``fkey`` pins the batch's filter-spec compatibility class: only
        heads whose ``fkey`` matches may join (one executor dispatch
        evaluates ONE predicate). Incompatible heads are left queued —
        they lead the next batch — but their tenants are *skipped*, in
        vtime order, so a filtered hot tenant can't stall everyone."""
        est = self.est_dispatch_s or 0.0
        while True:
            act = sorted((t for t in self.tenants.values() if t.q),
                         key=lambda t: t.vtime)
            if not act:
                return None
            rescan = False
            for ts in act:
                fut = ts.q[0]
                r = len(fut.queries)
                now = time.perf_counter()
                if fut.deadline is not None and now + est > fut.deadline:
                    # skip-and-fail: the answer would arrive past the
                    # deadline even if dispatched right now
                    ts.q.popleft()
                    ts.queued_rows -= r
                    self._queued_requests -= 1
                    self._queued_rows -= r
                    ts.deadline_misses += 1
                    self.deadline_miss_total += 1
                    fut.error = DeadlineMissError(
                        f"tenant {ts.name!r} request missed its deadline "
                        f"before dispatch "
                        f"({(now - fut.submitted) * 1e3:.1f} "
                        f"ms queued, est dispatch {est * 1e3:.1f} ms)")
                    fut._event.set()
                    rescan = True    # queue changed: re-derive the order
                    break
                if fkey is not _NO_KEY \
                        and getattr(fut, "fkey", None) != fkey:
                    continue        # incompatible head: try next tenant
                if rows > 0 and rows + r > max_batch:
                    self.overshoot_avoided += 1
                    return None     # re-queued for the next dispatch
                ts.q.popleft()
                ts.queued_rows -= r
                self._queued_requests -= 1
                self._queued_rows -= r
                ts.vtime += r / ts.weight
                return fut
            if not rescan:
                return None

    def collect(self, max_batch: int, window: float, stop) -> list:
        """Assemble one dispatch batch: block (briefly) for the first
        request, then admit weighted-fair until the adaptive window
        closes, the batch fills, or the next head would overshoot the
        cap. Every pop happens under the lock, so a concurrent shutdown
        drain can never double-complete a future. Returns possibly-empty
        list (caller re-checks its stop flag)."""
        with self.cv:
            if self.closed or stop.is_set():
                return []   # shutdown owns the queue now (drain)
            if self._queued_requests == 0:
                self.cv.wait(timeout=0.05)
            if self.closed:
                return []
            first = self._pop_next(0, max_batch)
            if first is None:
                return []
            batch = [first]
            rows = len(first.queries)
            fkey = getattr(first, "fkey", None)   # batch's filter class
            deadline = time.perf_counter() + window
            while rows < max_batch and not self.closed \
                    and not stop.is_set():
                nxt = self._pop_next(rows, max_batch, fkey=fkey)
                if nxt is not None:
                    batch.append(nxt)
                    rows += len(nxt.queries)
                    continue
                if self._queued_requests > 0:
                    break       # head would overshoot the cap: dispatch
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                self.cv.wait(timeout=left)
            return batch

    def complete(self, batch: list, rows: int, dispatch_s: float,
                 ok: bool = True):
        """Post-dispatch accounting: feed the latency reservoirs, update
        the service-rate model and drive the pressure controller. An
        errored dispatch (``ok=False``) still drives the controller but
        must not feed the latency/throughput model. Returns the
        (possibly new) degradation level for the NEXT dispatch."""
        now = time.perf_counter()
        with self.cv:
            if ok and dispatch_s > 0:
                rate = rows / dispatch_s
                self.rows_per_s = rate if self.rows_per_s is None else \
                    0.8 * self.rows_per_s + 0.2 * rate
                self.est_dispatch_s = dispatch_s \
                    if self.est_dispatch_s is None else \
                    0.8 * self.est_dispatch_s + 0.2 * dispatch_s
            if ok:
                for fut in batch:
                    ts = self._tenant(fut.tenant)
                    lat = now - fut.submitted
                    ts.completed += 1
                    ts.lat.add(lat)
                    self.lat.add(lat)
            if self.policy.enabled and self.rows_per_s:
                self.pressure = (self._queued_rows / self.rows_per_s
                                 / self.policy.target_p99)
            else:
                self.pressure = 0.0
            return self.controller.update(self.pressure)

    def set_policy(self, policy: SLOPolicy):
        """Swap the serving policy live (the SLO bench calibrates a
        sustainable rate first, then retargets). Resets the pressure
        controller — thresholds moved, the old level is meaningless —
        and re-resolves every known tenant's fair-share weight; queues,
        counters and the latency/throughput model carry over."""
        with self.cv:
            self.policy = policy
            self.controller = PressureController(policy)
            for ts in self.tenants.values():
                ts.weight = policy.weight(ts.name)
                ts.rl_t = None      # limits moved: refill at next offer

    @property
    def level(self) -> int:
        return self.controller.level

    def request_p99(self) -> Optional[float]:
        with self.lock:
            return self.lat.quantile(99)

    # -- shutdown -------------------------------------------------------
    def close(self):
        with self.cv:
            self.closed = True
            self.cv.notify_all()

    def drain(self, error: Exception) -> int:
        """Fail every still-queued future with ``error``. Mutually
        exclusive with the dispatcher's pops (same lock + closed check),
        so a future is completed exactly once. Returns #failed."""
        n = 0
        with self.cv:
            for ts in self.tenants.values():
                while ts.q:
                    fut = ts.q.popleft()
                    ts.queued_rows -= len(fut.queries)
                    self._queued_requests -= 1
                    self._queued_rows -= len(fut.queries)
                    fut.error = error
                    fut._event.set()
                    n += 1
        return n

    # -- observability --------------------------------------------------
    def stats(self) -> dict:
        with self.lock:
            tenants = {}
            for name, ts in self.tenants.items():
                tenants[name] = {
                    "weight": ts.weight,
                    "queue_depth": len(ts.q),
                    "queued_rows": ts.queued_rows,
                    "submitted": ts.submitted,
                    "completed": ts.completed,
                    "shed": ts.shed,
                    "deadline_misses": ts.deadline_misses,
                    "rate_limited": ts.rate_limited,
                    "p50_ms": _ms(ts.lat.quantile(50)),
                    "p99_ms": _ms(ts.lat.quantile(99)),
                }
            return {
                "target_p99_ms": self.policy.target_p99 * 1e3,
                "degrade_level": self.controller.level,
                "pressure": self.pressure,
                "queue_depth": self._queued_requests,
                "queued_rows": self._queued_rows,
                "rows_per_s": self.rows_per_s or 0.0,
                "shed": self.shed_total,
                "deadline_misses": self.deadline_miss_total,
                "rate_limited": self.rate_limited_total,
                "overshoot_avoided": self.overshoot_avoided,
                "p50_ms": _ms(self.lat.quantile(50)),
                "p99_ms": _ms(self.lat.quantile(99)),
                "tenants": tenants,
            }


def _ms(x: Optional[float]) -> Optional[float]:
    return None if x is None else x * 1e3
