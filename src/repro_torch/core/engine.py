"""Serving engine (twin of ``repro.core.engine``).

``EngineConfig`` keeps every field of the reference plus ``device``;
``CoalescingScheduler`` (cross-query micro-batching through the SLO
serving tier, ``core/slo.py``) is the reference's, unchanged.
``SVFusionEngine`` serves searches in device mode from a device-resident
index, or in three-tier mode (``disk_path``) from a disk-backed store
with a host window, optionally with the PQ code lane and the fused
topology executor. The coalescer's dispatcher thread runs the executor
and the WAVP placement pass, and publishes the new cache tier under a
lock, so concurrent searches read the last published snapshot. Both
modes take streaming inserts and deletes on one serialized update
stream, with deletion-triggered repair and MVCC consolidation in a
background thread (paper §5); ``MultiStreamRunner`` drives search
streams and one update stream. In three-tier mode every update is logged
to the write-ahead log before it is applied, epochs are published as
snapshots (at open, every ``snapshot_every_epochs`` update batches, on
``checkpoint`` and at ``close``), and a ``disk_path`` holding a published
manifest is recovered instead of rebuilt (``core/wal.py``); a failed log
write turns the engine read-only. With ``attributes`` set, inserts carry
per-id attribute columns and searches take a ``filter``
(``core/filters.py``). With ``cards > 1`` a device-mode index is spread
over that many cards from one process: one device-mode index a card,
every search fanned out to all of them and merged, every write routed to
the card that owns the row (``SVFusionEngine`` "Several cards").
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent import futures
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core import cache as Cache
from repro_torch.core import calibrate
from repro_torch.core import distributed, mvcc, quant, slo, trace, update
from repro_torch.core import wal as walmod
from repro_torch.core.build import (_exact_knn, build_index,
                                    build_tiered_backend, compute_e_in)
from repro_torch.core.search import (effective_rerank_depth, search_batch,
                                     search_tiered)
from repro_torch.core.tiers import probe_fetch_latency
from repro_torch.core.types import (IndexState, SearchParams, Stats,
                                    init_graph_state, init_stats)


@dataclass
class EngineConfig:
    degree: int = 32
    cache_slots: int = 4096
    capacity: int = 1 << 16
    search: SearchParams = field(default_factory=SearchParams)
    repair_every: int = 8          # update batches between repair scans
    repair_budget: int = 256
    consolidate_threshold: float = 0.2   # paper: 20% deleted
    repair_threshold: float = 0.5        # paper: >50% dead neighbors
    max_versions: int = 2                # bounded-version policy
    sync: bool = True
    stale_refresh: int = 64              # ops between refreshes when !sync
    seed: int = 0
    # -- disk tier (paper Fig. 11; three-tier mode when disk_path is set) --
    disk_path: Optional[str] = None      # directory for the memmap tier
    disk_capacity: int = 0               # id-space of the disk tier
    #                                      (0 -> capacity)
    host_window: int = 0                 # host-window slots (0 -> cap // 4)
    prefetch: bool = True                # async frontier prefetcher
    prefetch_budget: int = 32            # ids enqueued per search iteration
    # -- speculative pipeline + cross-query coalescing (paper §4.4) --
    speculate: bool = True               # two-stage speculative tiered arm
    spec_width: int = 0                  # staged guesses/query (0 -> beam)
    spec_rank: str = "auto"              # frontier predictor: auto | flam |
    #                                      dist. "dist" (exact host re-rank)
    #                                      wins only when delta fetches are
    #                                      genuinely IO-bound; "auto" probes
    #                                      the disk tier's per-row fetch
    #                                      latency at startup and picks —
    #                                      ROADMAP records the right default
    #                                      flips between page-cache-backed
    #                                      and real-SSD deployments.
    spec_auto_threshold_us: float = 20.0  # per-row latency above which
    #                                      "auto" resolves to "dist"
    coalesce: bool = True                # adaptive cross-query micro-batching
    coalesce_max_batch: int = 256        # max queries per merged dispatch
    coalesce_window: float = 2e-3        # max adaptive coalescing wait (s)
    # -- SLO-aware serving tier (core/slo.py): per-tenant deadline
    #    admission, p99-targeted coalescing, graceful degradation --
    slo_target_p99: float = 0.0          # per-request p99 target (s): the
    #                                      window controller widens only
    #                                      under it, pressure/shedding are
    #                                      scaled by it. 0 (default) keeps
    #                                      the tier passive: weighted-fair
    #                                      admission + explicit deadlines
    #                                      only, no degradation/shedding,
    #                                      merge-rate window heuristic
    slo_default_deadline: float = 0.0    # deadline (s after submit) for
    #                                      requests that carry none;
    #                                      0 = no implicit deadline
    slo_tenant_weights: Optional[dict] = None  # tenant -> fair-share
    #                                      weight (weighted-fair drain;
    #                                      unlisted tenants weigh 1.0) —
    #                                      weights double as priorities
    slo_degrade_order: tuple = ("rerank_depth", "beam", "fused_rounds")
    #                                      quality knobs halved (in order,
    #                                      cumulatively) as overload
    #                                      pressure rises; shedding is
    #                                      allowed only past the last
    slo_degrade_at: float = 0.5          # pressure (modeled queue wait /
    #                                      target p99) engaging level 1
    slo_shed_at: float = 1.0             # modeled-wait/target above which
    #                                      a maxed-degradation tenant is
    #                                      shed at admission
    slo_restore_after: int = 4           # calm dispatches per one-level
    #                                      degradation restore
    slo_tenant_rate_limits: Optional[dict] = None  # tenant -> requests/s
    #                                      (or (rate, burst)): token bucket
    #                                      at admission; an empty bucket
    #                                      rejects with slo.RateLimitError,
    #                                      counted per tenant in
    #                                      stats()["slo"]
    wavp_cascade_promote: bool = True    # cascade hits displace frozen slots
    # -- PQ code lane (quant.py): device-resident ADC scan + exact re-rank
    pq_enabled: bool = False             # coarse-then-refine tiered search
    pq_m: int = 16                       # subspaces (largest divisor of dim
    #                                      <= this is used; codes are m
    #                                      bytes/vector vs dim*4 exact)
    pq_bits: int = 8                     # bits/code (K = 2^bits centroids)
    pq_train_iters: int = 20             # Lloyd sweeps at index time
    pq_train_sample: int = 4096          # codebook training sample rows
    rerank_depth: int = 32               # pool entries exactly re-ranked
    #                                      through the cascade (0 -> pool;
    #                                      == pool pins exact-path parity)
    # -- fused multi-round executor (PQ mode): device-resident topology
    #    tier + K-round lax.while_loop dispatch --
    topo_cache_slots: int = 0            # adjacency-row slots on device
    #                                      (0 -> disk capacity: full
    #                                      residency, warmed at init so
    #                                      steady state is 3 dispatches;
    #                                      < 0 disables the fused path)
    fused_rounds: int = 0                # K-round budget per fused
    #                                      dispatch (0 -> uncapped: one
    #                                      dispatch covers every in-cache
    #                                      round)
    # -- durability (core/wal.py): WAL + epoch-fenced snapshots --
    wal_enabled: bool = True             # log each update op to a CRC-framed
    #                                      WAL before mutating the store;
    #                                      reopening an engine on a disk_path
    #                                      with a published manifest recovers
    #                                      (snapshot + WAL replay) instead of
    #                                      rebuilding
    wal_group_commit: int = 8            # records per fsync (group commit);
    #                                      1 = fsync every op
    snapshot_every_epochs: int = 512     # update batches (write epochs)
    #                                      between automatic snapshot
    #                                      publications; 0 = publish only at
    #                                      open and close
    # -- filtered search (core/filters.py): per-id attribute store +
    #    in-dispatch predicate lane --
    attributes: Optional[object] = None  # filters.AttributeSchema: fixed
    #                                      tag/numeric columns per id
    #                                      (tiered mode only). Enables
    #                                      search(filter=FilterSpec(...))
    filter_fallback_selectivity: float = 0.1  # sampled selectivity below
    #                                      which a filtered query routes to
    #                                      the brute-force ADC scan over
    #                                      the matched set (a graph walk
    #                                      starves when almost nothing
    #                                      passes); 0 disables the fallback
    cache_dtype: str = "bf16"            # exact-cache payload dtype:
    #                                      bf16 halves device vector bytes
    #                                      (re-rank upcasts to fp32);
    #                                      "fp32" restores bit-exactness
    build_partitions: int = 1            # partitioned graph build (bounded
    #                                      memory window; used by --scale)
    build_cross_samples: int = 128       # cross-partition candidate columns
    #                                      per partition (graph quality at
    #                                      scale hinges on this)
    device: str = "cuda"                 # where the index lives and the
    #                                      executor runs; "cpu" runs the
    #                                      plain PyTorch versions of the
    #                                      kernels (tests)
    cards: int = 1                       # device mode: cards the index is
    #                                      spread over, shard c on cuda:c
    #                                      (every shard on the CPU with
    #                                      device="cpu"); capacity,
    #                                      cache_slots and the other table
    #                                      sizes are per card

    def __post_init__(self):
        dev = resolve_device(self.device, "EngineConfig")
        if self.cards < 1:
            raise ValueError(f"EngineConfig(cards={self.cards}): at least "
                             "one card")
        if self.cards > 1 and self.disk_path:
            raise ValueError(
                f"EngineConfig(cards={self.cards}) spreads a device-mode "
                "index over cards; the three-tier mode (disk_path) holds "
                "one index: set cards=1")
        if self.cards > 1 and dev.type == "cuda" \
                and torch.cuda.device_count() < self.cards:
            raise RuntimeError(
                f"EngineConfig(cards={self.cards}): "
                f"{torch.cuda.device_count()} CUDA devices are available")


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a torch.device for the entry point ``who``: asking for
    CUDA without a card raises, and so does a device type other than
    cuda and cpu."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device={device!r}): no CUDA device is available; pass "
            "device=\"cpu\" to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class ReadOnlyEngineError(RuntimeError):
    """The WAL device failed: the engine degraded to read-only (searches
    keep serving; updates raise this instead of risking an unlogged
    mutation). ``stats()["degraded"]`` reports the mode."""


class _SearchFuture:
    """Demux handle for one coalesced search request. Carries the SLO
    admission metadata: ``tenant`` names the per-tenant queue it joins
    and ``deadline`` (absolute ``perf_counter`` time, or None) lets the
    dispatcher skip-and-fail it once unmeetable."""

    __slots__ = ("queries", "submitted", "_event", "ids", "dists", "error",
                 "latency", "tenant", "deadline", "filter", "fkey", "tid")

    def __init__(self, queries, tenant=None, deadline=None, filter=None):
        self.queries = queries
        self.submitted = time.perf_counter()
        # the submitting thread, for its coalesce.queue span (traced only)
        self.tid = threading.get_native_id() if trace.TRACER.on else 0
        self._event = threading.Event()
        self.ids = None
        self.dists = None
        self.error = None
        self.latency = 0.0
        self.tenant = slo.DEFAULT_TENANT if tenant is None else str(tenant)
        # relative seconds -> absolute deadline on the submit clock
        self.deadline = None if deadline is None \
            else self.submitted + float(deadline)
        # filter-spec compatibility class: the serving tier coalesces
        # only requests whose fkey matches (one dispatch, one predicate)
        self.filter = filter
        self.fkey = None if filter is None else filter.key()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("coalesced search did not complete")
        if self.error is not None:
            raise self.error
        return self.ids, self.dists


class CoalescingScheduler:
    """SLO-aware adaptive cross-query coalescing (paper §4.4, adaptive
    resource management): requests arriving within a short window — or
    until the micro-batch fills — are stacked into ONE executor
    invocation and the results are demultiplexed per request, so N
    concurrent submitters share each round's fixed dispatch cost instead
    of paying it N times.

    Admission runs through the serving tier (``core.slo.ServingTier``):
    per-tenant queues drained weighted-fair, deadline-unmeetable
    requests skipped-and-failed, and — once degradation is maxed —
    over-SLO tenants shed at admission. The coalescing window is
    **p99-targeted**: a reservoir of per-request end-to-end latencies is
    kept, and the window widens only while the observed p99 is under the
    policy target AND requests actually merged; it halves when a
    dispatch went out uncoalesced (light load — a lone caller converges
    to ~direct-call p50) or when p99 overshoots the target (queueing is
    eating the budget), clamped to [min_window, max_window]. Under
    pressure the tier degrades search quality (``slo.degrade_params``
    applied by the search_fn via ``degrade=level``) before any request
    is shed."""

    def __init__(self, search_fn, *, max_batch=256, max_window=2e-3,
                 min_window=5e-5, policy: Optional[slo.SLOPolicy] = None):
        self._search = search_fn
        self.tier = slo.ServingTier(policy)
        self._stop = threading.Event()
        self._th: Optional[threading.Thread] = None
        self._th_lock = threading.Lock()
        self.max_batch = max_batch
        self.max_window = max_window
        self.min_window = min_window
        self.window = min_window
        self.requests = 0      # requests served
        self.queries = 0       # query rows served
        self.dispatches = 0    # merged executor invocations
        self.coalesced = 0     # dispatches that merged > 1 request
        self.degraded_dispatches = 0  # dispatches run at level > 0

    # -- client side ----------------------------------------------------
    def submit(self, queries, tenant=None, deadline=None,
               filter=None) -> _SearchFuture:
        """Enqueue one request. ``tenant`` keys the fair-share admission
        queue (None -> default tenant); ``deadline`` is seconds from now
        after which the result is worthless (None -> policy default);
        ``filter`` is a ``filters.FilterSpec`` — only requests with an
        equal spec share a dispatch (the tier demuxes by ``fkey``).
        A shed request comes back as a future already failed with
        ``slo.LoadShedError``."""
        fut = _SearchFuture(np.asarray(queries, np.float32),
                            tenant=tenant, deadline=deadline,
                            filter=filter)
        self._ensure_started()
        self.tier.offer(fut)   # raises after stop(); sheds via the future
        return fut

    def search(self, queries, tenant=None, deadline=None, filter=None):
        return self.submit(queries, tenant=tenant,
                           deadline=deadline, filter=filter).result()

    # -- dispatcher -----------------------------------------------------
    def _ensure_started(self):
        if self._th is not None and self._th.is_alive():
            return
        with self._th_lock:
            if self.tier.closed:
                return
            if self._th is None or not self._th.is_alive():
                self._th = threading.Thread(target=self._run, daemon=True)
                self._th.start()

    def _run(self):
        while not self._stop.is_set():
            batch = self.tier.collect(self.max_batch, self.window,
                                      self._stop)
            if not batch:
                continue
            rows = sum(len(f.queries) for f in batch)
            level = self.tier.level
            ok = True
            t0 = time.perf_counter()
            if trace.TRACER.on:
                for f in batch:
                    if f.tid:
                        trace.record("coalesce.queue",
                                     round(f.submitted * 1e9),
                                     round(t0 * 1e9), f.tid)
            try:
                kw = {"degrade": level} if level > 0 else {}
                if batch[0].filter is not None:
                    # the tier guarantees a filter-homogeneous batch
                    kw["filter"] = batch[0].filter
                ids, dists = self._search(
                    np.concatenate([f.queries for f in batch], axis=0),
                    **kw)
                off = 0
                now = time.perf_counter()
                for f in batch:
                    b = len(f.queries)
                    f.ids, f.dists = ids[off:off + b], dists[off:off + b]
                    f.latency = now - f.submitted
                    off += b
            except Exception as e:
                ok = False
                for f in batch:
                    f.error = e
            finally:
                dt = time.perf_counter() - t0
                self.requests += len(batch)
                self.queries += rows
                self.dispatches += 1
                if level > 0:
                    self.degraded_dispatches += 1
                if len(batch) > 1:
                    self.coalesced += 1
                self.tier.complete(batch, rows, dt, ok=ok)
                for f in batch:
                    f._event.set()
                self._adapt_window(len(batch))

    def _adapt_window(self, merged: int):
        """p99-targeted window control. Shrink on an uncoalesced dispatch
        (idle convergence to the direct-call path) or when request p99
        overshoots the target (wider windows add queueing latency we can
        no longer afford); widen ONLY while merging is happening and p99
        still has headroom under the target."""
        if merged == 1:
            self.window = max(self.min_window, self.window * 0.5)
            return
        target = self.tier.policy.target_p99
        p99 = self.tier.lat.quantile(99)   # dispatcher-only read
        if target > 0 and p99 is not None and p99 > target:
            self.window = max(self.min_window, self.window * 0.5)
        else:
            # no target configured -> legacy merge-rate heuristic
            # (merging happened, widen); under a target, widen only
            # while p99 has headroom
            self.window = min(self.max_window, self.window * 2.0)

    def stop(self, join_timeout: float = 5.0):
        """Terminal shutdown: stop the dispatcher and FAIL any request
        still queued — an orphaned future would otherwise hang its caller
        forever in ``result()``. Submissions after stop() raise. The
        drain shares the tier's lock with the dispatcher's queue pops
        (which refuse once ``closed`` is set), so a slow-to-exit
        dispatcher and the drain can never complete the same future
        twice; a dispatcher that outlives ``join_timeout`` (an executor
        call that never returns) raises AFTER the queued futures are
        failed, so no caller is left hanging either way."""
        self.tier.close()
        self._stop.set()
        th = self._th
        if th is not None:
            th.join(timeout=join_timeout)
        self.tier.drain(RuntimeError(
            "CoalescingScheduler stopped before this request was "
            "dispatched"))
        if th is not None and th.is_alive():
            raise RuntimeError(
                "CoalescingScheduler dispatcher did not exit within "
                f"{join_timeout}s of stop(): the executor call is stuck; "
                "its in-flight futures may never complete")
        self._th = None


# the counters an engine over several cards reads as its cards' sums
SUMMED = ("_consolidations", "host_syncs", "_spec_hits", "_spec_misses")


class SVFusionEngine:
    """Thread-safe SANNS engine over the functional core.

    * **device mode** (default): the capacity tier is the device-resident
      ``GraphState``; searches run the hop-batched frontier executor
      (``core.search``) through the coalescing scheduler, then the WAVP
      placement pass (``core.cache``) publishes the new cache tier.
    * **three-tier mode** (``cfg.disk_path``): the capacity tier is a
      ``TieredStore`` host window over disk memmaps; searches cascade
      device cache -> host window -> disk through ``search_tiered``, with
      the PQ code lane and the fused topology executor when
      ``cfg.pq_enabled``, and the host placement pass runs after each
      batch. With ``wal_enabled`` (the default) updates are logged and
      the index survives the process; ``attributes`` enables filtered
      search.

    Inserts and deletes serialize on the update stream in both modes:
    device mode through ``update.insert_batch`` / ``delete_batch`` with
    localized repair every ``repair_every`` batches, three-tier mode
    through ``update.insert_tiered`` / ``delete_tiered`` with a
    write-through install of new rows into the topology cache. A
    deleted fraction of ``consolidate_threshold`` starts a background
    consolidation on an MVCC snapshot (``consolidate_async``), at most
    ``max_versions`` in flight; the reverse edges inserted meanwhile are
    logged and re-applied at the merge.

    **Several cards** (device mode, ``cfg.cards > 1``): one process holds
    one index over cards ``0 .. cards-1``, a one-card engine a card
    (``_shards``; shard c on ``cuda:c``, its seed drawn from (seed, c) by
    ``distributed.shard_seed``). Global id g lives on card g % cards at
    local row g // cards (``distributed.interleave_route``): the initial
    rows keep their order as ids 0..n-1 and card c is built from
    ``vectors[c::cards]``; an insert hands out the next ids and applies
    each card's rows on that card; a delete routes each id likewise. Both
    return once every card has published. One coalescer stays in front:
    each dispatch runs every card's executor at once, and the per-card
    answers are merged by ``distributed.merge_shard_results``. A card's
    share of a dispatch or a write runs on long-lived worker threads of
    that card, with the card current, the cards at once. Each card keeps
    its own repair cadence and consolidation; the cards' consolidations
    take their snapshots when each card passes the threshold and run one
    at a time (``_consolidate_gate``). ``state.graph`` reads the
    cards' published graphs by global id
    (``distributed.InterleavedGraph``); the counters ``SUMMED`` names are
    the cards' sums.
    """

    def __init__(self, init_vectors, cfg: EngineConfig, init_attrs=None):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self._init_attrs = init_attrs      # seed attributes (tiered mode)
        self._wal = None                   # wal.WriteAheadLog (tiered mode)
        self._recovery = None              # wal.recover report when reopened
        self._durable_epoch = None         # last published manifest epoch
        self._degraded = None              # read-only reason once WAL fails
        self._batches_since_snapshot = 0
        if cfg.pq_enabled and not cfg.disk_path:
            raise ValueError(
                "pq_enabled requires the three-tier mode (set disk_path): "
                "the PQ code lane rides the tiered executor")
        if cfg.attributes is not None and not cfg.disk_path:
            raise ValueError(
                "attributes (filtered search) require the three-tier mode "
                "(set disk_path): the attribute store rides the tiered "
                "backend")
        if init_attrs is not None and cfg.attributes is None:
            raise ValueError("init_attrs passed but cfg.attributes is "
                             "unset: declare the attribute schema")
        self._backend = None                   # TieredBackend in 3-tier mode
        self._placement = None                 # HostPlacement in 3-tier mode
        self.build_timings: dict = {}
        self._cost_model = None                # calibrate.CostModel, lazily
        self._shards = None                    # one engine a card (cards > 1)
        if cfg.cards > 1:
            self._init_cards(init_vectors, cfg)
        else:
            self._init_index(init_vectors, cfg)
        self._coalescer = (CoalescingScheduler(
            self._search_exec, max_batch=cfg.coalesce_max_batch,
            max_window=cfg.coalesce_window,
            policy=slo.SLOPolicy(
                target_p99=cfg.slo_target_p99,
                default_deadline=cfg.slo_default_deadline,
                tenant_weights=cfg.slo_tenant_weights,
                degrade_order=tuple(cfg.slo_degrade_order),
                degrade_at=cfg.slo_degrade_at,
                shed_at=cfg.slo_shed_at,
                restore_after=cfg.slo_restore_after,
                tenant_rate_limits=cfg.slo_tenant_rate_limits))
            if cfg.coalesce else None)
        # host seconds of each search dispatch, insert and delete call:
        # the durations of the engine.* spans, filled on and off
        self.latencies: dict[str, list] = {"search": [], "insert": [],
                                           "delete": []}

    def _init_index(self, init_vectors, cfg: EngineConfig):
        """The index and its update stream's state on one device."""
        self._key = torch.Generator(device=self.device)
        self._key.manual_seed(cfg.seed)
        self._state_lock = threading.RLock()   # publish/subscribe
        self._update_lock = threading.Lock()   # serializes the update stream
        self._cache_lock = threading.Lock()
        self._rng = np.random.default_rng(cfg.seed)
        self._spec_rank = cfg.spec_rank        # resolved by the tiered probe
        self._spec_probe_us = None
        if cfg.disk_path:
            self._init_tiered(init_vectors, cfg)
        else:
            if init_vectors is None:
                raise ValueError("device mode has no durable state to "
                                 "recover: init_vectors is required")
            # the reference's device mode drops the partition knobs and
            # always builds one partition (ROADMAP C); the port honours them
            self._state = build_index(
                init_vectors, degree=cfg.degree, cache_slots=cfg.cache_slots,
                n_max=cfg.capacity, n_partitions=cfg.build_partitions,
                cross_samples=cfg.build_cross_samples, device=self.device,
                timings=self.build_timings)
        self._stale_state = self._state
        self._ops_since_refresh = 0
        self._update_batches = 0
        self._batches_since_repair = 0
        self._consolidations = 0
        self._active_versions = 0
        self._rev_logs: list = []
        self._snapshot_n: Optional[int] = None
        self._bg_threads: list = []
        # held by a device-mode consolidation's work; one card runs one at
        # a time anyway, the cards of an engine over several share one
        self._consolidate_gate = threading.Lock()
        self.host_syncs = 0            # device-mode executor reads
        self._search_rounds = 0        # tiered executor round accounting
        self._search_dispatches = 0    # device dispatches issued by search
        self._search_batches = 0
        self._spec_hits = 0            # speculative-pipeline frontier hits
        self._spec_misses = 0
        self._topo_hits = 0            # fused-loop topology-cache hits
        self._topo_misses = 0
        self._filtered_searches = 0    # filtered search batches
        self._filter_fallbacks = 0     # ... of which took the brute-force
        #                                low-selectivity path
        self._filter_last_selectivity = None
        self._filter_last_path = None

    def _init_cards(self, init_vectors, cfg: EngineConfig):
        """One device-mode engine a card, each built from its interleaved
        share of ``init_vectors``, and two worker threads a card with
        that card current: the card's share of a search dispatch and of
        a write run at once, as the dispatcher and a writer do on one
        card."""
        if init_vectors is None:
            raise ValueError("device mode has no durable state to "
                             "recover: init_vectors is required")
        cards = cfg.cards
        devices = [torch.device(self.device.type, c)
                   if self.device.type == "cuda" else self.device
                   for c in range(cards)]
        self._shards = [SVFusionEngine(init_vectors[c::cards],
                                       dataclasses.replace(
                                           cfg, cards=1, device=str(dev),
                                           seed=distributed.shard_seed(
                                               cfg.seed, c),
                                           coalesce=False))
                        for c, dev in enumerate(devices)]
        # a consolidation is host work under the one interpreter lock:
        # the cards' run one at a time, each on its own snapshot
        gate = threading.Lock()
        for s in self._shards:
            s._consolidate_gate = gate
            for k, v in s.build_timings.items():
                self.build_timings[k] = self.build_timings.get(k, 0.0) + v
        self._n = len(init_vectors)             # ids handed out: 0 .. n-1
        self._route_lock = threading.Lock()     # serializes routed writes
        self._card_dispatches = [0] * cards
        self._workers = [futures.ThreadPoolExecutor(
            2, thread_name_prefix=f"svfusion-card{c}",
            initializer=(torch.cuda.set_device if dev.type == "cuda"
                         else None), initargs=(dev,))
            for c, dev in enumerate(devices)]

    def __getattr__(self, name):
        # over several cards the engine holds no index of its own: the
        # counters the benchmark reads are its cards' sums
        shards = self.__dict__.get("_shards")
        if shards and name in SUMMED:
            return sum(getattr(s, name) for s in shards)
        raise AttributeError(f"{type(self).__name__!r} object has no "
                             f"attribute {name!r}")

    def _init_tiered(self, init_vectors, cfg: EngineConfig):
        if cfg.cache_dtype not in ("bf16", "fp32"):
            raise ValueError(f"cache_dtype must be bf16|fp32, got "
                             f"{cfg.cache_dtype!r}")
        man = walmod.load_manifest(cfg.disk_path)
        if man is not None:
            # the directory holds a published durable epoch: recover it
            # (snapshot + WAL replay) instead of rebuilding, and refuse
            # ambiguous mixes
            if init_vectors is not None and len(init_vectors):
                raise ValueError(
                    "disk_path holds a published durable index; pass "
                    "init_vectors=None to recover it, or point disk_path "
                    "at a fresh directory to build")
            if self._init_attrs is not None:
                raise ValueError(
                    "disk_path holds a published durable index; seed "
                    "attributes (init_attrs) only apply to a fresh build")
            if not cfg.wal_enabled:
                raise ValueError(
                    "disk_path holds a published durable index but "
                    "wal_enabled=False: recovering without a WAL would "
                    "leave subsequent updates unlogged under a manifest "
                    "that claims durability")
            if bool(man.get("pq")) != bool(cfg.pq_enabled):
                raise ValueError(
                    f"pq_enabled={cfg.pq_enabled} does not match the "
                    f"durable index (manifest pq={man.get('pq')!r})")
            cap = int(man["capacity"])
            t0 = time.perf_counter()
            self._backend, self._wal, self._recovery = walmod.recover(
                cfg.disk_path, host_window=cfg.host_window
                or max(64, cap // 4), group_commit=cfg.wal_group_commit,
                device=self.device)
            self.build_timings["recover_s"] = time.perf_counter() - t0
            self._durable_epoch = int(man["epoch"])
            n, dim = self._backend.n, self._backend.dim
        else:
            if init_vectors is None or not len(init_vectors):
                raise ValueError(
                    "nothing to recover: disk_path has no published "
                    "manifest and no init_vectors were given")
            init_vectors = np.asarray(init_vectors, np.float32)
            if len(init_vectors) < 2 * cfg.degree:
                raise ValueError("three-tier mode needs >= 2*degree seed "
                                 "vectors to bootstrap the graph")
            n, dim = init_vectors.shape
            cap = cfg.disk_capacity or cfg.capacity
            self._backend = build_tiered_backend(
                init_vectors, cfg.degree, cfg.disk_path, disk_capacity=cap,
                host_window=cfg.host_window, seed=cfg.seed,
                n_partitions=cfg.build_partitions,
                cross_samples=cfg.build_cross_samples, device=self.device,
                timings=self.build_timings)
        if cfg.attributes is not None:
            from repro_torch.core.tiers import AttributeStore
            if self._backend.attrs is None:
                if man is not None:
                    # a manifest from before the attribute store: recover
                    # with an empty one (every column at its default)
                    self._backend.attach_attrs(AttributeStore(
                        cfg.attributes, cap, device=self.device))
                else:
                    tags, nums = cfg.attributes.coerce(self._init_attrs, n)
                    self._backend.attach_attrs(AttributeStore(
                        cfg.attributes, cap, tags=tags, nums=nums,
                        device=self.device))
            elif self._backend.attrs.schema != cfg.attributes:
                raise ValueError(
                    f"attribute schema mismatch: config declares "
                    f"{cfg.attributes}, the durable index recovered "
                    f"{self._backend.attrs.schema}")
        self._placement = Cache.HostPlacement(
            cap, cfg.cache_slots, dim,
            dtype=torch.bfloat16 if cfg.cache_dtype == "bf16"
            else torch.float32)
        if cfg.pq_enabled:
            if self._backend.pq is None:
                # fresh build: train per-subspace Lloyd codebooks on a
                # sample, encode the seed set, attach the resident code
                # lane (recovery attached it from the snapshot)
                t0 = time.perf_counter()
                m = quant.choose_m(dim, cfg.pq_m)
                cb = quant.train_codebook(
                    init_vectors, m, cfg.pq_bits, iters=cfg.pq_train_iters,
                    sample=cfg.pq_train_sample, seed=cfg.seed,
                    device=self.device)
                self._backend.attach_pq(quant.PQCodes(
                    cb, cap, codes=quant.encode(cb, init_vectors)))
                self.build_timings["pq_s"] = time.perf_counter() - t0
            if cfg.topo_cache_slots >= 0:
                # topology tier for the fused executor; 0 slots -> full
                # residency, warmed so the first batch is already fused
                # (a pure cache: recovery re-warms it here)
                Cache.warm_topo_cache(self._backend, cfg.topo_cache_slots,
                                      device=self.device)
        # spec_rank="auto": probe the disk tier's per-row delta-fetch
        # latency once and pick the frontier predictor from it; without
        # speculation the predictor is unused
        if cfg.spec_rank == "auto":
            if cfg.speculate:
                self._spec_probe_us = probe_fetch_latency(self._backend,
                                                          seed=cfg.seed)
                self._spec_rank = ("dist" if self._spec_probe_us
                                   >= cfg.spec_auto_threshold_us
                                   else "flam")
            else:
                self._spec_rank = "flam"
        # cold-start warm-up (paper §4.4): preload top-E_in rows
        warm_n = min(cfg.cache_slots, n)
        score = np.where(self._backend.alive[:n],
                         self._backend.e_in[:n], -1)
        top = np.argsort(-score, kind="stable")[:warm_n]
        vecs, _ = self._backend.store.peek(top)
        self._placement.warm(top, vecs)
        # graph is a 1-row stub: the capacity tier lives behind the store
        self._state = IndexState(
            graph=init_graph_state(1, dim, cfg.degree, device=self.device),
            cache=self._placement.to_cache_state(self.device),
            stats=init_stats(self.device), tiered=self._backend)
        if cfg.prefetch:
            self._backend.store.start_prefetcher()
        if cfg.wal_enabled:
            if man is None:
                # epoch 0: publish the fresh build, so that the first
                # update already logs against a recoverable base
                t0 = time.perf_counter()
                manifest, self._wal = walmod.publish_snapshot(
                    cfg.disk_path, self._backend, None,
                    group_commit=cfg.wal_group_commit)
                self.build_timings["publish_s"] = time.perf_counter() - t0
                self._durable_epoch = int(manifest["epoch"])
            self._backend.wal = self._wal

    # ------------------------------------------------------------------
    @property
    def tracer(self) -> trace.Tracer:
        """The process-wide tracer (``core/trace.py``) the engine's spans
        go to; off until enabled."""
        return trace.TRACER

    def _next_key(self) -> torch.Generator:
        """A fresh generator on the engine's device, seeded from the
        engine's own (the counterpart of splitting a PRNG key)."""
        with trace.held(self._cache_lock, "cache_lock"), \
                trace.span("engine.sync"):
            seed = int(torch.randint(0, 2 ** 62, (), generator=self._key,
                                     device=self.device))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _read_state(self) -> IndexState:
        if self.cfg.sync:
            with trace.held(self._state_lock, "state_lock"):
                return self._state
        # no-sync ablation: stale snapshot, periodically refreshed
        self._ops_since_refresh += 1
        if self._ops_since_refresh >= self.cfg.stale_refresh:
            self._ops_since_refresh = 0
            with trace.held(self._state_lock, "state_lock"):
                self._stale_state = self._state
        return self._stale_state

    def _publish(self, state: IndexState):
        with trace.held(self._state_lock, "state_lock"):
            self._state = state

    # ------------------------------------------------------------------
    def search(self, queries, update_cache=True, tenant=None,
               deadline=None, filter=None):
        """Batched search. Returns (ids, dists) as numpy. With coalescing
        enabled (default) the request joins the engine's adaptive
        cross-query micro-batch through the SLO serving tier (see
        ``CoalescingScheduler``); ``tenant`` keys the weighted-fair
        admission queue and ``deadline`` (seconds from now) lets the
        dispatcher skip the request once unmeetable."""
        queries = np.asarray(queries, np.float32)
        if self._coalescer is not None and update_cache and len(queries):
            return self._coalescer.search(queries, tenant=tenant,
                                          deadline=deadline, filter=filter)
        return self._search_exec(queries, update_cache, filter=filter)

    def submit_search(self, queries, tenant=None, deadline=None,
                      filter=None):
        """Async entry to the coalescing scheduler: returns a future-like
        handle (``.result() -> (ids, dists)``, ``.latency``)."""
        queries = np.asarray(queries, np.float32)
        if self._coalescer is None:
            fut = _SearchFuture(queries, tenant=tenant, deadline=deadline,
                                filter=filter)
            try:
                fut.ids, fut.dists = self._search_exec(queries,
                                                       filter=filter)
                fut.latency = time.perf_counter() - fut.submitted
            except Exception as e:   # surfaced by result()
                fut.error = e
            fut._event.set()
            return fut
        return self._coalescer.submit(queries, tenant=tenant,
                                      deadline=deadline, filter=filter)

    def _degraded_knobs(self, degrade: int):
        """SearchParams + rerank depth at degradation ``degrade`` (the
        serving tier's pressure level)."""
        return slo.degrade_params(self.cfg.search, self.cfg.rerank_depth,
                                  degrade,
                                  tuple(self.cfg.slo_degrade_order))

    def _search_exec(self, queries, update_cache=True, degrade=0,
                     filter=None):
        """One executor invocation (the coalescer's dispatch target).
        Batches pad to a power of two, as in the reference; pad lanes are
        masked out of the access logs."""
        if self._backend is not None:
            return self._search_tiered(queries, update_cache,
                                       degrade=degrade, filter=filter)
        if filter is not None:
            raise ValueError("filtered search requires the three-tier "
                             "mode with cfg.attributes set")
        if self._shards is not None:
            return self._search_cards(queries, update_cache, degrade)
        with trace.span("engine.search", into=self.latencies["search"]):
            ids, dists = self._search_device(queries, update_cache, degrade)
        with trace.span("engine.sync"):
            dists = dists.cpu().numpy()
        return ids, dists

    def _search_device(self, queries, update_cache, degrade):
        """The device executor and the WAVP placement pass on this
        engine's index; returns (ids as numpy, dists on the device)."""
        sp, _ = self._degraded_knobs(degrade)
        st = self._read_state()
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        B = q.shape[0]
        Bp = 1 << max(0, (B - 1)).bit_length()
        if Bp != B:
            q = torch.cat([q, q.new_zeros((Bp - B, q.shape[1]))])
        res = search_batch(st, q, self._next_key(), sp)
        syncs = res.host_syncs + 1                 # the key's seed
        if Bp != B:
            lane = (torch.arange(Bp, device=self.device) < B)[:, None]
            res = res._replace(ids=res.ids[:B], dists=res.dists[:B],
                               acc_ids=torch.where(lane, res.acc_ids, -1),
                               acc_hit=res.acc_hit & lane)
        with trace.span("engine.sync"):
            ids = res.ids.cpu().numpy()
        if update_cache:
            # placement is applied to the *current* state (the cache
            # tier is shared; graph fields pass through untouched)
            with trace.held(self._state_lock, "state_lock"):
                cur = self._state
                new = Cache.apply_wavp(cur, res.acc_ids, res.acc_hit,
                                       self.cfg.search,
                                       now=self._update_batches)
                self._state = cur._replace(cache=new.cache,
                                           stats=new.stats)
        with trace.held(self._cache_lock, "cache_lock"):
            self.host_syncs += syncs
        return ids, res.dists

    def _search_cards(self, queries, update_cache, degrade):
        """One dispatch over every card: each card's executor runs on its
        worker at once, then the answers, mapped to global ids, are
        merged shard-major (``distributed.merge_shard_results``)."""
        cards = self.cfg.cards
        with trace.span("engine.search", into=self.latencies["search"]):
            jobs = [w.submit(self._search_card, c, queries, update_cache,
                             degrade) for c, w in enumerate(self._workers)]
            futures.wait(jobs)
            parts = [j.result() for j in jobs]
            done = [p[2] for p in parts]
            if trace.TRACER.on:
                trace.record("wait.shard", min(done), max(done))
            with trace.span("shard.merge"):
                ids = np.stack([distributed.interleave_ids(p[0], c, cards)
                                for c, p in enumerate(parts)])
                ids, dists = distributed.merge_shard_results(
                    torch.from_numpy(ids),
                    torch.from_numpy(np.stack([p[1] for p in parts])),
                    self.cfg.search.k)
        return ids.numpy(), dists.numpy()

    def _search_card(self, c, queries, update_cache, degrade):
        """Card ``c``'s share of a dispatch (on its worker thread): (local
        ids, dists, the end on ``perf_counter_ns``)."""
        with trace.span("shard.search"):
            ids, dists = self._shards[c]._search_device(queries,
                                                        update_cache, degrade)
            with trace.span("engine.sync"):
                dists = dists.cpu().numpy()
        self._card_dispatches[c] += 1
        return ids, dists, time.perf_counter_ns()

    def _search_tiered(self, queries, update_cache=True, degrade=0,
                       filter=None):
        """Three-tier search: speculative pipeline + cascading lookup +
        post-batch host placement. Batches pad to a power of two and the
        search seed comes from the engine's numpy stream, as in the
        reference, so the same seed draws the same entry points."""
        with trace.span("engine.search", into=self.latencies["search"]):
            with self._cache_lock:
                seed = int(self._rng.integers(0, 2 ** 31 - 1))
            backend = self._backend
            sp, rerank_depth = self._degraded_knobs(degrade)
            queries = np.asarray(queries, np.float32)
            B = queries.shape[0]
            Bp = 1 << max(0, (B - 1)).bit_length()
            if Bp != B:
                queries = np.concatenate(
                    [queries,
                     np.zeros((Bp - B, queries.shape[1]), np.float32)])
            # one O(N) pass a batch
            f_lam = self._placement.scores(backend.e_in)
            res = search_tiered(
                backend, self._placement, queries, seed, sp, f_lam=f_lam,
                prefetch_budget=(self.cfg.prefetch_budget
                                 if self.cfg.prefetch else 0),
                speculate=self.cfg.speculate, spec_width=self.cfg.spec_width,
                spec_rank=self._spec_rank,
                pq=(backend.pq if self.cfg.pq_enabled else None),
                rerank_depth=rerank_depth,
                topo=(backend.topo if self.cfg.pq_enabled else None),
                fused_rounds=self.cfg.fused_rounds, filter=filter,
                filter_fallback_selectivity=(
                    self.cfg.filter_fallback_selectivity),
                device=self.device)
            if Bp != B:   # drop pad lanes from results AND placement logs
                res = res._replace(ids=res.ids[:B], dists=res.dists[:B],
                                   acc_ids=res.acc_ids[:B],
                                   acc_hit=res.acc_hit[:B])
            with self._cache_lock:    # concurrent search streams share these
                self._search_rounds += res.iters
                self._search_dispatches += res.dispatches
                self._search_batches += 1
                self._spec_hits += res.spec_hits
                self._spec_misses += res.spec_misses
                self._topo_hits += res.topo_hits
                self._topo_misses += res.topo_misses
                if res.filter_path != "none":
                    self._filtered_searches += 1
                    if res.filter_path == "fallback":
                        self._filter_fallbacks += 1
                    self._filter_last_selectivity = res.filter_selectivity
                    self._filter_last_path = res.filter_path
            if update_cache:
                with self._cache_lock:
                    Cache.apply_wavp_host(
                        self._placement, res.acc_ids, res.acc_hit,
                        self.cfg.search, alive=backend.alive,
                        e_in=backend.e_in,
                        fetch_vectors=lambda i: backend.store.fetch(
                            i, f_lam, count=False)[0],
                        now=self._update_batches,
                        cascade_promote=self.cfg.wavp_cascade_promote)
            return res.ids, res.dists

    # ------------------------------------------------------------------
    def insert(self, vectors, chunk=512, attributes=None):
        """Insert vectors (chunked so each chunk links into the graph the
        previous chunks built; a near-empty device-mode index is
        bootstrapped with an exact KNN stitch among the first chunk).
        ``attributes`` (per-field columns, see
        ``filters.AttributeSchema.coerce``) tags the rows for filtered
        search; it needs the three-tier mode with ``cfg.attributes``.
        Returns the new ids."""
        with trace.span("engine.insert", into=self.latencies["insert"]):
            self._check_writable()
            vectors = np.asarray(vectors, np.float32)
            attr_cols = None
            if attributes is not None:
                if self._backend is None or self._backend.attrs is None:
                    raise ValueError("insert(attributes=...) requires the "
                                     "three-tier mode with cfg.attributes "
                                     "set")
                attr_cols = self._backend.attrs.schema.coerce(attributes,
                                                              len(vectors))
            if self._shards is not None:
                return self._insert_cards(vectors, chunk)
            ids = self._apply_insert(vectors, chunk, attr_cols)
            self._maybe_checkpoint()
            return ids

    def _apply_insert(self, vectors, chunk, attr_cols=None):
        """The chunks of one insert on this engine's index, then the
        maintenance they call for; returns the new ids."""
        out = []
        with trace.held(self._update_lock, "update_lock"):
            for s in range(0, len(vectors), chunk):
                part_np = vectors[s:s + chunk]
                if self._backend is not None:
                    part_attrs = None
                    if attr_cols is not None:
                        part_attrs = (attr_cols[0][s:s + chunk],
                                      attr_cols[1][s:s + chunk])
                    out.append(self._insert_tiered(part_np, part_attrs))
                    continue
                part = torch.as_tensor(part_np, device=self.device)
                st = self._state
                rev = None
                if int(st.graph.alive.sum()) < 2 * self.cfg.degree:
                    st2, ids = self._bootstrap_insert(st, part)
                else:
                    n = max(int(st.graph.n), 1)
                    entries = torch.randint(
                        0, n, (len(part_np), self.cfg.search.pool),
                        generator=self._next_key(), dtype=torch.int32,
                        device=self.device)
                    st2, ids, rev = update.insert_batch(st, part, entries,
                                                        self.cfg.search)
                if rev is not None and self._snapshot_n is not None:
                    self._rev_logs.append(rev)
                self._publish(st2)
                self._update_batches += 1
                self._batches_since_repair += 1
                out.append(ids.cpu().numpy())
        self._maybe_maintain()
        return np.concatenate(out) if out else np.zeros((0,), np.int32)

    def _insert_cards(self, vectors, chunk):
        """Hand out the next ids and insert each card's rows on it, the
        cards at once."""
        with trace.held(self._route_lock, "route_lock"):
            ids = np.arange(self._n, self._n + len(vectors), dtype=np.int64)
            card, local = distributed.interleave_route(ids, self.cfg.cards)
            got = self._route(card, lambda s, on: s._apply_insert(
                vectors[on], chunk))
            for c, rows in got.items():
                if not np.array_equal(rows, local[card == c]):
                    raise RuntimeError(
                        f"card {c} placed an insert at rows {rows[:4]}..., "
                        f"not at {local[card == c][:4]}...: the cards' rows "
                        "no longer follow the interleaved ids")
            self._n += len(vectors)
        return ids

    def _route(self, card, apply):
        """``apply(shard, on)`` for every card that ``card`` names, each on
        its card's worker, all at once; returns {card: result} once every
        card has published (the caller holds the route lock)."""
        jobs = {c: self._workers[c].submit(self._route_card, c, apply,
                                           card == c)
                for c in range(len(self._shards)) if (card == c).any()}
        futures.wait(jobs.values())
        return {c: j.result() for c, j in jobs.items()}

    def _route_card(self, c, apply, on):
        with trace.span("shard.route"):
            return apply(self._shards[c], on)

    def _insert_tiered(self, part_np, part_attrs=None):
        """One three-tier insert chunk (caller holds the update lock). A
        failed log write leaves the store untouched and degrades the
        engine to read-only."""
        with self._cache_lock:
            seed = int(self._rng.integers(0, 2 ** 31 - 1))
        try:
            ids, rev = update.insert_tiered(
                self._backend, self._placement, part_np, self.cfg.search,
                seed, attributes=part_attrs, device=self.device)
        except walmod.WALWriteError as e:
            self._degrade(str(e))
        if self._snapshot_n is not None and len(rev.v):
            # consolidation in flight: log the window's reverse edges for
            # the MVCC merge
            self._rev_logs.append(rev)
        topo = self._backend.topo
        if topo is not None and len(ids):
            # write-through topology install: freshly linked rows become
            # device-resident at once, so the next fused search does not
            # stall on them (reverse-edge updates to other resident rows
            # are covered by the write-epoch fence)
            arr = np.asarray(ids, np.int64)
            topo.install(arr, self._backend.store.peek_rows(arr),
                         self._placement.scores(self._backend.e_in))
        self._update_batches += 1
        self._batches_since_repair += 1
        self._batches_since_snapshot += 1
        return np.asarray(ids)

    def _bootstrap_insert(self, st, part):
        """Exact-KNN stitch for a (near-)empty index."""
        g = st.graph
        n0 = int(g.n)
        bi = part.shape[0]
        ids = n0 + torch.arange(bi, dtype=torch.int32, device=self.device)
        vectors = g.vectors.clone()
        vectors[ids.long()] = part.float()
        alive = g.alive.clone()
        alive[ids.long()] = True
        live_ids = torch.nonzero(alive[:n0 + bi]).squeeze(1)
        knn = _exact_knn(vectors[live_ids],
                         min(g.degree, max(1, len(live_ids) - 1)))
        rows = torch.where(knn >= 0, live_ids[knn.clamp(min=0)], -1)
        pad = g.degree - rows.shape[1]
        if pad > 0:
            rows = torch.cat([rows, rows.new_full((rows.shape[0], pad), -1)],
                             dim=1)
        nbrs = g.nbrs.clone()
        nbrs[live_ids] = rows.to(torch.int32)
        g = g._replace(vectors=vectors, alive=alive, nbrs=nbrs,
                       n=torch.tensor(n0 + bi, dtype=torch.int32,
                                      device=self.device))
        g = g._replace(e_in=compute_e_in(g.nbrs, g.capacity))
        return st._replace(graph=g), ids

    def delete(self, ids):
        """Logical deletion (paper §5.2.1). Out-of-range and already
        deleted ids are ignored."""
        with trace.span("engine.delete", into=self.latencies["delete"]):
            self._check_writable()
            if self._shards is not None:
                self._delete_cards(ids)
                return
            self._apply_delete(ids)
            self._maybe_checkpoint()

    def _apply_delete(self, ids):
        """One delete on this engine's index, then the maintenance it
        calls for."""
        with trace.held(self._update_lock, "update_lock"):
            if self._backend is not None:
                # bounds/alive filtering and log-before-write live in
                # update.delete_tiered
                try:
                    update.delete_tiered(self._backend, ids)
                except walmod.WALWriteError as e:
                    self._degrade(str(e))
            else:
                st2 = update.delete_batch(
                    self._state,
                    torch.as_tensor(np.asarray(ids, np.int32),
                                    device=self.device))
                self._publish(st2)
            self._update_batches += 1
            self._batches_since_repair += 1
            self._batches_since_snapshot += 1
        self._maybe_maintain()

    def _delete_cards(self, ids):
        """Delete each id on the card that holds it; ids never handed out
        are ignored, as one card ignores them."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        with trace.held(self._route_lock, "route_lock"):
            ids = ids[(ids >= 0) & (ids < self._n)]
            card, local = distributed.interleave_route(ids, self.cfg.cards)
            self._route(card, lambda s, on: s._apply_delete(local[on]))

    # ------------------------------------------------------------------
    # durability (core/wal.py)
    def _check_writable(self):
        if self._degraded:
            raise ReadOnlyEngineError(
                f"engine is read-only (WAL degraded): {self._degraded}")

    def _degrade(self, reason: str):
        """Log device failure: the engine turns read-only. The failing op
        was not applied (log before write); searches keep serving the
        state before the failure."""
        self._degraded = reason
        raise ReadOnlyEngineError(
            f"WAL write failed; engine degraded to read-only: {reason}")

    def checkpoint(self) -> Optional[int]:
        """Publish the current state as a durable epoch (fsynced snapshot,
        manifest rename, log segment rotation; ``wal.publish_snapshot``).
        Returns the epoch, or None when the engine has no log (device
        mode, or ``wal_enabled=False``)."""
        if self._wal is None or self._wal.closed:
            return None
        self._check_writable()
        with self._update_lock:
            try:
                manifest, new_wal = walmod.publish_snapshot(
                    self.cfg.disk_path, self._backend, self._wal,
                    group_commit=self.cfg.wal_group_commit)
            except (OSError, walmod.WALWriteError) as e:
                self._degrade(f"snapshot publish failed: {e}")
            self._wal = new_wal
            self._backend.wal = new_wal
            self._durable_epoch = int(manifest["epoch"])
            self._batches_since_snapshot = 0
        return self._durable_epoch

    def _maybe_checkpoint(self):
        k = self.cfg.snapshot_every_epochs
        if (self._wal is None or self._degraded or k <= 0
                or self._batches_since_snapshot < k):
            return
        self.checkpoint()

    # ------------------------------------------------------------------
    def _maybe_maintain(self):
        """Deletion-triggered maintenance (paper §5.2). Repair fires once
        per ``repair_every`` update batches (counted since the last scan);
        the deleted fraction is read from a state snapshot taken under
        the lock. Three-tier mode has no localized-repair stage: the
        streaming consolidation covers it."""
        with trace.held(self._update_lock, "update_lock"):
            if self._batches_since_repair >= self.cfg.repair_every:
                self._batches_since_repair = 0
                if self._backend is None:
                    with trace.held(self._state_lock, "state_lock"):
                        st = self._state
                    st, _ = update.repair_affected(
                        st, max_repair=self.cfg.repair_budget,
                        threshold=self.cfg.repair_threshold)
                    # repair only touches the graph: publish that field
                    # alone so cache/stats updates from searches that ran
                    # during the scan are not rolled back
                    with trace.held(self._state_lock, "state_lock"):
                        self._state = self._state._replace(graph=st.graph)
        if self._backend is not None:
            frac = self._backend.deleted_fraction()
        else:
            with trace.held(self._state_lock, "state_lock"):
                graph = self._state.graph
            frac = float(update.deleted_fraction(graph))
        if frac >= self.cfg.consolidate_threshold:
            self.consolidate_async()

    def consolidate_async(self, wait=False):
        """Background global consolidation on an MVCC snapshot (device
        mode) or streamed over the disk tier (three-tier mode). Returns
        the worker thread, or None when a version is already in flight or
        the bounded-version policy defers it; over several cards, a list
        of each card's."""
        if self._shards is not None:
            return [s.consolidate_async(wait) for s in self._shards]
        if self._backend is not None:
            return self._consolidate_tiered_async(wait)
        with trace.held(self._state_lock, "state_lock"):
            if self._snapshot_n is not None:
                return None  # a version is already in flight: defer
            if self._active_versions >= self.cfg.max_versions:
                return None  # bounded-version policy: defer
            snapshot = self._state
            snap_n = int(snapshot.graph.n)
            self._snapshot_n = snap_n
            self._rev_logs = []
            self._active_versions += 1

        def work():
            with trace.held(self._consolidate_gate, "consolidate_gate"), \
                    trace.span("engine.consolidate"):
                consolidated = update.consolidate(snapshot)
                with trace.held(self._update_lock, "update_lock"), \
                        trace.held(self._state_lock, "state_lock"):
                    # per-batch logs, replayed in order by the merge
                    self._state = mvcc.merge_consolidated(
                        consolidated, self._state, snap_n,
                        list(self._rev_logs))
                    self._snapshot_n = None
                    self._rev_logs = []
                    self._active_versions -= 1
                    self._consolidations += 1

        return self._start_background(work, wait)

    def _consolidate_tiered_async(self, wait=False):
        """MVCC-snapshotted tiered consolidation: freeze topology+alive
        under the update lock (brief), rebuild rows off-lock while
        inserts/deletes/searches continue on the active store, then
        publish through ``mvcc.merge_consolidated_tiered`` with the
        window's per-batch reverse-edge logs in one short critical
        section."""
        with self._update_lock:
            with self._state_lock:
                if self._snapshot_n is not None:
                    return None  # a version is already in flight: defer
                if self._active_versions >= self.cfg.max_versions:
                    return None  # bounded-version policy: defer
                self._active_versions += 1
            snap = mvcc.snapshot_tiered(self._backend)
            with self._state_lock:
                self._snapshot_n = snap.n
                self._rev_logs = []

        def work():
            try:
                new_rows = update.consolidate_tiered(self._backend,
                                                     snapshot=snap)
                with self._update_lock, self._state_lock:
                    # per-batch logs, replayed in order by the merge
                    mvcc.merge_consolidated_tiered(
                        self._backend, snap, new_rows, list(self._rev_logs))
            except walmod.WALWriteError as e:
                # merge not applied (log before write): read-only from now
                self._degraded = str(e)
            finally:
                with self._state_lock:
                    self._snapshot_n = None
                    self._rev_logs = []
                    self._active_versions -= 1
                    self._consolidations += 1

        return self._start_background(work, wait)

    def _start_background(self, work, wait):
        th = threading.Thread(target=work, daemon=True)
        th.start()
        self._bg_threads.append(th)
        if wait:
            th.join()
        return th

    def wait_background(self):
        if self._shards is not None:
            for s in self._shards:
                s.wait_background()
            return
        for th in self._bg_threads:
            th.join()
        self._bg_threads = []

    @property
    def state(self) -> IndexState:
        if self._shards is not None:
            # the cards' published graphs read by global id, and their
            # placement counters added up; each card's cache stays its own
            parts = [s.state for s in self._shards]
            with trace.held(self._route_lock, "route_lock"):
                n = self._n
            return IndexState(
                graph=distributed.InterleavedGraph.of(
                    n, [p.graph for p in parts]),
                cache=None,
                stats=Stats(*(torch.tensor(sum(int(x) for x in f))
                              for f in zip(*(p.stats for p in parts)))))
        with self._state_lock:
            st = self._state
        if self._backend is not None:
            # tiered mode: the cache/stats view is materialized on demand
            # from the host mirrors
            with self._cache_lock:
                st = st._replace(
                    cache=self._placement.to_cache_state(self.device),
                    stats=self._placement.to_stats(self.device))
            with self._state_lock:
                self._state = st
        return st

    def stats(self) -> dict:
        """Placement counters, miss rate, index size, the tiered mode's
        tier, executor, speculation, topology and byte counters,
        coalescer/SLO counters, and ``modeled_us_per_access``: the
        reference's formula over the observed hits, capacity-tier
        computes and transfers, with the per-vector costs that
        ``calibrate.measure`` takes on this engine's device at the first
        call (the reference takes a TPU v5e's constants)."""
        st = self.state
        s = st.stats
        d = {k: int(v) for k, v in s._asdict().items()}
        d["miss_rate"] = Cache.miss_rate(s)
        if self._backend is not None:
            d.update(self._tiered_stats())
            dim = self._backend.dim
        elif self._shards is not None:
            d["n"] = st.graph.n
            d["shards"] = [self._card_stats(c)
                           for c in range(len(self._shards))]
            d["alive"] = sum(x["alive"] for x in d["shards"])
            dim = self._shards[0].state.graph.vectors.shape[1]
        else:
            d["n"] = int(st.graph.n)
            d["alive"] = int(st.graph.alive.sum())
            dim = st.graph.vectors.shape[1]
        d["consolidations"] = self._consolidations
        if self._coalescer is not None:
            c = self._coalescer
            d["coalesce_requests"] = c.requests
            d["coalesce_dispatches"] = c.dispatches
            d["coalesce_batch_mean"] = c.queries / max(c.dispatches, 1)
            d["coalesce_window_us"] = c.window * 1e6
            d["coalesce_overshoot_avoided"] = c.tier.overshoot_avoided
            d["degraded_dispatches"] = c.degraded_dispatches
            d["slo"] = c.tier.stats()
        if self._cost_model is None:   # two first calls may both measure
            self._cost_model = calibrate.measure(dim, device=self.device)
        cm = self._cost_model
        acc = max(d["accesses"], 1)
        modeled = (d["hits"] * cm.t_fast + d["cpu_computed"] * cm.t_slow
                   + d["transfers"] * cm.t_transfer)
        d["modeled_us_per_access"] = modeled / acc * 1e6
        return d

    def _card_stats(self, c) -> dict:
        shard = self._shards[c]
        graph = shard.state.graph
        return {"n": int(graph.n), "alive": int(graph.alive.sum()),
                "dispatches": self._card_dispatches[c],
                "consolidations": shard._consolidations,
                "host_syncs": shard.host_syncs}

    def _tiered_stats(self) -> dict:
        be = self._backend
        d = {"n": int(be.n), "alive": int(be.alive[:be.n].sum())}
        d.update(be.tier_counts())
        nb = max(self._search_batches, 1)
        d["search_rounds_per_batch"] = self._search_rounds / nb
        d["search_dispatches_per_batch"] = self._search_dispatches / nb
        d["dispatches_per_query"] = self._search_dispatches / nb
        d["topo_hits"] = self._topo_hits
        d["topo_misses"] = self._topo_misses
        d["topo_hit_rate"] = (self._topo_hits
                              / max(self._topo_hits + self._topo_misses, 1))
        d["spec_hits"] = self._spec_hits
        d["spec_misses"] = self._spec_misses
        d["spec_hit_rate"] = (self._spec_hits
                              / max(self._spec_hits + self._spec_misses, 1))
        d["spec_rank_resolved"] = self._spec_rank
        if self._spec_probe_us is not None:
            d["spec_probe_us_per_row"] = self._spec_probe_us
        # durability: the degraded flag is the read-only contract
        d["degraded"] = bool(self._degraded)
        d["wal_enabled"] = self._wal is not None
        if self._wal is not None:
            d["wal_last_seq"] = self._wal.last_seq
            d["wal_records"] = self._wal.appended
            d["durable_epoch"] = self._durable_epoch
        d["filtered_searches"] = self._filtered_searches
        d["filter_fallbacks"] = self._filter_fallbacks
        d["filter_last_selectivity"] = self._filter_last_selectivity
        d["filter_last_path"] = self._filter_last_path
        d["filter_fallback_selectivity"] = \
            self.cfg.filter_fallback_selectivity
        if self._recovery is not None:
            d["recovered_epoch"] = self._recovery["epoch"]
            d["recovered_replayed"] = self._recovery["replayed"]
            d["recovered_to_seq"] = self._recovery["last_seq"]
            d["recovered_truncated_bytes"] = \
                self._recovery["truncated_bytes"]
        bpt = be.bytes_per_tier()
        bpt["device_exact_cache"] = self._placement.vector_bytes
        d["bytes_per_tier"] = bpt
        d["device_exact_equiv_bytes"] = max(int(be.n), 1) * be.dim * 4
        if be.pq is not None:
            d["device_vector_bytes"] = (bpt["device_codes"]
                                        + bpt["device_exact_cache"])
            d["device_footprint_ratio"] = (bpt["device_codes"]
                                           / d["device_exact_equiv_bytes"])
            d["pq_m"] = be.pq.m
            d["pq_bits"] = be.pq.bits
            sp = self.cfg.search
            d["rerank_depth"] = effective_rerank_depth(self.cfg.rerank_depth,
                                                       sp.k, sp.pool)
        return d

    def close(self):
        """Wait for background consolidations, stop the coalescer's
        dispatcher (failing any queued request), publish a final durable
        epoch (a clean shutdown reopens with no WAL replay) and, in
        three-tier mode, stop the prefetcher and flush the disk tier;
        over several cards, stop the card workers and close each card's
        engine."""
        self.wait_background()
        if self._coalescer is not None:
            self._coalescer.stop()
        if self._shards is not None:
            for w in self._workers:
                w.shutdown()
            for s in self._shards:
                s.close()
        if self._wal is not None and not self._degraded \
                and not self._wal.closed:
            try:
                self.checkpoint()
            except ReadOnlyEngineError:   # the log died at shutdown: the
                pass                      # last published epoch stands
        if self._backend is not None:
            self._backend.close()
        if self._wal is not None:
            self._wal.close()


class MultiStreamRunner:
    """Search/update streams over the engine (the multi-stream analogue):
    search requests flow through the engine's cross-query coalescing
    scheduler, plus one dedicated update stream consuming an op queue.
    ``n_search_streams`` bounds the requests concurrently in flight (each
    stream submits one and waits on its future, which is what lets the
    coalescer merge across streams). Merge depth and window belong to
    the engine (``coalesce_max_batch`` / ``coalesce_window``): the
    reference's unused ``max_batch`` / ``batch_timeout`` are left out."""

    def __init__(self, engine: SVFusionEngine, n_search_streams=2):
        self.engine = engine
        self.n_search_streams = n_search_streams
        self._q: queue.Queue = queue.Queue()
        self._sq: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._threads = []
        self.results: list = []
        self.errors: list = []
        # requests rejected by the SLO tier (shed / deadline-missed) land
        # here, not in ``errors``: the admission policy working as designed
        self.shed: list = []

    def start(self):
        self._threads = [threading.Thread(target=self._update_worker,
                                          daemon=True)]
        for _ in range(self.n_search_streams):
            self._threads.append(threading.Thread(target=self._search_worker,
                                                  daemon=True))
        for t in self._threads:
            t.start()

    def submit_search(self, queries, tag=None, deadline=None):
        """``tag`` doubles as the request's tenant id in the engine's SLO
        admission tier (None -> default tenant); ``deadline`` is seconds
        from dispatch-by-the-worker after which the answer is worthless."""
        self._sq.put((np.asarray(queries, np.float32), tag, deadline,
                      time.perf_counter()))

    def submit_insert(self, vectors):
        self._q.put(("insert", np.asarray(vectors, np.float32)))

    def submit_delete(self, ids):
        self._q.put(("delete", np.asarray(ids, np.int64)))

    def _search_worker(self):
        while not self._stop.is_set():
            try:
                qarr, tag, deadline, t0 = self._sq.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                ids, _ = self.engine.search(qarr, tenant=tag,
                                            deadline=deadline)
                self.results.append((tag, ids, time.perf_counter() - t0))
            except slo.SLOError as e:
                self.shed.append((tag, e))
            except Exception as e:
                self.errors.append(e)

    def _update_worker(self):
        while not self._stop.is_set():
            try:
                op, payload = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                if op == "insert":
                    self.engine.insert(payload)
                else:
                    self.engine.delete(payload)
            except Exception as e:
                self.errors.append(e)

    def drain_and_stop(self, timeout=60.0):
        t0 = time.perf_counter()
        while (not self._sq.empty() or not self._q.empty()) \
                and time.perf_counter() - t0 < timeout:
            time.sleep(0.01)
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self.errors:
            raise self.errors[0]
