"""Three-tier store (twin of ``repro.core.tiers``): device cache / host
DRAM / disk.

The disk tier holds vectors and graph rows in ``np.memmap`` files
(``vectors.npy``, ``nbrs.npy``) laid out as the reference lays them out,
so the port opens a directory the reference wrote. A residency directory
tracks the host window, whose coldest residents by F_λ are demoted when
it fills; a background thread prefetches predicted frontiers so disk
reads overlap device work. Host-only numpy, as in the reference.

Thread-safety: ``fetch``/``peek``/``write`` serialize on one reentrant
lock. The prefetcher reads the disk outside the lock and re-validates
residency and the store's write epoch before installing. Its queue is
bounded: under overload new predictions are dropped. Free slots are
handed out by a monotone cursor.

``AttributeStore`` holds the per-id columns of filtered search, host
truth and a torch mirror on the backend's device; ``TieredBackend.wal``
is the write-ahead log the update path appends to before it mutates the
store (``core/wal.py``).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np
import torch


class DiskTier:
    """Memory-mapped vector + graph store."""

    def __init__(self, path: str, capacity: int, dim: int, degree: int,
                 create=True):
        os.makedirs(path, exist_ok=True)
        mode = "w+" if create else "r+"
        self.vec = np.memmap(os.path.join(path, "vectors.npy"), np.float32,
                             mode, shape=(capacity, dim))
        self.nbr = np.memmap(os.path.join(path, "nbrs.npy"), np.int32,
                             mode, shape=(capacity, degree))
        if create:
            self.nbr[:] = -1
        self.capacity, self.dim, self.degree = capacity, dim, degree

    def write(self, ids, vectors=None, nbrs=None):
        if vectors is not None:
            self.vec[ids] = vectors
        if nbrs is not None:
            self.nbr[ids] = nbrs

    def read(self, ids):
        return np.asarray(self.vec[ids]), np.asarray(self.nbr[ids])

    def flush(self):
        """Durable flush: ``mmap.flush`` writes dirty pages back but does
        not guarantee they reach stable storage on all platforms — follow
        with an ``os.fsync`` on each backing file (an O_RDONLY fd is
        enough to fsync on POSIX)."""
        for mm in (self.vec, self.nbr):
            mm.flush()
            fd = os.open(mm.filename, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


class TieredStore:
    """Host window over a disk-resident dataset.

    Residency directory: ``loc[id] = slot`` into the host window or -1.
    Demotion policy: lowest-F_λ residents leave the host window first.
    """

    def __init__(self, disk: DiskTier, host_slots: int):
        self.disk = disk
        self.host_slots = host_slots
        self.host_vec = np.zeros((host_slots, disk.dim), np.float32)
        self.host_nbr = np.full((host_slots, disk.degree), -1, np.int32)
        self.loc = np.full((disk.capacity,), -1, np.int64)      # id -> slot
        self.slot_id = np.full((host_slots,), -1, np.int64)     # slot -> id
        self.hits = 0
        self.misses = 0
        self.demotions = 0
        self.prefetched = 0
        self.prefetch_dropped = 0
        self._lock = threading.RLock()
        self._free_cursor = 0           # slots are allotted once, never freed
        self._write_epoch = 0           # bumped by write(); guards installs
        self._prefetch_q: queue.Queue = queue.Queue(maxsize=64)
        self._stop = threading.Event()
        self._th: Optional[threading.Thread] = None

    # -- residency ------------------------------------------------------
    def fetch(self, ids: np.ndarray, f_lambda: Optional[np.ndarray] = None,
              *, count: bool = True):
        """Read rows, promoting misses into the host window (demote lowest
        F_λ residents when full). Returns (vectors, nbr_rows) copies."""
        ids = np.asarray(ids)
        with self._lock:
            out_v = np.empty((len(ids), self.disk.dim), np.float32)
            out_n = np.empty((len(ids), self.disk.degree), np.int32)
            slots = self.loc[ids]
            hit = slots >= 0
            if count:
                self.hits += int(hit.sum())
                self.misses += int((~hit).sum())
            out_v[hit] = self.host_vec[slots[hit]]
            out_n[hit] = self.host_nbr[slots[hit]]
            miss_ids = ids[~hit]
            if miss_ids.size:
                dv, dn = self.disk.read(miss_ids)
                out_v[~hit] = dv
                out_n[~hit] = dn
                self._promote(miss_ids, dv, dn, f_lambda)
            return out_v, out_n

    def peek(self, ids: np.ndarray):
        """Read rows through the window overlay WITHOUT promotion or
        counter updates (maintenance scans must not thrash the window)."""
        ids = np.asarray(ids)
        with self._lock:
            out_v = np.empty((len(ids), self.disk.dim), np.float32)
            out_n = np.empty((len(ids), self.disk.degree), np.int32)
            slots = self.loc[ids]
            hit = slots >= 0
            out_v[hit] = self.host_vec[slots[hit]]
            out_n[hit] = self.host_nbr[slots[hit]]
            if (~hit).any():
                dv, dn = self.disk.read(ids[~hit])
                out_v[~hit] = dv
                out_n[~hit] = dn
            return out_v, out_n

    def fetch_rows(self, ids: np.ndarray,
                   f_lambda: Optional[np.ndarray] = None, *,
                   count: bool = True):
        """Adjacency-only ``fetch`` (the speculative pipeline's delta-fetch
        API): window hits skip the vector copy entirely; misses read both
        halves from disk — the promotion install needs the vectors anyway
        — and promote exactly like ``fetch``. Returns nbr rows, a copy."""
        ids = np.asarray(ids)
        with self._lock:
            out_n = np.empty((len(ids), self.disk.degree), np.int32)
            slots = self.loc[ids]
            hit = slots >= 0
            if count:
                self.hits += int(hit.sum())
                self.misses += int((~hit).sum())
            out_n[hit] = self.host_nbr[slots[hit]]
            miss_ids = ids[~hit]
            if miss_ids.size:
                dv, dn = self.disk.read(miss_ids)
                out_n[~hit] = dn
                self._promote(miss_ids, dv, dn, f_lambda)
            return out_n

    @property
    def write_epoch(self) -> int:
        """Monotone write counter (reading an int is atomic under the
        GIL): speculative staging snapshots it and flushes its memos when
        it moves — a staged row must never outlive a concurrent write."""
        return self._write_epoch

    def peek_rows(self, ids: np.ndarray):
        """Adjacency-only ``peek``: rows through the window overlay
        without promotion, counters, or the vector copy. The MVCC
        snapshot and the prefetch predictor read topology at scale —
        copying D floats per id alongside would dominate their cost."""
        ids = np.asarray(ids)
        with self._lock:
            out_n = np.empty((len(ids), self.disk.degree), np.int32)
            slots = self.loc[ids]
            hit = slots >= 0
            out_n[hit] = self.host_nbr[slots[hit]]
            if (~hit).any():
                out_n[~hit] = np.asarray(self.disk.nbr[ids[~hit]])
            return out_n

    def write(self, ids, vectors=None, nbrs=None):
        """Write-through update: disk always, host window where resident
        (keeps the overlay coherent without dirty tracking; demotion
        write-back then never loses updates)."""
        ids = np.asarray(ids)
        with self._lock:
            self._write_epoch += 1
            self.disk.write(ids, vectors, nbrs)
            slots = self.loc[ids]
            res = slots >= 0
            if res.any():
                if vectors is not None:
                    self.host_vec[slots[res]] = np.asarray(vectors)[res]
                if nbrs is not None:
                    self.host_nbr[slots[res]] = np.asarray(nbrs)[res]

    def _promote(self, ids, vecs, nbrs, f_lambda):
        """Install missed rows (already read) into the window. Caller holds
        the lock; ids may contain duplicates."""
        uniq, first = np.unique(np.asarray(ids), return_index=True)
        fresh = self.loc[uniq] < 0
        uniq, first = uniq[fresh], first[fresh]
        if uniq.size > self.host_slots:
            # miss batch alone exceeds the window: admit the hottest subset
            if f_lambda is not None:
                keep = np.argsort(
                    -np.asarray(f_lambda, np.float64)[uniq])[:self.host_slots]
            else:
                keep = np.arange(self.host_slots)
            uniq, first = uniq[keep], first[keep]
        m = uniq.size
        if not m:
            return
        slots = np.empty((m,), np.int64)
        take = min(m, self.host_slots - self._free_cursor)
        if take > 0:
            slots[:take] = np.arange(self._free_cursor,
                                     self._free_cursor + take)
            self._free_cursor += take
        spill = m - take
        if spill > 0:
            # demote the lowest-F_λ residents; slots allotted above are
            # still unpublished (slot_id == -1) and must not be victims
            res_ids = self.slot_id
            if f_lambda is not None:
                key = np.asarray(f_lambda,
                                 np.float64)[np.clip(res_ids, 0, None)].copy()
            else:
                key = np.random.random(self.host_slots)
            key[res_ids < 0] = np.inf
            victims = np.argpartition(key, spill - 1)[:spill]
            old = res_ids[victims]
            self.disk.write(old, self.host_vec[victims],
                            self.host_nbr[victims])
            self.loc[old] = -1
            self.demotions += int(spill)
            slots[take:] = victims
        self.host_vec[slots] = vecs[first]
        self.host_nbr[slots] = nbrs[first]
        self.slot_id[slots] = uniq
        self.loc[uniq] = slots

    # -- async prefetch ---------------------------------------------------
    def start_prefetcher(self):
        if self._stop.is_set():     # stop() is terminal (close in flight)
            return

        def work():
            while not self._stop.is_set():
                try:
                    ids, f_lam = self._prefetch_q.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._prefetch_one(np.unique(ids), f_lam)
        self._th = threading.Thread(target=work, daemon=True)
        self._th.start()

    def _prefetch_one(self, ids, f_lam):
        """One overlapped prefetch: residency probe under the lock, disk
        read OUTSIDE it, install re-validated against the write epoch."""
        with self._lock:
            miss = ids[self.loc[ids] < 0]
            epoch = self._write_epoch
        if not miss.size:
            return
        dv, dn = self.disk.read(miss)          # overlaps foreground work
        with self._lock:
            if self._write_epoch != epoch:
                self.prefetch_dropped += len(miss)
                return                         # a write raced the read
            still = self.loc[miss] < 0
            if still.any():
                self._promote(miss[still], dv[still], dn[still], f_lam)
                self.prefetched += int(still.sum())

    def prefetch(self, ids, f_lambda: Optional[np.ndarray] = None):
        if self._stop.is_set():
            return                  # shutdown in flight: never enqueue work
            #                         the closing disk tier would receive
        try:
            self._prefetch_q.put_nowait((np.asarray(ids), f_lambda))
        except queue.Full:
            self.prefetch_dropped += len(ids)  # overload: drop, don't lag

    def stop(self):
        """Terminal shutdown: the worker MUST be joined before the caller
        closes/flushes the disk tier, or an in-flight ``_prefetch_one``
        can still be mid-write when the memmaps go away. ``prefetch`` and
        ``start_prefetcher`` are no-ops afterwards."""
        self._stop.set()
        th = self._th
        if th is not None:
            th.join(timeout=10.0)
            if th.is_alive():       # pragma: no cover - worker is bounded
                raise RuntimeError("prefetcher failed to stop; refusing to "
                                   "close the disk tier under it")
            self._th = None

    @property
    def resident(self) -> int:
        return int((self.slot_id >= 0).sum())

    @property
    def miss_rate(self):
        tot = self.hits + self.misses
        return self.misses / tot if tot else 0.0


class AttributeStore:
    """Per-id fixed-schema attribute columns for filtered search
    (``core.filters``): one int32 column per tag field and one fp32
    column per numeric field, over the whole id space.

    The ``quant.PQCodes`` pattern: host-truth numpy columns written
    through by ``update.insert_tiered``, a torch mirror on ``device``
    that ``synced`` brings up to date with one ``index_copy_`` per column
    into a copy (a search holding the previous mirror is never torn), and
    a locked ``snapshot`` for the durability layer. Attributes are
    immutable per id, so consolidation never rewrites them."""

    def __init__(self, schema, capacity: int, tags=None, nums=None,
                 device="cuda"):
        self.schema = schema
        self.capacity = int(capacity)
        self.tags = np.zeros((self.capacity, schema.n_tags), np.int32)
        self.nums = np.zeros((self.capacity, schema.n_nums), np.float32)
        if tags is not None:
            self.tags[:len(tags)] = np.asarray(tags, np.int32)
        if nums is not None:
            self.nums[:len(nums)] = np.asarray(nums, np.float32)
        self._tags_t = torch.tensor(self.tags, device=device)
        self._nums_t = torch.tensor(self.nums, device=device)
        self._dirty: list = []
        self._lock = threading.Lock()
        self.written = 0    # ids written through (stats)

    @property
    def device(self) -> torch.device:
        return self._tags_t.device

    def write(self, ids, tags, nums):
        """Write-through install for freshly inserted ids: host truth
        now, the mirror at the next ``synced``."""
        ids = np.asarray(ids, np.int64)
        if not len(ids):
            return
        with self._lock:
            self.tags[ids] = np.asarray(tags, np.int32)
            self.nums[ids] = np.asarray(nums, np.float32)
            self._dirty.append(ids.copy())
            self.written += len(ids)

    def synced(self):
        """(tags, nums) mirror with every host write folded in, one
        ``index_copy_`` per column however many batches accumulated."""
        with self._lock:
            if self._dirty:
                ids = np.unique(np.concatenate(self._dirty))
                self._dirty = []
                idx = torch.as_tensor(ids, device=self.device)
                self._tags_t = self._tags_t.clone().index_copy_(
                    0, idx, torch.as_tensor(self.tags[ids],
                                            device=self.device))
                self._nums_t = self._nums_t.clone().index_copy_(
                    0, idx, torch.as_tensor(self.nums[ids],
                                            device=self.device))
            return self._tags_t, self._nums_t

    def snapshot(self, n: int):
        """Consistent host-truth copy of the live prefix (the durability
        snapshot; taken under the write lock)."""
        with self._lock:
            return self.tags[:n].copy(), self.nums[:n].copy()

    def attr_bytes(self, n: int) -> int:
        return int(n) * (self.schema.n_tags * 4 + self.schema.n_nums * 4)


class TieredBackend:
    """Disk-backed capacity tier for ``SVFusionEngine``.

    Bundles the TieredStore with the host-resident graph metadata the
    paper keeps in DRAM directories (alive bitset, in-degrees, versions,
    high-water mark) — a few bytes per id, vs. D·4 bytes per vector, so
    the directory fits in memory even when vectors/rows do not.
    Mutations happen under the engine's update stream; searches read the
    arrays lock-free (numpy loads of a published array are atomic enough
    for the approximate structures involved).
    """

    def __init__(self, store: TieredStore, n: int):
        cap = store.disk.capacity
        self.store = store
        self.n = int(n)
        self.alive = np.zeros((cap,), bool)
        self.e_in = np.zeros((cap,), np.int32)
        self.version = np.zeros((cap,), np.int32)
        self.pq = None      # quant.PQCodes lane (attach_pq); codes are a
        #                     directory-style array: unconditionally
        #                     host+device resident, written through by
        #                     update.insert_tiered's incremental encode
        self.topo = None    # cache.TopoCache row-slot lane (attach_topo):
        #                     device-resident adjacency rows for the fused
        #                     multi-round executor, F_λ-ordered residency,
        #                     epoch-fenced against store writes
        self.wal = None     # wal.WriteAheadLog: when attached, the update
        #                     path logs each op before mutating the store;
        #                     owned by the engine
        self.attrs = None   # AttributeStore (attach_attrs): per-id tag /
        #                     numeric columns of the filtered search

    def attach_topo(self, topo) -> None:
        """Attach the device-resident topology row cache
        (``cache.TopoCache``). Its id->slot directory spans the whole id
        space like alive/e_in; the fused executor installs rows on demand
        and validates against the store's write epoch per host re-entry."""
        if topo.capacity != self.capacity:
            raise ValueError(
                f"topo cache spans {topo.capacity} ids, disk capacity is "
                f"{self.capacity}")
        if topo.degree != self.degree:
            raise ValueError(
                f"topo cache rows are degree {topo.degree}, graph degree "
                f"is {self.degree}")
        self.topo = topo

    def attach_pq(self, pq) -> None:
        """Attach the PQ code lane (``quant.PQCodes``). The lane's code
        array spans the whole id space like alive/e_in; inserts encode
        incrementally into it (write-through), searches read the epoch-
        synced device mirror."""
        if pq.codes.shape[0] != self.capacity:
            raise ValueError(
                f"pq codes span {pq.codes.shape[0]} ids, disk capacity is "
                f"{self.capacity}")
        self.pq = pq

    def attach_attrs(self, attrs) -> None:
        """Attach the per-id attribute lane (``AttributeStore``), which
        spans the whole id space like alive/e_in."""
        if attrs.capacity != self.capacity:
            raise ValueError(
                f"attribute store spans {attrs.capacity} ids, disk "
                f"capacity is {self.capacity}")
        self.attrs = attrs

    @property
    def capacity(self) -> int:
        return self.store.disk.capacity

    @property
    def dim(self) -> int:
        return self.store.disk.dim

    @property
    def degree(self) -> int:
        return self.store.disk.degree

    def deleted_fraction(self) -> float:
        n = max(self.n, 1)
        return float((~self.alive[:self.n]).sum()) / n

    def tier_counts(self) -> dict:
        s = self.store
        out = {"host_hits": s.hits, "disk_reads": s.misses,
               "host_miss_rate": s.miss_rate, "demotions": s.demotions,
               "prefetched": s.prefetched,
               "prefetch_dropped": s.prefetch_dropped,
               "host_resident": s.resident}
        if self.pq is not None:
            out["pq_encoded_incremental"] = self.pq.encoded
        if self.attrs is not None:
            out["attrs_written"] = self.attrs.written
        if self.topo is not None:
            t = self.topo
            out.update(topo_hits=t.hits, topo_misses=t.misses,
                       topo_hit_rate=t.hit_rate, topo_installs=t.installs,
                       topo_evictions=t.evictions, topo_flushes=t.flushes,
                       topo_resident=t.resident)
        return out

    def bytes_per_tier(self) -> dict:
        """Allocated byte footprint of each tier's payload arrays (the
        device exact-vector cache belongs to HostPlacement; the engine
        merges it in). ``device_codes`` counts the PQ lane's resident
        codes over the live id space [0, n) — the allocated [capacity, m]
        array is sized for growth headroom, like the disk memmaps."""
        s = self.store
        out = {
            "host_window": int(s.host_vec.nbytes + s.host_nbr.nbytes),
            "disk": int(self.capacity
                        * (self.dim * 4 + self.degree * 4)),
            "device_codes": (self.pq.code_bytes(self.n)
                             if self.pq is not None else 0),
            # topology row slots + id->slot directory (the fused
            # executor's device-resident adjacency lane)
            "device_topo_rows": (self.topo.row_bytes
                                 if self.topo is not None else 0),
            # attribute columns: host and device resident like PQ codes
            "host_attrs": (self.attrs.attr_bytes(self.n)
                           if self.attrs is not None else 0),
        }
        return out

    def close(self):
        # join the prefetcher BEFORE flushing/abandoning the memmaps: a
        # worker mid-``_prefetch_one`` must never outlive the disk tier
        self.store.stop()
        self.store.disk.flush()


def probe_fetch_latency(backend: TieredBackend, *, batches: int = 4,
                        batch: int = 64, seed: int = 0) -> float:
    """Measure the per-row delta-fetch latency (microseconds) of the disk
    tier with a short random-read probe. This is the quantity the
    ``spec_rank`` default hinges on (ROADMAP): exact host re-ranking of
    the frontier prediction (``"dist"``) costs ~ms of host compute per
    round and only pays for itself when mispredicted delta fetches are
    genuinely IO-bound — true on a real SSD (~100 µs/row), false on a
    page-cache-backed "disk" (~1 µs/row). Reads go straight to the memmap
    (no window promotion, no counter pollution); the probe runs once at
    engine startup.

    Two cache effects would otherwise defeat the measurement: the probe
    runs right after the index build wrote every row, so the pages are
    warm AND dirty (flush first — DONTNEED cannot free dirty pages, then
    evict each probed id's page range with ``posix_fadvise(DONTNEED)``);
    and mispredict delta fetches are *scattered* ids, so the probe reads
    scattered single rows — a contiguous span would amortize onto a
    couple of page faults plus readahead and measure ~sequential
    latency. On tmpfs/ramdisk the advise is a no-op and the probe
    correctly measures memory speed."""
    import time
    rng = np.random.default_rng(seed)
    disk = backend.store.disk
    n = max(backend.n, 1)
    page = 4096
    ids = rng.integers(0, n, batches * batch)     # scattered, like misses
    fds = []
    try:
        # a delta fetch reads BOTH memmaps (vectors + adjacency): evict
        # each probed id's page range in each file, or the warm half
        # understates the cold cost by up to 2x
        for mm, row_bytes in ((disk.vec, disk.dim * 4),
                              (disk.nbr, disk.degree * 4)):
            try:
                fd = os.open(mm.filename, os.O_RDONLY)
            except (OSError, TypeError, AttributeError):
                continue
            fds.append(fd)
            if hasattr(os, "posix_fadvise"):
                mm.flush()      # dirty pages are not evictable
                for i in ids:   # evict BEFORE timing starts
                    off = int(i) * row_bytes // page * page
                    os.posix_fadvise(fd, off, row_bytes + page,
                                     os.POSIX_FADV_DONTNEED)
        t0 = time.perf_counter()
        for s in range(0, len(ids), batch):
            disk.read(ids[s:s + batch])
        dt = time.perf_counter() - t0
    finally:
        for fd in fds:
            os.close(fd)
    return dt / max(len(ids), 1) * 1e6
