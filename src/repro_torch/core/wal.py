"""Durability layer of the three-tier store (twin of ``repro.core.wal``):
write-ahead log, epoch-fenced snapshots and crash recovery.

The disk tier is the crash-consistent truth; every device-resident
structure (the exact-vector cache, the PQ code mirror, the topology
cache, the attribute mirror) is a pure cache rebuilt at recovery.

Write protocol (the engine's update stream serializes it):

1. prepare: compute the op's full effect against the unmutated store;
2. append: one CRC-framed record per logical op, fsynced in groups of
   ``group_commit`` (a process kill cannot lose an appended record: the
   log is unbuffered; a torn tail is truncated at recovery);
3. apply: mutate the store through the same apply function that
   recovery replays, so a recovered index equals an uninterrupted run.

Snapshot protocol (``publish_snapshot``): fsync the log and the memmaps,
write ``snapshot-<epoch>.npz`` (adjacency rows [0, n), alive, e_in,
version, the PQ codebook and codes, the attribute columns), fsync and
rename it, open a fresh log segment, then rename ``manifest.json`` over
the previous one. A crash anywhere leaves the previous manifest and its
pair intact.

Recovery (``recover``): check the snapshot against the manifest's CRC,
restore the metadata and rows (rows past the snapshot's high-water mark
are cleared), then replay the log segment through the apply functions up
to the first frame that fails its check.

The on-disk format is the reference's, byte for byte: a directory
published by either package is recovered by the other. Record payloads
hold numpy arrays only, so that reading them needs neither torch nor
JAX. Host-only numpy, like the reference; ``recover`` rebuilds the PQ
codebook and the attribute mirror on the engine's ``device``.

Fault injection: ``set_crash_hook`` installs a hook that
``crash_point(name)`` calls at the named sites (``CRASH_POINTS``); a test
arms it with ``os._exit`` to simulate kill -9 there.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import struct
import threading
import zlib
from typing import Callable, Optional

import numpy as np

MAGIC = b"SVWL"
_HDR = struct.Struct("<4sBQII")       # magic, rtype, op_seq, payload_len, crc
MANIFEST = "manifest.json"
MANIFEST_FORMAT = 1

REC_INSERT = 1
REC_DELETE = 2
REC_CONSOLIDATE = 3


class WALError(RuntimeError):
    """Base class for durability-layer failures."""


class WALWriteError(WALError):
    """The log device failed an append or sync; the op was NOT applied.
    The engine degrades to read-only instead of crashing."""


class WALCorruptionError(WALError):
    """Manifest or snapshot failed validation at recovery."""


# ---------------------------------------------------------------------------
# Crash-point hooks (fault injection)
# ---------------------------------------------------------------------------

_CRASH_HOOK: Optional[Callable[[str], None]] = None

CRASH_POINTS = ("post_wal_append", "mid_memmap_write",
                "pre_manifest_rename", "mid_consolidation_merge")


def set_crash_hook(hook: Optional[Callable[[str], None]]) -> None:
    """Install (or clear, with None) the process-wide crash hook. It
    receives the crash point's name at every pass through a site."""
    global _CRASH_HOOK
    _CRASH_HOOK = hook


def crash_point(name: str) -> None:
    """Named crash site; free when no hook is installed."""
    hook = _CRASH_HOOK
    if hook is not None:
        hook(name)


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------

def _frame(rtype: int, op_seq: int, payload: dict) -> bytes:
    body = pickle.dumps(payload, protocol=4)
    crc = zlib.crc32(struct.pack("<BQI", rtype, op_seq, len(body)) + body)
    return _HDR.pack(MAGIC, rtype, op_seq, len(body), crc) + body


def read_records(path: str):
    """Parse a log segment. Returns ``(records, valid_len)``: records
    ``[(rtype, op_seq, payload), ...]`` and the byte offset of the first
    frame that fails the magic, length or CRC check (a torn tail)."""
    with open(path, "rb") as f:
        data = f.read()
    records, off = [], 0
    while off + _HDR.size <= len(data):
        magic, rtype, seq, plen, crc = _HDR.unpack_from(data, off)
        if magic != MAGIC or off + _HDR.size + plen > len(data):
            break
        body = data[off + _HDR.size: off + _HDR.size + plen]
        if zlib.crc32(struct.pack("<BQI", rtype, seq, plen) + body) != crc:
            break
        records.append((rtype, seq, pickle.loads(body)))
        off += _HDR.size + plen
    return records, off


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class WriteAheadLog:
    """Append-only CRC-framed log with group commit.

    ``append`` assigns a monotone ``op_seq`` (continued across segments
    through ``start_seq``), writes the frame at once and fsyncs when
    ``group_commit`` records are pending. A failed write or sync poisons
    the log (``failed``); the store was not touched for that op."""

    def __init__(self, path: str, *, group_commit: int = 8,
                 start_seq: int = 1):
        self.path = path
        self.group_commit = max(1, int(group_commit))
        self.appended = 0
        self.synced = 0
        self.fsyncs = 0           # fsync calls on the segment (stats)
        self.bytes = 0            # frame bytes appended (stats)
        self.failed: Optional[str] = None
        self._next_seq = int(start_seq)
        self._pending = 0
        self._lock = threading.Lock()
        # unbuffered: a process kill cannot lose an appended record to a
        # userspace buffer
        self._f = open(path, "ab", buffering=0)
        # the segment must exist durably before a manifest names it
        os.fsync(self._f.fileno())
        _fsync_dir(os.path.dirname(os.path.abspath(path)))

    @property
    def last_seq(self) -> int:
        return self._next_seq - 1

    @property
    def closed(self) -> bool:
        return self._f.closed

    def _fsync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self.fsyncs += 1
        self.synced += self._pending
        self._pending = 0

    def append(self, rtype: int, payload: dict) -> int:
        with self._lock:
            if self.failed:
                raise WALWriteError(self.failed)
            seq = self._next_seq
            try:
                frame = _frame(rtype, seq, payload)
                self._f.write(frame)
                self._pending += 1
                if self._pending >= self.group_commit:
                    self._fsync()
            except (OSError, ValueError) as e:
                self.failed = f"wal append failed: {e}"
                raise WALWriteError(self.failed) from e
            self._next_seq = seq + 1
            self.appended += 1
            self.bytes += len(frame)
        crash_point("post_wal_append")
        return seq

    def sync(self) -> None:
        with self._lock:
            if self.failed:
                raise WALWriteError(self.failed)
            try:
                self._fsync()
            except (OSError, ValueError) as e:
                self.failed = f"wal sync failed: {e}"
                raise WALWriteError(self.failed) from e

    def close(self) -> None:
        if not self._f.closed:
            if not self.failed:
                try:
                    self.sync()
                except WALWriteError:
                    pass
            self._f.close()


# ---------------------------------------------------------------------------
# Manifest + snapshot publication
# ---------------------------------------------------------------------------

def _segment_name(epoch: int) -> str:
    return f"wal-{epoch:08d}.log"


def _snapshot_name(epoch: int) -> str:
    return f"snapshot-{epoch:08d}.npz"


def load_manifest(dirpath: Optional[str]) -> Optional[dict]:
    """The last published durable epoch, or None when the directory holds
    no recoverable index."""
    if not dirpath:
        return None
    path = os.path.join(dirpath, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path, "r") as f:
        man = json.load(f)
    if man.get("format") != MANIFEST_FORMAT:
        raise WALCorruptionError(
            f"manifest format {man.get('format')!r} unsupported "
            f"(expected {MANIFEST_FORMAT})")
    return man


def publish_snapshot(dirpath: str, backend, prev_wal: Optional[WriteAheadLog],
                     *, group_commit: int = 8, chunk: int = 8192):
    """Publish the backend's current state as the next durable epoch.
    Returns ``(manifest, new_wal)``; the previous segment is closed and
    deleted once the manifest rename lands. The caller holds the update
    stream (the snapshot is a consistent cut of it)."""
    os.makedirs(dirpath, exist_ok=True)
    prev = load_manifest(dirpath)
    epoch = (int(prev["epoch"]) + 1) if prev else 0
    if prev_wal is not None:
        prev_wal.sync()
    store = backend.store
    store.disk.flush()

    n = int(backend.n)
    rows = np.empty((n, backend.degree), np.int32)
    for s in range(0, n, chunk):
        ids = np.arange(s, min(s + chunk, n))
        rows[ids] = store.peek_rows(ids)
    op_seq = prev_wal.last_seq if prev_wal is not None else 0
    arrays = dict(nbrs=rows, alive=backend.alive[:n].copy(),
                  version=backend.version[:n].copy(),
                  e_in=backend.e_in[:n].copy(),
                  n=np.asarray(n, np.int64),
                  op_seq=np.asarray(op_seq, np.int64))
    pq_meta = None
    if backend.pq is not None:
        from repro_torch.core import quant
        arrays["pq_centroids"] = quant.codebook_to_array(backend.pq.codebook)
        arrays["pq_codes"] = backend.pq.snapshot(n)
        pq_meta = {"m": backend.pq.m, "bits": backend.pq.bits}
    attrs_meta = None
    if backend.attrs is not None:
        tags, nums = backend.attrs.snapshot(n)
        arrays["attr_tags"], arrays["attr_nums"] = tags, nums
        attrs_meta = backend.attrs.schema.to_meta()

    snap_name = _snapshot_name(epoch)
    snap_tmp = os.path.join(dirpath, snap_name + ".tmp")
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    raw = buf.getvalue()
    with open(snap_tmp, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(snap_tmp, os.path.join(dirpath, snap_name))
    _fsync_dir(dirpath)

    wal_name = _segment_name(epoch)
    new_wal = WriteAheadLog(os.path.join(dirpath, wal_name),
                            group_commit=group_commit, start_seq=op_seq + 1)
    manifest = {
        "format": MANIFEST_FORMAT, "epoch": epoch, "op_seq": op_seq,
        "n": n, "capacity": int(backend.capacity), "dim": int(backend.dim),
        "degree": int(backend.degree), "snapshot": snap_name,
        "snapshot_crc": zlib.crc32(raw), "wal": wal_name, "pq": pq_meta,
        "attrs": attrs_meta,
    }
    crash_point("pre_manifest_rename")
    man_tmp = os.path.join(dirpath, MANIFEST + ".tmp")
    with open(man_tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(man_tmp, os.path.join(dirpath, MANIFEST))
    _fsync_dir(dirpath)

    if prev_wal is not None:
        prev_wal.close()
    _cleanup_stale(dirpath, manifest)
    return manifest, new_wal


def _cleanup_stale(dirpath: str, manifest: dict) -> None:
    """Drop snapshot and log files the published manifest no longer names
    (earlier epochs, or orphans of a crash mid-publish)."""
    keep = {manifest["snapshot"], manifest["wal"]}
    for name in os.listdir(dirpath):
        if name in keep:
            continue
        if name.startswith("snapshot-") or name.startswith("wal-"):
            try:
                os.remove(os.path.join(dirpath, name))
            except OSError:        # best effort: stale files are inert
                pass


# ---------------------------------------------------------------------------
# Recovery
# ---------------------------------------------------------------------------

def _replay(backend, records) -> None:
    from repro_torch.core import mvcc, update
    for rtype, _seq, p in records:
        if rtype == REC_INSERT:
            rev = update.RevLog(p["rev_v"], p["rev_vn"], p["rev_d"])
            # attribute columns ride newer records only
            update.apply_insert_tiered(backend, p["ids"], p["vecs"],
                                       p["sel"], rev, tags=p.get("tags"),
                                       nums=p.get("nums"))
        elif rtype == REC_DELETE:
            update.apply_delete_tiered(backend, p["ids"])
        elif rtype == REC_CONSOLIDATE:
            mvcc.apply_merge_edits(backend, list(zip(p["ids"], p["rows"])))
        else:
            raise WALCorruptionError(f"unknown WAL record type {rtype}")


def recover(dirpath: str, *, host_window: int, group_commit: int = 8,
            chunk: int = 8192, device="cuda"):
    """Open the last published epoch and roll the log forward. Returns
    ``(backend, wal, report)``: the rebuilt ``TieredBackend`` (with the PQ
    lane and the attribute store when the manifest records them, their
    mirrors on ``device``), the reopened log positioned after the last
    valid record, and a report dict."""
    from repro_torch.core.tiers import DiskTier, TieredBackend, TieredStore
    man = load_manifest(dirpath)
    if man is None:
        raise WALCorruptionError(f"no manifest in {dirpath!r}")
    spath = os.path.join(dirpath, man["snapshot"])
    with open(spath, "rb") as f:
        raw = f.read()
    if zlib.crc32(raw) != man["snapshot_crc"]:
        raise WALCorruptionError(
            f"snapshot {man['snapshot']} failed CRC validation")
    snap = np.load(io.BytesIO(raw))
    cap, dim, R = int(man["capacity"]), int(man["dim"]), int(man["degree"])
    n = int(snap["n"])

    disk = DiskTier(dirpath, cap, dim, R, create=False)
    # adjacency truth comes from the snapshot: rows a killed writer tore,
    # and any past the durable high-water mark, are overwritten or
    # cleared before the replay re-applies the logged ops
    rows = np.asarray(snap["nbrs"], np.int32)
    for s in range(0, n, chunk):
        disk.nbr[s:min(s + chunk, n)] = rows[s:min(s + chunk, n)]
    for s in range(n, cap, chunk):
        disk.nbr[s:min(s + chunk, cap)] = -1

    backend = TieredBackend(TieredStore(disk, host_window), n)
    backend.alive[:n] = snap["alive"]
    backend.version[:n] = snap["version"]
    backend.e_in[:n] = snap["e_in"]
    if man.get("pq"):
        from repro_torch.core import quant
        cb = quant.codebook_from_array(np.asarray(snap["pq_centroids"]),
                                       device=device)
        backend.attach_pq(quant.PQCodes(cb, cap,
                                        codes=np.asarray(snap["pq_codes"])))
    # a manifest without "attrs" recovers without a store; the engine
    # attaches an empty one if its config declares a schema
    if man.get("attrs"):
        from repro_torch.core.filters import AttributeSchema
        from repro_torch.core.tiers import AttributeStore
        schema = AttributeSchema.from_meta(man["attrs"])
        backend.attach_attrs(AttributeStore(
            schema, cap, tags=np.asarray(snap["attr_tags"]),
            nums=np.asarray(snap["attr_nums"]), device=device))

    wpath = os.path.join(dirpath, man["wal"])
    truncated = 0
    if os.path.exists(wpath):
        records, valid = read_records(wpath)
        truncated = os.path.getsize(wpath) - valid
        if truncated:
            os.truncate(wpath, valid)
    else:                           # segment lost entirely: nothing to roll
        records = []
    _replay(backend, records)
    last_seq = records[-1][1] if records else int(man["op_seq"])
    wal = WriteAheadLog(wpath, group_commit=group_commit,
                        start_seq=last_seq + 1)
    backend.wal = wal
    report = {"epoch": int(man["epoch"]), "snapshot_seq": int(man["op_seq"]),
              "replayed": len(records), "last_seq": last_seq,
              "truncated_bytes": int(truncated)}
    return backend, wal, report
