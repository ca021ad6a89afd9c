#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: the device-mode engine and
the three-tier engine with the PQ lane and the fused topology executor,
their searches and their write paths (streaming inserts and deletes,
MVCC consolidation).

Usage: python3 chip_smoke.py [--seed S] [--only PHASES]

Phases, each printing JSON lines (any failure raises and exits non-zero;
there is no CPU branch). ``--only`` runs a comma-separated subset of
kernels, parity, write_parity, main, tiered, consolidation; the kernels
line is printed only when all run.

1. device        card name and power limit (nvidia-smi), torch and CUDA.
2. build         nvcc builds every kernel (l2_gather, pq_adc, row_gather,
                 topk_merge) from ``src/``, all at once.
3. kernels       each kernel against its plain PyTorch version on the
                 card at the main paths' shapes and at shapes that reach
                 every path of the kernel, with times, the bound, the
                 time of a near-empty launch and (topk_merge) the nearest
                 library call.
4. parity        on an integer-valued index, the device-mode executor and
                 ``search_tiered`` (PQ lane, topology cache, speculation)
                 on the CPU (plain versions) and on the card (kernels)
                 agree exactly.
5. write_parity  both write paths on an integer-valued 20,000 x 96 index,
                 once on the CPU and once on the card: device mode
                 (insert, delete, repair, consolidate on a snapshot, merge
                 with the window's log) and three-tier mode (insert,
                 delete, snapshot, window inserts and delete, streaming
                 consolidation, merge, then a PQ-lane search) end
                 identical.
6. main          device mode: a 262,144 x 96 engine (Deep1B's width,
                 synthetic data from the seed) answers eight 1,024-query
                 requests and one of 10,240 through ``engine.search``;
                 ``l2_gather`` launches are read around these requests
                 alone. Then a profile of three more batches by kernel,
                 the time and memory of one build chunk, and a sliding-
                 window write stream: 4 steps of 10,240 inserts and
                 10,240 deletes of the oldest ids, a search per step
                 (recall, read-after-write, no deleted id returned), then
                 a background consolidation with one more step in its
                 window.
7. tiered        three-tier mode: a 1M x 96 engine on a disk tier in a
                 temporary directory, PQ lane (m=16, 8 bits), topology
                 cache at full residency, speculation and prefetch on,
                 answers the same requests; ``pq_adc`` and ``row_gather``
                 launches are read around them alone. Then its stats, a
                 profile of three batches, a wall-time split by stage, and
                 4 write-stream steps of 2,048 rows.
8. consolidation the three-tier background consolidation, with one more
                 stream step in its window, on a 131,072-row index of the
                 same configuration (the host pass is a Python loop over
                 256-row chunks, ~0.2 s each: about 14 minutes at 1M).

Then the kernels line, the card line, and the final status line.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PHASES = ("kernels", "parity", "write_parity", "main", "tiered",
          "consolidation")


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps, sleep_cycles=5_000_000):
    """Median milliseconds of ``reps`` calls of ``fn`` on the card, CUDA
    events. Each timed call is queued behind a device sleep of
    ``sleep_cycles`` clock cycles (~3 ms), so that the host has enqueued
    it before the card reaches the start event: the events then time the
    card's work, not the Python launch path."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def l2_gather_bound_ms(table, ids):
    """Least time for one call: the unique valid rows it gathers, the ids
    read and the output written, over HBM bandwidth; or its 3·B·K·D fp32
    operations over the fp32 rate, whichever is larger."""
    import torch
    B, K = ids.shape
    D = table.shape[1]
    rows = torch.unique(ids[ids >= 0]).numel()
    nbytes = rows * D * table.element_size() + B * K * 4 * 2 + B * D * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * B * K * D / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_kernel(gen, dev):
    """l2_gather against its plain version at the main paths' shapes: the
    capacity table [2^20, 96], the cache table [131072, 96], ids [1024,
    512] with -1 lanes, duplicates and the boundary ids; bf16 once; and
    the device-mode insert's candidate search, ids [512, 512]."""
    import torch
    from repro_torch.kernels.l2_gather import kernel as K
    from repro_torch.kernels.l2_gather.ref import l2_gather_ref
    C, D = 512, 96
    rows = {}
    for label, n, dtype, B in (("capacity", 1 << 20, torch.float32, 1024),
                               ("cache", 131_072, torch.float32, 1024),
                               ("capacity_bf16", 1 << 20, torch.bfloat16,
                                1024),
                               ("insert", 1 << 20, torch.float32, 512)):
        q = torch.randn(B, D, generator=gen, device=dev)
        table = torch.randn(n, D, generator=gen, device=dev).to(dtype)
        ids = torch.randint(0, n, (B, C), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[torch.rand(B, C, generator=gen, device=dev) < 0.1] = -1
        ids[:, C // 2:C // 2 + 64] = ids[:, :64]          # duplicates
        ids[0, :4] = torch.tensor([0, n - 1, 0, -1], device=dev)
        out = K.l2_gather(table, ids, q)
        ref = l2_gather_ref(table, ids, q)
        torch.cuda.synchronize()
        tol = TOL[str(dtype).split(".")[1]]
        bad = ids < 0
        if not (torch.isinf(out[bad]).all() and (out[bad] > 0).all()):
            raise AssertionError(f"{label}: invalid lanes are not +inf")
        err = (out[~bad] - ref[~bad]).abs()
        max_abs = err.max().item()
        max_rel = (err / ref[~bad].abs().clamp_min(1e-30)).max().item()
        if not bool((err <= tol * ref[~bad].abs() + tol * D).all()):
            raise AssertionError(f"{label}: max abs err {max_abs} above "
                                 f"rtol={tol}, atol={tol * D}")
        ms = cuda_ms(lambda: K.l2_gather(table, ids, q), 30)
        plain_ms = cuda_ms(lambda: l2_gather_ref(table, ids, q), 10)
        bound_ms, bound_by = l2_gather_bound_ms(table, ids)
        rows[label] = dict(shape=[n, D, B, C], dtype=str(dtype),
                           max_abs_err=max_abs, max_rel_err=max_rel, tol=tol,
                           ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        emit("kernel", kernel="l2_gather", table=label, **rows[label])
        del table, ids, out, ref, q
    return rows


def ids_with_holes(gen, dev, B, C, n):
    """[B, C] int32 ids below ``n`` with ~10% -1 lanes, a block of
    repeated ids and the boundary ids 0 and n-1."""
    import torch
    ids = torch.randint(0, n, (B, C), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[torch.rand(B, C, generator=gen, device=dev) < 0.1] = -1
    w = min(64, C // 4)
    ids[:, C // 2:C // 2 + w] = ids[:, :w]              # duplicates
    ids[0, :4] = torch.tensor([0, n - 1, 0, -1], device=dev)
    return ids


def phase_kernel_pq(gen, dev, n=1 << 20, m=16, K=256, B=1024):
    """pq_adc against its plain version at the tiered path's shapes: codes
    [2^20, 16] u8, LUT [1024, 16, 256], ids [1024, 512] (a round) and
    [1024, 64] (the entry pool). Tolerance rtol 1e-5, atol 1e-4."""
    import torch
    from repro_torch.kernels.pq_adc import kernel as K_
    from repro_torch.kernels.pq_adc.ref import pq_adc_ref
    codes = torch.randint(0, K, (n, m), generator=gen, device=dev,
                          dtype=torch.uint8)
    lut = torch.rand(B, m, K, generator=gen, device=dev) * 100
    rows = {}
    for label, C in (("round", 512), ("entry", 64)):
        ids = ids_with_holes(gen, dev, B, C, n)
        out = K_.pq_adc(codes, lut, ids)
        ref = pq_adc_ref(codes, lut, ids)
        torch.cuda.synchronize()
        bad = ids < 0
        if not (torch.isinf(out[bad]).all() and (out[bad] > 0).all()):
            raise AssertionError(f"pq_adc {label}: invalid lanes not +inf")
        err = (out[~bad] - ref[~bad]).abs()
        if not bool((err <= 1e-5 * ref[~bad].abs() + 1e-4).all()):
            raise AssertionError(f"pq_adc {label}: max abs err "
                                 f"{err.max().item()} above rtol 1e-5, "
                                 "atol 1e-4")
        ms = cuda_ms(lambda: K_.pq_adc(codes, lut, ids), 30)
        plain_ms = cuda_ms(lambda: pq_adc_ref(codes, lut, ids), 10)
        uniq = torch.unique(ids[ids >= 0]).numel()
        nbytes = uniq * m + B * C * 4 + B * m * K * 4 + B * C * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = B * C * m / FP32_FLOPS * 1e3
        rows[label] = dict(
            shape=[n, m, K, B, C], max_abs_err=err.max().item(),
            rtol=1e-5, atol=1e-4, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        emit("kernel", kernel="pq_adc", ids=label, **rows[label])
    return rows


def phase_kernel_rows(gen, dev, n=1 << 20, B=1024, W=16):
    """row_gather against its plain version at the fused loop's shapes:
    table [2^20, 32] i32, a directory over 2^20 ids, frontier ids [1024,
    16] with -1 lanes; the directory half resident ("half") and fully
    resident ("resident", the main path's topology cache), a table view
    that is not 16-byte aligned ("misaligned") and R = 30 ("r30"): the
    last two take the kernel's general path. Exact. Returns the
    "resident" row."""
    import torch
    from repro_torch.kernels.row_gather import kernel as K_
    from repro_torch.kernels.row_gather.ref import row_gather_ref
    rows = {}
    for label, R, share, offset in (("half", 32, 0.5, 0),
                                    ("resident", 32, 1.0, 0),
                                    ("misaligned", 32, 0.5, 1),
                                    ("r30", 30, 0.5, 0)):
        flat = torch.randint(-1, n, (n * R + offset,), generator=gen,
                             device=dev, dtype=torch.int32)
        table = flat[offset:].view(n, R)
        h2s = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        h2s[torch.rand(n, generator=gen, device=dev) >= share] = -1
        ids = ids_with_holes(gen, dev, B, W, n)
        out = K_.row_gather(table, h2s, ids)
        ref = row_gather_ref(table, h2s, ids)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"row_gather {label} differs from its "
                                 "plain version")
        live = ids[ids >= 0]
        slots = h2s[live]
        resident = torch.unique(slots[slots >= 0]).numel()
        nbytes = (B * W * 4 + live.numel() * 4 + resident * R * 4
                  + B * W * R * 4)
        geo = K_.launch_geometry(B * W, R, table.data_ptr() % 16 == 0)
        rows[label] = dict(
            shape=[n, R, B, W], max_abs_err=0.0, exact=True,
            path=("lanes", "tiles")[geo.path],
            ms=cuda_ms(lambda: K_.row_gather(table, h2s, ids), 30),
            plain_ms=cuda_ms(lambda: row_gather_ref(table, h2s, ids), 10),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            resident_share=(slots >= 0).float().mean().item())
        emit("kernel", kernel="row_gather", case=label, **rows[label])
        del flat, table, h2s, out, ref
    return rows["resident"]


def phase_kernel_topk_merge(gen, dev, B=1024):
    """topk_merge against its plain version: the executor's merge shapes,
    a [1024, 64] pool merged with one round's 512 candidates (beam 16 x
    degree 32) and with 32, and the ragged edges (L, R) = (10, 7), (100,
    1000) and (300, 200), the last past the warp path's L <= 256 (the
    block path). Distances drawn half from {0, 0.25, 0.5, 1, 2, +inf}
    (full (d, id) ties with different visited bits, +inf lanes with valid
    ids) and half uniform, ids from [-1, 64), 10% (+inf, -1) pads, half
    the pools sorted; then the two divergence inputs. Exact on the bits
    of d, on id and on visited, against the plain version on the card and
    on the CPU. No path of the engine calls it (as in the reference), so
    its launches are this phase's. Returns the (64, 512) row."""
    import torch
    from repro_torch.kernels.topk_merge import kernel as K_
    from repro_torch.kernels.topk_merge.ref import topk_merge_ref
    K_.launches = 0
    vals = torch.tensor([0.0, 0.25, 0.5, 1.0, 2.0, math.inf], device=dev)

    def lanes(rows, width):
        d = torch.where(
            torch.rand(rows, width, generator=gen, device=dev) < 0.5,
            vals[torch.randint(0, 6, (rows, width), generator=gen,
                               device=dev)],
            torch.rand(rows, width, generator=gen, device=dev))
        i = torch.randint(-1, 64, (rows, width), generator=gen, device=dev,
                          dtype=torch.int32)
        pad = torch.rand(rows, width, generator=gen, device=dev) < 0.1
        return d.masked_fill(pad, math.inf), i.masked_fill(pad, -1)

    def check(out, args, what):
        for where, ref in (("card", topk_merge_ref(*args)),
                           ("cpu", topk_merge_ref(*(a.cpu() for a in args)))):
            torch.cuda.synchronize()
            same = (torch.equal(out[0].view(torch.int32).cpu(),
                                ref[0].view(torch.int32).cpu())
                    and torch.equal(out[1].cpu(), ref[1].cpu())
                    and torch.equal(out[2].cpu(), ref[2].cpu()))
            if not same:
                raise AssertionError(f"topk_merge {what} differs from its "
                                     f"plain version on the {where}")

    rows = {}
    for L, R in ((64, 512), (64, 32), (10, 7), (100, 1000), (300, 200)):
        pd, pi = lanes(B, L)
        pd[:B // 2] = pd[:B // 2].sort(1).values          # sorted pools
        pv = torch.rand(B, L, generator=gen, device=dev) < 0.5
        nd, ni = lanes(B, R)
        args = (pd, pi, pv, nd, ni)
        check(K_.topk_merge(*args), args, f"L={L} R={R}")
        ties = int(((nd[:, :, None] == pd[:, None, :])
                    & (ni[:, :, None] == pi[:, None, :])).sum())
        cat = torch.cat([pd, nd], 1)
        P = 1 << (L + R - 1).bit_length()
        lg = P.bit_length() - 1
        nbytes = B * (L * 9 + R * 8) + B * L * 9
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = B * P * lg * (lg + 1) / 4 / FP32_FLOPS * 1e3
        rows[(L, R)] = dict(
            shape=[B, L, R], lanes=P, full_ties_pool_new=ties,
            inf_lanes=int(torch.isinf(cat).sum()), max_abs_err=0.0,
            exact=True,
            path=("warp", "block")[K_.launch_geometry(B, L, R).path],
            ms=cuda_ms(lambda: K_.topk_merge(*args), 30),
            plain_ms=cuda_ms(lambda: topk_merge_ref(*args), 10),
            library_ms=cuda_ms(lambda: torch.sort(cat, dim=1, stable=True),
                               30),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        emit("kernel", kernel="topk_merge", **rows[(L, R)],
             library="torch.sort(d, stable=True) of [B, L+R]: the nearest "
             "single call, not the same function on ties")
    # the two inputs on which the Pallas kernel departs from its oracle
    # (tests/test_torch_topk_merge.py), with the oracle's ids and visited
    # flags: (a) a (+inf, -1) pad outranks a real +inf lane; (b) a full
    # (d, id) tie leaves visited order-dependent
    inf = math.inf
    divergences = (
        (([[0.5, inf, inf, inf]], [[3, 5, 6, 7]], [[True, True, True, False]],
          [[0.7, inf]], [[9, 8]]), [3, 9, 5, 6], [True, False, True, True]),
        (([[.5, .5, .5, .9]], [[3, 3, 4, 7]], [[True, False, True, True]],
          [[.5, .1]], [[3, 8]]), [8, 3, 3, 3], [False, True, False, False]))
    for k, (case, want_ids, want_v) in enumerate(divergences):
        args = tuple(torch.tensor(x, device=dev, dtype=dt) for x, dt in zip(
            case, (torch.float32, torch.int32, torch.bool, torch.float32,
                   torch.int32)))
        out = K_.topk_merge(*args)
        check(out, args, f"divergence input {k}")
        if out[1][0].tolist() != want_ids or out[2][0].tolist() != want_v:
            raise AssertionError(f"topk_merge divergence input {k}: "
                                 f"{out[1][0].tolist()} {out[2][0].tolist()}")
        emit("kernel", kernel="topk_merge", divergence_input=k,
             ids=want_ids, visited=want_v, exact=True)
    return rows[(64, 512)], K_.launches


def int_vectors(gen, n, d, dev):
    import torch
    return torch.randint(-8, 9, (n, d), generator=gen, device=dev).float()


def phase_parity(gen, dev, sp, n=20_000, d=96, b=256):
    """The executor on the CPU (plain l2_gather) and on the card (kernel)
    on one integer-valued index: fp32 distances are exact in both, so
    ids, distances, access logs and round counts must be identical."""
    import torch
    from repro_torch.convert import (index_state_from_arrays,
                                     index_state_to_arrays)
    from repro_torch.core.build import build_index
    from repro_torch.core.search import frontier_search
    from repro_torch.kernels.l2_gather import kernel as K
    t0 = time.perf_counter()
    st = build_index(int_vectors(gen, n, d, dev), degree=32,
                     cache_slots=2048, n_max=n, device=dev)
    build_s = time.perf_counter() - t0
    st_cpu = index_state_from_arrays(*index_state_to_arrays(st),
                                     device="cpu")
    q = int_vectors(gen, b, d, dev)
    entries = torch.randint(0, n, (b, sp.pool), generator=gen, device=dev,
                            dtype=torch.int32)
    l0 = K.launches
    on_card = frontier_search(st, q, entries, sp)
    torch.cuda.synchronize()
    launched = K.launches - l0
    on_cpu = frontier_search(st_cpu, q.cpu(), entries.cpu(), sp)
    for f in ("ids", "dists", "acc_ids", "acc_hit", "iters"):
        if not torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)):
            raise AssertionError(f"card and CPU executors differ in {f}")
    if launched == 0:
        raise AssertionError("the card executor launched no l2_gather")
    emit("parity", n=n, d=d, queries=b, build_s=build_s,
         rounds=int(on_cpu.iters.max()), card_launches=launched,
         identical=["ids", "dists", "acc_ids", "acc_hit", "iters"])


def phase_tiered_parity(gen, dev, sp, n=20_000, d=96, b=256):
    """``search_tiered`` with the PQ lane, a topology cache and
    speculation on, once on the CPU (plain versions) and once on the card
    (kernels), over one integer-valued index and a codebook rounded to
    integers, so that every LUT entry and ADC sum is exact in fp32. Two
    topology caches: full residency (one fused dispatch) and a cold
    8,192-slot cache (installs, stalls, per-round fallback)."""
    import torch
    from repro_torch import convert
    from repro_torch.core import cache as Cache
    from repro_torch.core import quant
    from repro_torch.core.build import build_tiered_backend
    from repro_torch.core.search import search_tiered
    from repro_torch.kernels.pq_adc import kernel as PK
    from repro_torch.kernels.row_gather import kernel as RK
    vecs = int_vectors(gen, n, d, dev).cpu().numpy()
    queries = int_vectors(gen, b, d, dev).cpu().numpy()
    out = {}
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        be = build_tiered_backend(vecs, 32, td, device=dev)
        cb = quant.train_codebook(vecs, 16, 8, iters=10, device=dev)
        cents = quant.codebook_to_array(cb).round()
        codes = quant.encode(quant.codebook_from_array(cents, dev), vecs)
        build_s = time.perf_counter() - t0
        try:
            hp = Cache.HostPlacement(n, 2048, d, dtype=torch.bfloat16)
            hot = np.argsort(-be.e_in[:n], kind="stable")[:2048]
            hp.warm(hot, vecs[hot])
            f_lam = hp.scores(be.e_in)
            for kind in ("warm", "cold"):
                res = {}
                for where in ("cpu", dev):
                    pq = convert.pq_codes_from_arrays(cents, codes, n, where)
                    if kind == "warm":
                        topo = Cache.warm_topo_cache(be, 0, device=where)
                    else:
                        topo = Cache.TopoCache(n, 8192, 32, device=where)
                    l0 = (PK.launches, RK.launches)
                    res[str(where)] = search_tiered(
                        be, hp, queries, 7, sp, f_lam=f_lam, pq=pq,
                        rerank_depth=32, topo=topo, speculate=True,
                        device=where)
                    launched = (PK.launches - l0[0], RK.launches - l0[1])
                cpu_res, card_res = res["cpu"], res[str(dev)]
                for f in cpu_res._fields:
                    if not np.array_equal(getattr(cpu_res, f),
                                          getattr(card_res, f)):
                        raise AssertionError(f"tiered {kind}: card and CPU "
                                             f"differ in {f}")
                if min(launched) == 0:
                    raise AssertionError(f"tiered {kind}: launches "
                                         f"{launched}")
                out[kind] = dict(
                    iters=card_res.iters, dispatches=card_res.dispatches,
                    topo_hits=card_res.topo_hits,
                    topo_misses=card_res.topo_misses,
                    spec_hits=card_res.spec_hits,
                    spec_misses=card_res.spec_misses,
                    pq_adc_launches=launched[0],
                    row_gather_launches=launched[1])
        finally:
            be.close()
    emit("tiered_parity", n=n, d=d, queries=b, build_s=build_s,
         identical=list(cpu_res._fields), **out)


def _same_tensors(a, b, what):
    """Raise unless the NamedTuples of tensors ``a`` and ``b`` (any
    devices) are equal field by field."""
    import torch
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if torch.is_tensor(x):
            x, y = x.cpu(), y.cpu()
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"{what}: card and CPU differ in {f}")


def phase_write_parity_device(gen, dev, sp, n=20_000, d=96, b=512):
    """The device-mode write path once on the CPU (plain versions) and once
    on the card (kernels), on one integer-valued index: ``insert_batch``
    with explicit entries, ``delete_batch`` (repeats, -1, out-of-range
    ids), ``repair_affected``, then ``consolidate`` of that snapshot while
    the active graph takes a window insert and delete, and
    ``merge_consolidated`` with the window's log. The first delete takes
    a cluster (the 1,536 nearest ids to one vector) so that repair has
    vertices to mend. Every GraphState field after every step, the new
    ids and the logs must be identical."""
    import torch
    from repro_torch.convert import (index_state_from_arrays,
                                     index_state_to_arrays)
    from repro_torch.core import mvcc, update
    from repro_torch.core.build import build_index
    from repro_torch.kernels.l2_gather import kernel as K
    cap = n + 4 * b
    vecs = int_vectors(gen, n, d, dev)
    st0 = build_index(vecs, degree=32, cache_slots=2048, n_max=cap,
                      device=dev)
    new1, new2 = int_vectors(gen, b, d, dev), int_vectors(gen, b, d, dev)
    e1 = torch.randint(0, n, (b, sp.pool), generator=gen, device=dev,
                       dtype=torch.int32)
    e2 = torch.randint(0, n + b, (b, sp.pool), generator=gen, device=dev,
                       dtype=torch.int32)
    del1 = torch.randint(-1, cap + 8, (2048,), generator=gen, device=dev,
                         dtype=torch.int32)
    del1[:64] = del1[64:128]                               # repeats
    near = ((vecs - vecs[0]) ** 2).sum(1).argsort()[:1536]
    del1[512:] = near.to(torch.int32)                      # a cluster
    del2 = torch.randint(0, n + 2 * b, (512,), generator=gen, device=dev,
                         dtype=torch.int32)

    def run(where):
        st = st0 if where != "cpu" else index_state_from_arrays(
            *index_state_to_arrays(st0), device="cpu")
        steps = []
        t0 = time.perf_counter()
        st, ids1, rev1 = update.insert_batch(st, new1.to(where),
                                             e1.to(where), sp)
        steps.append(("insert", st.graph))
        st = update.delete_batch(st, del1.to(where))
        steps.append(("delete", st.graph))
        st, nrep = update.repair_affected(st)
        steps.append(("repair", st.graph))
        snap, snap_n = st, int(st.graph.n)
        st, ids2, rev2 = update.insert_batch(st, new2.to(where),
                                             e2.to(where), sp)
        st = update.delete_batch(st, del2.to(where))
        steps.append(("window", st.graph))
        cons = update.consolidate(snap)
        steps.append(("consolidate", cons.graph))
        merged = mvcc.merge_consolidated(cons, st, snap_n, rev2)
        steps.append(("merge", merged.graph))
        if where != "cpu":
            torch.cuda.synchronize()
        return dict(steps=steps, logs=(ids1, rev1, ids2, rev2),
                    repaired=int(nrep), seconds=time.perf_counter() - t0)

    cpu = run("cpu")
    l0 = K.launches
    card = run(dev)
    launched = K.launches - l0
    for (name, g_cpu), (_, g_card) in zip(cpu["steps"], card["steps"]):
        _same_tensors(g_cpu, g_card, f"device write path, {name}")
    for a, b_ in zip(cpu["logs"], card["logs"]):
        if isinstance(a, tuple):
            _same_tensors(a, b_, "device write path, reverse-edge log")
        elif not torch.equal(a, b_.cpu()):
            raise AssertionError("device write path: new ids differ")
    if cpu["repaired"] != card["repaired"] or not card["repaired"] \
            or launched == 0:
        raise AssertionError(f"device write path: repaired "
                             f"{cpu['repaired']} vs {card['repaired']}, "
                             f"l2_gather launches {launched}")
    g = card["steps"][-1][1]
    emit("write_parity", mode="device", n=n, d=d, batch=b,
         repaired=card["repaired"], cpu_s=cpu["seconds"],
         card_s=card["seconds"], l2_gather_launches=launched,
         alive=int(g.alive.sum()),
         identical=["nbrs", "vectors", "alive", "e_in", "version", "n",
                    "ids", "reverse-edge logs"],
         steps=[name for name, _ in card["steps"]])


def phase_write_parity_tiered(gen, dev, sp, n=20_000, d=96, b=512):
    """The three-tier write path once on the CPU and once on the card, on
    two copies of one integer-valued disk tier with an integer-rounded
    PQ codebook: ``insert_tiered``, ``delete_tiered``, ``snapshot_tiered``,
    two window inserts (one of repeated vectors, so reverse edges
    collide) and a window delete, ``consolidate_tiered``,
    ``merge_consolidated_tiered``; then a PQ-lane ``search_tiered`` with a
    warm topology cache. Store rows and vectors, the host window, alive,
    version, e_in, PQ codes, ids, logs and the search result must be
    identical, and the card's search must launch pq_adc and row_gather."""
    import shutil

    import torch
    from repro_torch import convert
    from repro_torch.core import cache as Cache
    from repro_torch.core import mvcc, quant, update
    from repro_torch.core.build import build_tiered_backend
    from repro_torch.core.search import search_tiered
    from repro_torch.kernels.pq_adc import kernel as PK
    from repro_torch.kernels.row_gather import kernel as RK
    cap, window = n + 4 * b, n // 4
    vecs = int_vectors(gen, n, d, dev).cpu().numpy()
    batches = [int_vectors(gen, b, d, dev).cpu().numpy() for _ in range(2)]
    batches.append(np.repeat(batches[1][:1], b, 0))
    queries = int_vectors(gen, 256, d, dev).cpu().numpy()
    rng = np.random.default_rng(1)
    del1 = rng.integers(-1, n + b + 8, 2048)
    del2 = np.concatenate([rng.integers(0, n, 256),
                           n + b + rng.integers(0, 2 * b, 64)])
    with tempfile.TemporaryDirectory() as td:
        a, c = Path(td) / "cpu", Path(td) / "card"
        be_a = build_tiered_backend(vecs, 32, str(a), disk_capacity=cap,
                                    host_window=window, device=dev)
        be_a.store.disk.flush()
        shutil.copytree(a, c)
        be_c = convert.tiered_backend_from_arrays(
            str(c), capacity=cap, dim=d, degree=32, n=n, alive=be_a.alive,
            e_in=be_a.e_in, version=be_a.version, host_window=window)
        cb = quant.train_codebook(vecs, 16, 8, iters=10, device=dev)
        cents = quant.codebook_to_array(cb).round()
        codes = quant.encode(quant.codebook_from_array(cents, dev), vecs)
        hot = np.argsort(-be_a.e_in[:n], kind="stable")[:2048]
        runs = {}
        try:
            for be, where in ((be_a, "cpu"), (be_c, dev)):
                be.attach_pq(convert.pq_codes_from_arrays(cents, codes, cap,
                                                          where))
                hp = Cache.HostPlacement(cap, 2048, d, dtype=torch.bfloat16)
                hp.warm(hot, vecs[hot])
                out = {}
                t0 = time.perf_counter()
                out["ids1"], out["rev1"] = update.insert_tiered(
                    be, hp, batches[0], sp, 3, device=where)
                out["del1"] = update.delete_tiered(be, del1)
                snap = mvcc.snapshot_tiered(be)
                out["ids2"], rev2 = update.insert_tiered(be, hp, batches[1],
                                                         sp, 4, device=where)
                out["ids3"], rev3 = update.insert_tiered(be, hp, batches[2],
                                                         sp, 5, device=where)
                out["del2"] = update.delete_tiered(be, del2)
                out["rows"] = update.consolidate_tiered(be, snapshot=snap)
                mvcc.merge_consolidated_tiered(be, snap, out["rows"],
                                               [rev2, rev3])
                out["logs"] = [convert.rev_log_to_arrays(lg)
                               for lg in (out.pop("rev1"), rev2, rev3)]
                topo = Cache.warm_topo_cache(be, 0, device=where)
                l0 = (PK.launches, RK.launches)
                out["search"] = search_tiered(
                    be, hp, queries, 7, sp, pq=be.pq, rerank_depth=32,
                    topo=topo, speculate=True, device=where)
                out["launches"] = (PK.launches - l0[0], RK.launches - l0[1])
                out["seconds"] = time.perf_counter() - t0
                out["state"] = dict(
                    nbr=np.asarray(be.store.disk.nbr),
                    vec=np.asarray(be.store.disk.vec), alive=be.alive,
                    version=be.version, e_in=be.e_in, n=np.int64(be.n),
                    codes=be.pq.codes, loc=be.store.loc)
                runs[str(where)] = out
            cpu, card = runs["cpu"], runs[str(dev)]
            for k in ("ids1", "del1", "ids2", "ids3", "del2", "rows"):
                if not np.array_equal(cpu[k], card[k]):
                    raise AssertionError(f"tiered write path: {k} differs")
            for lc, lk in zip(cpu["logs"], card["logs"]):
                if not all(np.array_equal(x, y) for x, y in zip(lc, lk)):
                    raise AssertionError("tiered write path: logs differ")
            for k, v in cpu["state"].items():
                if not np.array_equal(v, card["state"][k]):
                    raise AssertionError(f"tiered write path: {k} differs")
            _same_tensors(cpu["search"], card["search"],
                          "tiered write path, closing search")
            if min(card["launches"]) == 0:
                raise AssertionError(f"tiered write path: closing search "
                                     f"launched {card['launches']}")
            st = card["state"]
            dead = (st["nbr"] >= 0) & ~st["alive"][np.clip(st["nbr"], 0,
                                                           None)]
            if dead.any():
                raise AssertionError("tiered write path: edges to dead "
                                     "vertices after the merge")
        finally:
            be_a.close()
            be_c.close()
    emit("write_parity", mode="three-tier", n=n, d=d, batch=b,
         cpu_s=cpu["seconds"], card_s=card["seconds"],
         pq_adc_launches=card["launches"][0],
         row_gather_launches=card["launches"][1],
         identical=["store rows", "store vectors", "host window", "alive",
                    "version", "e_in", "pq codes", "ids", "logs",
                    "consolidated rows",
                    *(f"search.{f}" for f in card["search"]._fields)])


def synthetic_descriptors(gen, n, d, dev, clusters=1024, intrinsic=16,
                          chunk=1 << 18):
    """Vectors with the low intrinsic dimension of image descriptors: a
    ``intrinsic``-dimensional mixture of ``clusters`` unit Gaussians mapped
    to ``d`` dimensions by a fixed random matrix, plus small noise. Returns
    a function drawing ``m`` rows from the same distribution. The centers
    spread as far as the components do, so the components overlap and the
    KNN graph is one connected piece, as on real descriptors; with centers
    3x further apart the graph falls into islands that 64 random entry
    points rarely reach (recall@10 0.07 at 1M)."""
    import torch
    centers = torch.randn(clusters, intrinsic, generator=gen, device=dev)
    proj = torch.randn(d, intrinsic, generator=gen,
                       device=dev) / math.sqrt(intrinsic)

    def draw(m):
        out = torch.empty(m, d, device=dev)
        for s in range(0, m, chunk):
            e = min(s + chunk, m)
            c = torch.randint(0, clusters, (e - s,), generator=gen,
                              device=dev)
            z = centers[c] + torch.randn(e - s, intrinsic, generator=gen,
                                         device=dev)
            out[s:e] = z @ proj.T + 0.05 * torch.randn(
                e - s, d, generator=gen, device=dev)
        return out
    return draw


def index_bytes(state):
    return sum(t.numel() * t.element_size()
               for part in (state.graph, state.cache, state.stats)
               for t in part)


def device_profile(fn, phase, top=15, **extra):
    """Run ``fn`` once under ``torch.profiler`` and emit its wall time, its
    device time by kernel and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    emit(phase, **extra, wall_ms=wall_ms, device_ms=device_ms,
         busy_share=device_ms / wall_ms,
         top=[{"kernel": k[:100], "calls": c, "device_ms": t}
              for k, c, t in rows[:top]],
         ported=[{"kernel": name, "calls": c, "device_ms": t,
                  "us_per_call": t / c * 1e3}
                 for name in ("l2_gather", "pq_adc", "row_gather")
                 for k, c, t in rows if f"::{name}_" in k])


def phase_profile(eng, queries, phase="profile"):
    """Device time of a few 1,024-query batches (executor and placement,
    through the coalescer's dispatch target on this thread) by kernel,
    and the device's busy share of their wall time."""
    qs = [q.cpu().numpy() for q in queries]
    eng._search_exec(qs[0])

    def run():
        for q in qs:
            eng._search_exec(q)
    device_profile(run, phase, batches=len(qs))


def phase_knn_chunk(vecs, k=32, chunk=2048):
    """Time and device memory of one build chunk: the [chunk, N] distance
    GEMM block, then its top-k."""
    import torch
    from repro_torch.core.build import pairwise_l2
    from repro_torch.core.topk import smallest_k
    out = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for name, fn in (("gemm", lambda: pairwise_l2(vecs[:chunk], vecs)),
                     ("topk", lambda: smallest_k(d, k))):
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        b.record()
        b.synchronize()
        out[f"{name}_ms"] = a.elapsed_time(b)
        out[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        if name == "gemm":
            d = res
    emit("knn_chunk", rows=chunk, cols=vecs.shape[0], k=k, **out)


def _dead_edges(nbrs, alive):
    """Count of edges (row entries >= 0) to vertices not alive."""
    return int(((nbrs >= 0) & ~alive[nbrs.clamp(min=0)]).sum())


def phase_write_stream(eng, draw, dev, steps=4, rows=10_240, q_rows=1024,
                       min_raw=0.9):
    """A sliding window over the device-mode engine (the shape of the
    paper's SlidingWindow stream, ``repro/train/data.py:91``): per step,
    insert ``rows`` fresh vectors from the index's own distribution,
    delete the ``rows`` oldest live ids, search 1,024 new queries (recall
    against brute force over the alive set) and the step's first 1,024
    inserted vectors (read-after-write: the share that find their own id
    at rank 0), and check that no deleted id is returned. Then a
    consolidation on an MVCC snapshot in the background while one more
    step runs, and the checks after its merge: no edge to a vertex that
    was dead at the snapshot (the merge keeps edges to vertices deleted in
    its window, as the reference's does; searches skip them), e_in equal
    to its recomputation; then a second consolidation with no window,
    after which no edge reaches any dead vertex."""
    import torch
    from repro_torch.core import mvcc, update
    from repro_torch.core.build import compute_e_in
    from repro_torch.core.search import brute_force_topk, recall_at_k
    from repro_torch.kernels.l2_gather import kernel as K
    deleted, oldest = [], 0

    def step(i, phase="write_step"):
        nonlocal oldest
        new = draw(rows).cpu().numpy()
        l0 = K.launches
        t = time.perf_counter()
        ids = eng.insert(new)
        torch.cuda.synchronize()
        ins_s = time.perf_counter() - t
        launched = K.launches - l0
        old = np.arange(oldest, oldest + rows)
        oldest += rows
        t = time.perf_counter()
        eng.delete(old)
        torch.cuda.synchronize()
        del_s = time.perf_counter() - t
        deleted.append(old)
        q = draw(q_rows)
        found, dists = eng.search(q.cpu().numpy())
        truth = brute_force_topk(eng.state.graph, q, 10)[0]
        rec = float(recall_at_k(torch.as_tensor(found, device=dev), truth))
        own, _ = eng.search(new[:q_rows])
        raw = float((own[:, 0] == ids[:q_rows]).mean())
        dead = np.concatenate(deleted)
        leaked = int(np.isin(found, dead).sum() + np.isin(own, dead).sum())
        emit(phase, mode="device", step=i, inserted=rows, deleted=rows,
             insert_s=ins_s, inserts_per_s=rows / ins_s, delete_s=del_s,
             l2_gather_launches_by_inserts=launched, recall_at_10=rec,
             read_after_write=raw, deleted_ids_returned=leaked,
             n=int(eng.state.graph.n), alive=int(eng.state.graph.alive.sum()))
        if launched == 0 or raw < min_raw or leaked or \
                not np.isfinite(dists).all():
            raise AssertionError(f"write step {i}: l2_gather launches "
                                 f"{launched}, read-after-write {raw}, "
                                 f"deleted ids returned {leaked}")

    for i in range(steps):
        step(i)
    prof_rows = draw(2048).cpu().numpy()
    device_profile(lambda: eng.insert(prof_rows), "write_profile",
                   mode="device", inserted=len(prof_rows))
    snap_dead = np.concatenate(deleted)
    acc = {}
    undo = [_timed(update, "consolidate", acc),
            _timed(mvcc, "merge_consolidated", acc)]
    try:
        eng.wait_background()      # one the deleted fraction started
        t0 = time.perf_counter()
        th = eng.consolidate_async(wait=False)
        if th is None:
            raise AssertionError("the consolidation was deferred")
        step(steps, phase="write_window_step")
        eng.wait_background()
        window_s = time.perf_counter() - t0
        first = dict(acc)
        g = eng.state.graph
        snap_dead_t = torch.zeros_like(g.alive)
        snap_dead_t[torch.as_tensor(snap_dead, device=dev)] = True
        nb = g.nbrs
        to_snap_dead = int(((nb >= 0) & snap_dead_t[nb.clamp(min=0)]).sum())
        to_dead = _dead_edges(nb, g.alive)
        e_in_ok = bool(torch.equal(compute_e_in(nb, g.capacity), g.e_in))
        t = time.perf_counter()
        eng.consolidate_async(wait=True)
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t
    finally:
        for u in undo:
            u()
    g = eng.state.graph
    after = _dead_edges(g.nbrs, g.alive)
    e_in_ok2 = bool(torch.equal(compute_e_in(g.nbrs, g.capacity), g.e_in))
    emit("write_consolidation", mode="device",
         consolidate_s=first.get("consolidate"),
         merge_s=first.get("merge_consolidated"), window_wall_s=window_s,
         edges_to_snapshot_dead=to_snap_dead,
         edges_to_window_deleted=to_dead, e_in_matches=e_in_ok,
         serial_consolidation_s=serial_s, edges_to_dead_after_serial=after,
         e_in_matches_after_serial=e_in_ok2,
         consolidations=eng.stats()["consolidations"],
         n=int(g.n), alive=int(g.alive.sum()))
    if to_snap_dead or after or not (e_in_ok and e_in_ok2):
        raise AssertionError("device consolidation left edges to dead "
                             "vertices or a stale e_in")


def _tiered_truth(vecs, alive, queries, dev, k=10):
    """Brute-force top-k over the alive rows of ``vecs`` (on the card)."""
    import torch
    from repro_torch.core.search import brute_force_topk
    from repro_torch.core.types import GraphState
    n = len(alive)
    g = GraphState(vecs[:n], None, torch.as_tensor(alive, device=dev), None,
                   None, None)
    return brute_force_topk(g, queries, k)[0]


def tiered_stream_step(eng, state, draw, dev, i, rows, q_rows=1024,
                       min_raw=0.9, phase="write_step"):
    """One sliding-window step over a three-tier engine: insert ``rows``
    fresh vectors, delete the ``rows`` oldest live ids, search 1,024 new
    queries (recall against brute force over the alive set; pq_adc and
    row_gather launches counted) and the step's first 1,024 inserted
    vectors (read-after-write), and check no deleted id comes back.
    ``state`` holds the vectors on the card, the deleted ids and the
    oldest live id."""
    import torch
    from repro_torch.core.search import recall_at_k
    from repro_torch.kernels.pq_adc import kernel as PK
    from repro_torch.kernels.row_gather import kernel as RK
    be = eng._backend
    new_t = draw(rows)
    new = new_t.cpu().numpy()
    t = time.perf_counter()
    ids = eng.insert(new)
    ins_s = time.perf_counter() - t
    state["vecs"] = torch.cat([state["vecs"], new_t])
    old = np.arange(state["oldest"], state["oldest"] + rows)
    state["oldest"] += rows
    t = time.perf_counter()
    eng.delete(old)
    del_s = time.perf_counter() - t
    state["deleted"].append(old)
    q = draw(q_rows)
    l0 = (PK.launches, RK.launches)
    t = time.perf_counter()
    found, dists = eng.search(q.cpu().numpy())
    search_s = time.perf_counter() - t
    launched = (PK.launches - l0[0], RK.launches - l0[1])
    truth = _tiered_truth(state["vecs"], be.alive[:be.n], q, dev)
    rec = float(recall_at_k(torch.as_tensor(found, device=dev), truth))
    own, _ = eng.search(new[:q_rows])
    raw = float((own[:, 0] == ids[:q_rows]).mean())
    dead = np.concatenate(state["deleted"])
    leaked = int(np.isin(found, dead).sum() + np.isin(own, dead).sum())
    emit(phase, mode="three-tier", step=i, inserted=rows, deleted=rows,
         insert_s=ins_s, inserts_per_s=rows / ins_s, delete_s=del_s,
         search_s=search_s, pq_adc_launches=launched[0],
         row_gather_launches=launched[1], recall_at_10=rec,
         read_after_write=raw, deleted_ids_returned=leaked, n=int(be.n),
         alive=int(be.alive[:be.n].sum()))
    if min(launched) == 0 or raw < min_raw or leaked or \
            not np.isfinite(dists).all():
        raise AssertionError(f"tiered write step {i}: launches {launched}, "
                             f"read-after-write {raw}, deleted ids "
                             f"returned {leaked}")


def tiered_consolidation_window(eng, state, draw, dev, rows):
    """A consolidation of the three-tier engine on an MVCC snapshot in the
    background while one more stream step runs, then the checks after its
    merge: no edge to a dead vertex (the disk-tier merge scrubs window
    deletions) and e_in equal to its recomputation from the rows."""
    from repro_torch.core import mvcc, update
    acc = {}
    undo = [_timed(mvcc, "snapshot_tiered", acc),
            _timed(update, "consolidate_tiered", acc),
            _timed(mvcc, "merge_consolidated_tiered", acc)]
    try:
        eng.wait_background()      # one the deleted fraction started
        t0 = time.perf_counter()
        if eng.consolidate_async(wait=False) is None:
            raise AssertionError("the consolidation was deferred")
        tiered_stream_step(eng, state, draw, dev, "window", rows,
                           phase="write_window_step")
        eng.wait_background()
        wall = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    be = eng._backend
    rows_all = np.concatenate([be.store.peek_rows(np.arange(s, min(
        s + 65536, be.n))) for s in range(0, be.n, 65536)])
    dead = int(((rows_all >= 0)
                & ~be.alive[np.clip(rows_all, 0, None)]).sum())
    e_in = np.zeros((be.capacity,), np.int32)
    np.add.at(e_in, rows_all[rows_all >= 0], 1)
    e_in_ok = bool(np.array_equal(e_in, be.e_in))
    emit("write_consolidation", mode="three-tier", n=int(be.n),
         alive=int(be.alive[:be.n].sum()),
         snapshot_s=acc.get("snapshot_tiered"),
         consolidate_s=acc.get("consolidate_tiered"),
         merge_s=acc.get("merge_consolidated_tiered"), window_wall_s=wall,
         edges_to_dead=dead, e_in_matches=e_in_ok,
         consolidations=eng.stats()["consolidations"])
    if dead or not e_in_ok:
        raise AssertionError("tiered consolidation left edges to dead "
                             "vertices or a stale e_in")


def phase_main(gen, dev, seed, n=262_144, d=96, sizes=(1024,) * 8
               + (10_240,), recall_q=1024, min_recall=0.5, write=True):
    """The device-mode engine at Deep1B's published width
    (configs/svfusion_deep1b.py: D=96, degree 32, pool 64, k=10, 64 hops,
    131,072 cache slots), N cut to 262,144 so that this build and the
    tiered path's 1M build fit the run's time, requests through the
    coalescer. Returns the l2_gather launches made by the requests (not
    by the profiled batches after them). Then, with ``write``, the
    sliding-window write stream (``phase_write_stream``)."""
    import torch
    from repro_torch.core.engine import EngineConfig, SVFusionEngine
    from repro_torch.core.search import brute_force_topk, recall_at_k
    from repro_torch.core.types import SearchParams
    from repro_torch.kernels.l2_gather import kernel as K
    draw = synthetic_descriptors(gen, n, d, dev)
    vecs = draw(n)
    queries = [draw(b) for b in sizes]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = EngineConfig(degree=32, cache_slots=131_072, capacity=1 << 20,
                       search=SearchParams(k=10, pool=64, max_iters=64,
                                           beam=16), seed=seed)
    t0 = time.perf_counter()
    eng = SVFusionEngine(vecs, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emit("build_index", n=n, d=d, build_s=build_s, **eng.build_timings,
         peak_device_bytes=torch.cuda.max_memory_allocated(),
         index_bytes=index_bytes(eng.state))
    try:
        truth = [brute_force_topk(eng.state.graph, q[:recall_q], 10)[0]
                 for q in queries]
        torch.cuda.synchronize()
        K.launches = 0                     # count the main path alone
        launched = 0
        for i, q in enumerate(queries):
            s0, l0 = eng.host_syncs, K.launches
            q_host = q.cpu().numpy()
            t = time.perf_counter()
            ids, dists = eng.search(q_host)
            dt = time.perf_counter() - t
            lq = K.launches - l0
            launched += lq
            if ids.shape != (len(q_host), 10) or dists.shape != ids.shape:
                raise AssertionError(f"request {i}: result shape "
                                     f"{ids.shape}")
            if not (np.isfinite(dists).all() and (ids >= 0).all()
                    and (ids < n).all()):
                raise AssertionError(f"request {i}: non-finite distances "
                                     "or ids outside the index")
            rec = float(recall_at_k(torch.as_tensor(ids[:recall_q],
                                                    device=dev), truth[i]))
            emit("request", i=i, queries=len(q_host), latency_s=dt,
                 qps=len(q_host) / dt, host_syncs=eng.host_syncs - s0,
                 l2_gather_launches=lq, recall_at_10=rec)
            if lq == 0:
                raise AssertionError(f"request {i} launched no l2_gather")
            if rec < min_recall:
                raise AssertionError(f"request {i}: recall@10 {rec} < "
                                     f"{min_recall}")
        st = eng.stats()
        emit("engine_stats", **{k: v for k, v in st.items() if k != "slo"})
        phase_profile(eng, queries[:3])
        phase_knn_chunk(vecs)
        if write:
            phase_write_stream(eng, draw, dev)
    finally:
        eng.close()
    return launched


def _timed(mod, name, acc):
    """Wrap ``mod.name`` so that its wall seconds add up in acc[name];
    returns a function that restores it."""
    fn = getattr(mod, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
    setattr(mod, name, wrapper)
    return lambda: setattr(mod, name, fn)


def phase_tiered_stages(eng, queries, top=20):
    """Wall time of a few 1,024-query batches by stage of the tiered
    search (host clock; the device's part is inside the stage that waits
    for it), with no profiler attached; then the same batches under
    cProfile, host functions by their own time."""
    import torch
    from repro_torch.core import cache as Cache
    from repro_torch.core import search as S
    acc = {}
    undo = [_timed(S, name, acc) for name in (
        "_pq_entry_dispatch", "_fused_topo_shell", "_pq_fused_dispatch",
        "_resolve_unique_vectors", "_pq_rerank_dispatch")]
    undo += [_timed(S._SpecPipeline, "stage", acc),
             _timed(Cache, "apply_wavp_host", acc)]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q in queries:
            eng._search_exec(q.cpu().numpy())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    emit("tiered_stages", batches=len(queries), wall_ms=wall * 1e3,
         stage_ms={k: v * 1e3 for k, v in acc.items()},
         stage_share={k: v / wall for k, v in acc.items()})
    # the same batches under cProfile: host functions by own time
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for q in queries:
        eng._search_exec(q.cpu().numpy())
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    emit("tiered_host_profile", batches=len(queries),
         total_s=st.total_tt,
         top=[{"fn": f"{Path(f).name}:{line}:{name}", "calls": nc,
               "own_s": tt, "cum_s": ct}
              for (f, line, name), (_, nc, tt, ct, _) in rows])


def tiered_config(td, seed, cap=1 << 20):
    """The three-tier configuration of the tiered phases, on a disk tier
    of ``cap`` rows in the directory ``td``."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.types import SearchParams
    return EngineConfig(
        degree=32, cache_slots=131_072, capacity=cap,
        search=SearchParams(k=10, pool=64, max_iters=64, beam=16),
        seed=seed, disk_path=td, disk_capacity=cap, wal_enabled=False,
        pq_enabled=True, pq_m=16, pq_bits=8, rerank_depth=32,
        topo_cache_slots=0, fused_rounds=0, speculate=True, prefetch=True,
        spec_rank="auto", cache_dtype="bf16")


def phase_tiered_main(gen, dev, seed, n=1_000_000, d=96, sizes=(1024,) * 8
                      + (10_240,), recall_q=1024, min_recall=0.5,
                      write_steps=4, write_rows=2048):
    """The three-tier engine at Deep1B's published width
    (configs/svfusion_deep1b.py: D=96, degree 32, pool 64, k=10, 64 hops
    at beam 16, 131,072 exact-cache slots in bf16) with the PQ lane (m=16,
    8 bits, re-rank depth 32), the topology cache at full residency, no
    K-round cap, speculation and prefetch on; N cut to 1M synthetic rows
    on a 2^20-row disk tier in a temporary directory. Returns the
    (pq_adc, row_gather) launches made by the requests. Then the
    sliding-window write stream, ``write_steps`` steps of ``write_rows``
    (the disk tier holds 48,576 more rows) and the profile of one
    512-row insert. Its consolidation runs on a smaller index
    (``phase_tiered_consolidation``): the host pass over 1M rows takes
    about 14 minutes."""
    import torch
    from repro_torch.core.engine import SVFusionEngine
    from repro_torch.core.search import brute_force_topk, recall_at_k
    from repro_torch.core.types import GraphState
    from repro_torch.kernels.pq_adc import kernel as PK
    from repro_torch.kernels.row_gather import kernel as RK
    draw = synthetic_descriptors(gen, n, d, dev)
    vecs = draw(n)
    queries = [draw(b) for b in sizes]
    with tempfile.TemporaryDirectory() as td:
        cfg = tiered_config(td, seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = SVFusionEngine(vecs.cpu().numpy(), cfg)
        torch.cuda.synchronize()
        emit("build_tiered", n=n, d=d, build_s=time.perf_counter() - t0,
             **eng.build_timings,
             peak_device_bytes=torch.cuda.max_memory_allocated())
        try:
            everything = GraphState(vecs, None, torch.ones(
                n, dtype=torch.bool, device=dev), None, None, None)
            truth = [brute_force_topk(everything, q[:recall_q], 10)[0]
                     for q in queries]
            torch.cuda.synchronize()
            PK.launches = RK.launches = 0     # count the main path alone
            for i, q in enumerate(queries):
                l0 = (PK.launches, RK.launches)
                b0 = (eng._search_dispatches, eng._search_batches)
                q_host = q.cpu().numpy()
                t = time.perf_counter()
                ids, dists = eng.search(q_host)
                dt = time.perf_counter() - t
                lq = (PK.launches - l0[0], RK.launches - l0[1])
                batches = eng._search_batches - b0[1]
                if ids.shape != (len(q_host), 10) or dists.shape != ids.shape:
                    raise AssertionError(f"tiered request {i}: result shape "
                                         f"{ids.shape}")
                if not (np.isfinite(dists).all() and (ids >= 0).all()
                        and (ids < n).all()):
                    raise AssertionError(f"tiered request {i}: non-finite "
                                         "distances or ids outside the index")
                rec = float(recall_at_k(torch.as_tensor(ids[:recall_q],
                                                        device=dev), truth[i]))
                emit("tiered_request", i=i, queries=len(q_host),
                     latency_s=dt, qps=len(q_host) / dt, recall_at_10=rec,
                     pq_adc_launches=lq[0], row_gather_launches=lq[1],
                     batches=batches,
                     dispatches_per_batch=(eng._search_dispatches - b0[0])
                     / max(batches, 1))
                if min(lq) == 0:
                    raise AssertionError(f"tiered request {i} launched "
                                         f"(pq_adc, row_gather) = {lq}")
                if rec < min_recall:
                    raise AssertionError(f"tiered request {i}: recall@10 "
                                         f"{rec} < {min_recall}")
            launched = (PK.launches, RK.launches)
            st = eng.stats()
            emit("tiered_stats", **{k: v for k, v in st.items()
                                    if k != "slo"})
            phase_profile(eng, queries[:3], phase="tiered_profile")
            phase_tiered_stages(eng, queries[:3])
            state = dict(vecs=vecs, deleted=[], oldest=0)
            for i in range(write_steps):
                tiered_stream_step(eng, state, draw, dev, i, write_rows)
            prof_rows = draw(512)
            device_profile(lambda: eng.insert(prof_rows.cpu().numpy()),
                           "write_profile", mode="three-tier",
                           inserted=len(prof_rows))
        finally:
            eng.close()
    return launched


def phase_tiered_consolidation(gen, dev, seed, n=131_072, d=96, steps=2,
                               rows=2048):
    """The three-tier consolidation at a size that fits the run: the
    tiered configuration on ``n`` rows of the same synthetic
    distribution, ``steps`` sliding-window steps of ``rows``, then the
    background consolidation with one more step in its window."""
    from repro_torch.core.engine import SVFusionEngine
    draw = synthetic_descriptors(gen, n, d, dev)
    vecs = draw(n)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        eng = SVFusionEngine(vecs.cpu().numpy(),
                             tiered_config(td, seed, n + (steps + 2) * rows))
        emit("build_tiered", n=n, d=d, build_s=time.perf_counter() - t0,
             **eng.build_timings)
        try:
            state = dict(vecs=vecs, deleted=[], oldest=0)
            for i in range(steps):
                tiered_stream_step(eng, state, draw, dev, i, rows)
            tiered_consolidation_window(eng, state, draw, dev, rows)
        finally:
            eng.close()


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated subset of "
                    f"{','.join(PHASES)} (default: all; the kernels line "
                    "is printed only when all run)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on the "
                 "card")
    only = args.only.split(",")
    if set(only) - set(PHASES):
        sys.exit(f"chip_smoke: unknown phases {set(only) - set(PHASES)}")
    from repro_torch.kernels import _build
    from repro_torch.core.types import SearchParams

    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = _build.build()
    emit("build", seconds=time.perf_counter() - t0, kernels=sorted(logs),
         ptxas=[ln.strip() for log in logs.values()
                for ln in log.splitlines()
                if "registers" in ln or "Compiling entry" in ln])

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    sp = SearchParams(k=10, pool=64, max_iters=64, beam=16)
    t_run = time.perf_counter()
    if "kernels" in only:
        # one near-empty launch (a zero-cycle device sleep) timed as the
        # kernels are: what a kernel with ~1 us of bytes can reach here
        floor_ms = cuda_ms(lambda: torch.cuda._sleep(0), 30)
        emit("launch_floor", ms=floor_ms,
             method="cuda_ms of torch.cuda._sleep(0), 30 calls")
        l2 = phase_kernel(gen, dev)["capacity"]
        pq = phase_kernel_pq(gen, dev)["round"]
        rows = phase_kernel_rows(gen, dev)
        topk, topk_launches = phase_kernel_topk_merge(gen, dev)
    if "parity" in only:
        phase_parity(gen, dev, sp)
        phase_tiered_parity(gen, dev, sp)
    if "write_parity" in only:
        phase_write_parity_device(gen, dev, sp)
        phase_write_parity_tiered(gen, dev, sp)
    if "main" in only:
        l2_launches = phase_main(gen, dev, args.seed)
    if "tiered" in only:
        pq_launches, row_launches = phase_tiered_main(gen, dev, args.seed)
    if "consolidation" in only:
        phase_tiered_consolidation(gen, dev, args.seed)
    emit("phases", ran=only, seconds=time.perf_counter() - t_run)

    if only == list(PHASES):
        src = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
        kernels = [
            dict(name="l2_gather", replaces="src/repro/kernels/l2_gather/"
                 "kernel.py:54", launches=l2_launches, row=l2),
            dict(name="pq_adc", replaces="src/repro/kernels/pq_adc/"
                 "kernel.py:74", launches=pq_launches, row=pq),
            dict(name="row_gather", replaces="src/repro/kernels/row_gather/"
                 "kernel.py:57", launches=row_launches, row=rows),
            dict(name="topk_merge", replaces="src/repro/kernels/topk_merge/"
                 "kernel.py:73", launches=topk_launches, row=topk,
                 path="none: no caller in the engine, as in the reference; "
                 "launches are its kernel phase's")]
        print(json.dumps({"kernels": [{
            "name": k["name"], "route": "cuda",
            "source": src.format(k["name"]), "replaces": k["replaces"],
            "launches": k["launches"],
            "max_abs_err": k["row"]["max_abs_err"], "ms": k["row"]["ms"],
            "plain_ms": k["row"]["plain_ms"],
            "bound_ms": k["row"]["bound_ms"],
            "bound_by": k["row"]["bound_by"], "launch_floor_ms": floor_ms,
            "library_ms": k["row"].get("library_ms"), "checked": True,
            **({"path": k["path"]} if "path" in k else {})}
            for k in kernels]}), flush=True)
        for k in kernels:
            if k["launches"] == 0:
                raise AssertionError(f"{k['name']} was launched no time")
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
