#!/usr/bin/env python3
"""Drive the PyTorch port's search paths once on one NVIDIA GPU: the
device-mode engine and the three-tier engine with the PQ lane and the
fused topology executor.

Usage: python3 chip_smoke.py [--seed S]

Phases, each printing JSON lines (any failure raises and exits non-zero;
there is no CPU branch):

1. device        card name and power limit (nvidia-smi), torch and CUDA.
2. build         nvcc builds every kernel (l2_gather, pq_adc,
                 row_gather) from ``src/``, all at once.
3. kernel        each kernel against its plain PyTorch version on the
                 card at the main paths' shapes, with times and the bound.
4. parity        on an integer-valued index, the device-mode executor on
                 the CPU (plain versions) and on the card (kernels) agree
                 exactly.
5. tiered parity on an integer-valued index with an integer codebook,
                 ``search_tiered`` (PQ lane, topology cache, speculation)
                 on the CPU and on the card agree field by field.
6. main path     device mode: a 262,144 x 96 engine (Deep1B's width,
                 synthetic data from the seed) answers eight 1,024-query
                 requests and one of 10,240 through ``engine.search``;
                 ``l2_gather`` launches are read around these requests
                 alone. Then a profile of three more batches by kernel,
                 and the time and memory of one build chunk.
7. tiered path   three-tier mode: a 1M x 96 engine on a disk tier in a
                 temporary directory, PQ lane (m=16, 8 bits), topology
                 cache at full residency, speculation and prefetch on,
                 answers the same requests; ``pq_adc`` and ``row_gather``
                 launches are read around them alone. Then its stats, a
                 profile of three batches and a wall-time split by stage.

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
    """l2_gather against its plain version at the main path's shapes: the
    capacity table [2^20, 96], the cache table [131072, 96], ids [1024,
    512] with -1 lanes, duplicates and the boundary ids; bf16 once."""
    import torch
    from repro_torch.kernels.l2_gather import kernel as K
    from repro_torch.kernels.l2_gather.ref import l2_gather_ref
    B, C, D = 1024, 512, 96
    q = torch.randn(B, D, generator=gen, device=dev)
    rows = {}
    for label, n, dtype in (("capacity", 1 << 20, torch.float32),
                            ("cache", 131_072, torch.float32),
                            ("capacity_bf16", 1 << 20, torch.bfloat16)):
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
        del table, ids, out, ref
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


def phase_kernel_rows(gen, dev, n=1 << 20, R=32, B=1024, W=16):
    """row_gather against its plain version at the fused loop's shapes:
    table [2^20, 32] i32, a directory over 2^20 ids with half of them
    non-resident, frontier ids [1024, 16] with -1 lanes. Exact."""
    import torch
    from repro_torch.kernels.row_gather import kernel as K_
    from repro_torch.kernels.row_gather.ref import row_gather_ref
    table = torch.randint(-1, n, (n, R), generator=gen, device=dev,
                          dtype=torch.int32)
    h2s = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    h2s[torch.rand(n, generator=gen, device=dev) < 0.5] = -1
    ids = ids_with_holes(gen, dev, B, W, n)
    out = K_.row_gather(table, h2s, ids)
    ref = row_gather_ref(table, h2s, ids)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("row_gather differs from its plain version")
    live = ids[ids >= 0]
    slots = h2s[live]
    resident = torch.unique(slots[slots >= 0]).numel()
    nbytes = B * W * 4 + live.numel() * 4 + resident * R * 4 + B * W * R * 4
    row = dict(shape=[n, R, B, W], max_abs_err=0.0, exact=True,
               ms=cuda_ms(lambda: K_.row_gather(table, h2s, ids), 30),
               plain_ms=cuda_ms(lambda: row_gather_ref(table, h2s, ids), 10),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               resident_share=(slots >= 0).float().mean().item())
    emit("kernel", kernel="row_gather", **row)
    return row


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


def phase_profile(eng, queries, top=15, phase="profile"):
    """Device time of a few 1,024-query batches (executor and placement,
    through the coalescer's dispatch target on this thread) by kernel,
    and the device's busy share of their wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    qs = [q.cpu().numpy() for q in queries]
    eng._search_exec(qs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in qs:
            eng._search_exec(q)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    emit(phase, batches=len(qs), wall_ms=wall_ms, device_ms=device_ms,
         busy_share=device_ms / wall_ms,
         top=[{"kernel": k[:100], "calls": c, "device_ms": t}
              for k, c, t in rows[:top]],
         ported=[{"kernel": name, "calls": c, "device_ms": t,
                  "us_per_call": t / c * 1e3}
                 for name in ("l2_gather", "pq_adc", "row_gather")
                 for k, c, t in rows if f"{name}_kernel" in k])


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


def phase_main(gen, dev, seed, n=262_144, d=96, sizes=(1024,) * 8
               + (10_240,), recall_q=1024, min_recall=0.5):
    """The device-mode engine at Deep1B's published width
    (configs/svfusion_deep1b.py: D=96, degree 32, pool 64, k=10, 64 hops,
    131,072 cache slots), N cut to 262,144 so that this build and the
    tiered path's 1M build fit the run's time, requests through the
    coalescer. Returns the l2_gather launches made by the requests (not
    by the profiled batches after them)."""
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


def phase_tiered_main(gen, dev, seed, n=1_000_000, d=96, sizes=(1024,) * 8
                      + (10_240,), recall_q=1024, min_recall=0.5):
    """The three-tier engine at Deep1B's published width
    (configs/svfusion_deep1b.py: D=96, degree 32, pool 64, k=10, 64 hops
    at beam 16, 131,072 exact-cache slots in bf16) with the PQ lane (m=16,
    8 bits, re-rank depth 32), the topology cache at full residency, no
    K-round cap, speculation and prefetch on; N cut to 1M synthetic rows
    on a 2^20-row disk tier in a temporary directory. Returns the
    (pq_adc, row_gather) launches made by the requests."""
    import torch
    from repro_torch.core.engine import EngineConfig, SVFusionEngine
    from repro_torch.core.search import brute_force_topk, recall_at_k
    from repro_torch.core.types import GraphState, SearchParams
    from repro_torch.kernels.pq_adc import kernel as PK
    from repro_torch.kernels.row_gather import kernel as RK
    draw = synthetic_descriptors(gen, n, d, dev)
    vecs = draw(n)
    queries = [draw(b) for b in sizes]
    with tempfile.TemporaryDirectory() as td:
        cfg = EngineConfig(
            degree=32, cache_slots=131_072, capacity=1 << 20,
            search=SearchParams(k=10, pool=64, max_iters=64, beam=16),
            seed=seed, disk_path=td, disk_capacity=1 << 20,
            wal_enabled=False, pq_enabled=True, pq_m=16, pq_bits=8,
            rerank_depth=32, topo_cache_slots=0, fused_rounds=0,
            speculate=True, prefetch=True, spec_rank="auto",
            cache_dtype="bf16")
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
        finally:
            eng.close()
    return launched


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on the "
                 "card")
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
                for ln in log.splitlines() if "registers" in ln])

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    sp = SearchParams(k=10, pool=64, max_iters=64, beam=16)
    l2 = phase_kernel(gen, dev)["capacity"]
    pq = phase_kernel_pq(gen, dev)["round"]
    rows = phase_kernel_rows(gen, dev)
    phase_parity(gen, dev, sp)
    phase_tiered_parity(gen, dev, sp)
    l2_launches = phase_main(gen, dev, args.seed)
    pq_launches, row_launches = phase_tiered_main(gen, dev, args.seed)

    src = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
    kernels = [
        dict(name="l2_gather", replaces="src/repro/kernels/l2_gather/"
             "kernel.py:54", launches=l2_launches, row=l2),
        dict(name="pq_adc", replaces="src/repro/kernels/pq_adc/"
             "kernel.py:74", launches=pq_launches, row=pq),
        dict(name="row_gather", replaces="src/repro/kernels/row_gather/"
             "kernel.py:57", launches=row_launches, row=rows)]
    print(json.dumps({"kernels": [{
        "name": k["name"], "route": "cuda", "source": src.format(k["name"]),
        "replaces": k["replaces"], "launches": k["launches"],
        "max_abs_err": k["row"]["max_abs_err"], "ms": k["row"]["ms"],
        "plain_ms": k["row"]["plain_ms"], "bound_ms": k["row"]["bound_ms"],
        "bound_by": k["row"]["bound_by"], "library_ms": None,
        "checked": True} for k in kernels]}), flush=True)
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"the main path launched no {k['name']}")
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
