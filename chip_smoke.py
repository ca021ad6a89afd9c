#!/usr/bin/env python3
"""Drive the PyTorch port's device-mode search path once on one NVIDIA GPU.

Usage: python3 chip_smoke.py [--seed S]

Phases, each printing one JSON line (any failure raises and exits
non-zero; there is no CPU branch):

1. device      card name and power limit (nvidia-smi), torch and CUDA.
2. build       nvcc builds every kernel of the path from ``src/``.
3. kernel      each kernel against its plain PyTorch version on the card
               at the main path's shapes, with times and the bound.
4. parity      on an integer-valued index, the executor on the CPU
               (plain versions) and on the card (kernels) agree exactly.
5. main path   a 1M x 96 engine (Deep1B's width, synthetic data from the
               seed) answers eight 1,024-query requests and one of 10,240
               through ``engine.search``; launch counts are read around
               these requests alone. Then a profile of three more
               batches by kernel, and the time and memory of one build
               chunk.

Then the kernels line, the card line, and the final status line.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
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


def cuda_ms(fn, reps):
    """Median milliseconds of ``reps`` launches of ``fn``, CUDA events."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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


def phase_profile(eng, queries, top=15):
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
    emit("profile", batches=len(qs), wall_ms=wall_ms, device_ms=device_ms,
         busy_share=device_ms / wall_ms,
         top=[{"kernel": k[:100], "calls": c, "device_ms": t}
              for k, c, t in rows[:top]])


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


def phase_main(gen, dev, seed, n=1_000_000, d=96, sizes=(1024,) * 8
               + (10_240,), recall_q=1024, min_recall=0.5):
    """The engine at Deep1B's published width (configs/svfusion_deep1b.py:
    D=96, degree 32, pool 64, k=10, 64 hops, 131,072 cache slots), N cut
    to 1M, requests through the coalescer. Returns the l2_gather launches
    made by the requests (not by the profiled batches after them)."""
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
    krows = phase_kernel(gen, dev)
    phase_parity(gen, dev, SearchParams(k=10, pool=64, max_iters=64,
                                        beam=16))
    launches = phase_main(gen, dev, args.seed)

    cap = krows["capacity"]
    print(json.dumps({"kernels": [{
        "name": "l2_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/l2_gather/csrc/l2_gather.cu",
        "replaces": "src/repro/kernels/l2_gather/kernel.py:54",
        "launches": launches, "max_abs_err": cap["max_abs_err"],
        "ms": cap["ms"], "plain_ms": cap["plain_ms"],
        "bound_ms": cap["bound_ms"], "bound_by": cap["bound_by"],
        "library_ms": None, "checked": True}]}), flush=True)
    if launches == 0:
        raise AssertionError("the main path launched no l2_gather")
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
