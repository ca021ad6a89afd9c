#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: the device-mode engine and
the three-tier engine with the PQ lane and the fused topology executor,
their searches and their write paths (streaming inserts and deletes,
MVCC consolidation), the partitioned build, the sharded search, the
GPU baseline, the cost model, the LM serving path with retrieval-
augmented serving over a live index, the MoE, SSM, hybrid, VLM and
enc-dec serving paths at their published widths, training, the dry
run's step bundles beside their roofline bounds, and every LM family's
steps run sharded under DTensor; and, named alone, the sharded paths on
four cards over NCCL.

Usage: python3 chip_smoke.py [--seed S] [--only PHASES]

Phases, each printing JSON lines (any failure raises and exits non-zero;
there is no CPU branch). ``--only`` runs a comma-separated subset of
kernels, parity, write_parity, durability, main, tiered, consolidation,
partitioned, distributed, baselines, calibrate, serve, families, train,
launch, sharded; the kernels line is printed only when all run.
four_cards runs only when named (``--only four_cards``), on a machine
with four cards, and exits non-zero on fewer.

1. device        card name and power limit (nvidia-smi), torch and CUDA.
2. build         nvcc builds every kernel (l2_gather, pq_adc, row_gather,
                 topk_merge, e_in_count) from ``src/``, all at once.
3. kernels       each kernel against its plain PyTorch version on the
                 card at the main paths' shapes and at shapes that reach
                 every path of the kernel, with times, the bound, the
                 time of a near-empty launch and (topk_merge) the nearest
                 library call; pq_adc also at the filtered scan's shape
                 ([1,024 x Mp] ids, Mp = 32,768 and 131,072) with the
                 call's peak device memory; l2_gather also at the RAG
                 index's retrieval shape (table [2^18, 576], ids [1,024 x
                 512]), which takes its ROWS_VEC path; e_in_count at the
                 benchmark cells' neighbour table [2^21, 32] with 262,144
                 and 700,000 rows of ids, and at an odd misaligned shape,
                 exact, beside the plain version's hot-bin time.
4. parity        on an integer-valued index, the device-mode executor and
                 ``search_tiered`` (PQ lane, topology cache, speculation)
                 on the CPU (plain versions) and on the card (kernels)
                 agree exactly; so does filtered ``search_tiered`` for
                 the reference filter suite's four specs, on the graph
                 and the brute-force paths, in the exact and PQ lanes.
5. write_parity  both write paths on an integer-valued 20,000 x 96 index,
                 once on the CPU and once on the card: device mode
                 (insert, delete, repair, consolidate on a snapshot, merge
                 with the window's log) and three-tier mode (insert,
                 delete, snapshot, window inserts and delete, streaming
                 consolidation, merge, then a PQ-lane search) end
                 identical.
6. durability    the WAL-on engine (PQ lane, attributes) on a 20,000 x 96
                 integer index: one stream of inserts with attributes,
                 deletes, a checkpoint and a consolidation on the CPU
                 and on the card, each into its own copy of epoch 0;
                 manifests, snapshot arrays and WAL records equal. Then
                 a child process per crash point, killed there, reopened
                 on the card: its state and searches equal the card
                 run's after the same durable records.
7. main          device mode: a 262,144 x 96 engine (Deep1B's width,
                 synthetic data from the seed) answers eight 1,024-query
                 requests and one of 10,240 through ``engine.search``;
                 ``l2_gather`` launches are read around these requests
                 alone. Then a profile of three more batches by kernel,
                 the time and memory of one build chunk, and a sliding-
                 window write stream: 4 steps of 10,240 inserts and
                 10,240 deletes of the oldest ids, a search per step
                 (recall, read-after-write, no deleted id returned; the
                 e_in_count launches of its inserts), then a background
                 consolidation with one more step in its window.
8. tiered        three-tier mode: a 1M x 96 engine on a disk tier in a
                 temporary directory, PQ lane (m=16, 8 bits), topology
                 cache at full residency, speculation and prefetch on,
                 the WAL on and attributes (a 16-value tag, a score),
                 answers the same requests; ``pq_adc`` and ``row_gather``
                 launches are read around them alone. Then its stats, a
                 profile of three batches, a wall-time split by stage,
                 filtered requests at ~50% (graph path) and ~2% (scan)
                 selectivity with their launches read alone, 2 write-
                 stream steps of 2,048 rows (WAL bytes and fsyncs), and
                 a close, a reopen from the disk tier alone and the same
                 searches, identical.
9. consolidation the three-tier background consolidation, with one more
                 stream step in its window, on a 65,536-row index of the
                 same configuration (the host pass is a Python loop over
                 256-row chunks, ~0.2 s each: about 14 minutes at 1M).
10. partitioned the partitioned build (4 partitions, 256 cross samples):
                 on a 20,000 x 96 integer index, CPU (plain l2_gather)
                 and card (kernel) give identical graphs, caches and
                 answers in both engine modes; then a device-mode engine
                 built in 4 partitions on the main phase's vectors answers
                 its requests (recall@10 beside the one-partition
                 engine's), with the build's seconds by pass, peak device
                 memory and l2_gather launches, and l2_gather timed at the
                 merge's shape.
11. distributed  the sharded search: an NCCL group of one rank over the
                 whole 262,144-row index equals ``frontier_search``; a
                 gloo group of two processes on this card (NCCL takes one
                 rank per GPU), each owning half of a 2 x 131,072 index,
                 equals one process's two shard searches merged alike.
12. baselines    ``CagraStatic`` on the card: 65,536 rows, then 2 steps
                 of 2,048 inserts (a full rebuild each) and 2,048
                 deletes, each followed by a 1,024-query search.
13. calibrate    ``calibrate.measure(dim=96)`` on the card, beside the
                 main and tiered engines' ``modeled_us_per_access``.
14. serve        the dense LM serving path. Card against CPU on the smoke
                 configs of smollm_135m and qwen3_0p6b (fp32: logits
                 within 1e-4 and identical ServeEngine token ids; bf16:
                 logits within 2e-2). SmolLM-135M at its published width
                 (params from the seed): prefill of 8 x 128 tokens and
                 one decode step against forward_lm, held in fp32 and
                 reported in bf16. A RAGPipeline over a device-mode
                 index (2^18 capacity, degree 32, pool 64, beam 16,
                 131,072 cache slots) takes 131,072 topic-mixture
                 documents of 64 tokens in 16 ingests; a ServeEngine (8
                 slots, 256 positions) serves 32 prompts augmented by
                 retrieval (k=2, budget 128), 32 new tokens each, then
                 qwen3-0.6B at its width serves 8; eight retrieve_batch
                 requests of 1,024 prompts (l2_gather launches read
                 around them alone) and one retrieve_many of 8 x 128,
                 recall@10 against brute force and self-retrieval
                 (reported: the reference's algorithm misses the floors
                 on this corpus, scripts/reference_cpu_checks.py), a
                 profile of three batches, and the oldest 8,192
                 documents evicted and never returned. Last, the same
                 index configuration on synthetic descriptors at D = 576
                 holds the floors: read-after-write 0.9, recall@10 0.5.
15. families     the other LM families, which launch no ported kernel.
                 Card against CPU on the smoke configs of granite_moe_1b,
                 grok1_314b (MoE), falcon_mamba_7b (SSM), hymba_1p5b
                 (hybrid), internvl2_2b (VLM) and whisper_medium (enc-
                 dec), as in serve. Then each published config but
                 grok-1 (314B params do not fit one card), params from
                 the seed, one at a time: the prefill/decode check held in
                 fp32 and reported in bf16 (granite-moe-1b with the dense
                 oracle, its capacity dispatch reported against it; falcon-
                 mamba-7b 8 x 129 tokens; hymba-1.5b 2 x 1,281 tokens on
                 1,536 positions, past its 1,024-token window;
                 internvl2-2b 256 patches + 8 x 129 tokens; whisper-medium
                 1,500 frames + 8 x 129 tokens); then in bf16 a
                 ServeEngine (8 slots, 256 positions) serves 8 requests of
                 8-24 tokens, 32 new tokens each (granite, falcon-mamba,
                 hymba), or prefill and 32 decode_steps of 8 prompts
                 (internvl2, whisper); params and peak device bytes.
                 falcon-mamba-7b and hymba-1.5b run their bf16 prefill/
                 decode with cuBLAS's reduced-precision bf16 reduction
                 allowed and not, and serve with it on, off, off, on,
                 all on the same inputs (ROADMAP C.1).
16. train        the training path, which launches none of the five
                 kernels (checked). Card against CPU in fp32 on the
                 smoke configs of all ten architectures (granite-moe at
                 both dispatches, hymba past its window): the loss within
                 1e-5 and every gradient leaf within 1e-4 max|g| + 1e-7.
                 The remat policies none, full and dots give equal
                 gradients on two smoke configs; their peak device bytes
                 for one AdamW step at SmolLM-135M's width (2 x 2,048
                 tokens, bf16). SmolLM-135M at its published width in
                 bf16 (fp32 params and moments) through train_loop.run
                 over TokenPipeline, 40 steps of 8 x 2,048 tokens,
                 save_async every 20: the loss falls; tokens/s, step
                 p50/p99, peak bytes and the model FLOPs' share of the
                 dense bf16 peak. Its last checkpoint restored on the CPU
                 and on the card: two fp32 steps from it agree within
                 1e-4. One mamba_mixer layer at falcon-mamba-7b's width
                 (1 x 2,048 tokens): forward and backward ms, the scan's
                 chunk alone, peak bytes. ef_int8_psum in an NCCL group
                 of one rank equals ef_compress.
17. launch       the dry run's step bundles (``launch.steps``) on the
                 card, each built from a copy of its cell's SHAPES entry
                 with a cut: smollm-135m train_4k at batch 8,
                 qwen3-0.6b decode_32k at batch 8, falcon-mamba-7b
                 decode_32k at its batch of 128, granite-moe-1b
                 prefill_32k at batch 1. For each: the h100x1 dry run
                 at that shape, ``materialize`` on the card, the
                 bundle's output against the direct call bit for bit
                 (``train_loop.make_step``, ``decode_step``,
                 ``prefill``), FlopCounterMode on the card equal to the
                 meta count, a warm-up and 5 steps (granite's: 2) timed
                 with CUDA events, peak bytes, the roofline's terms and
                 measured / bound. Then in an NCCL group of one rank: svfusion-
                 msturing search_1k on one pod256 shard (781,250 x 100
                 rows, degree 32, 1,024 queries, synthetic) against the
                 direct sharded step, its l2_gather launches and
                 l2_gather at D = 100 against its plain version and its
                 bound; the SmolLM smoke loss with DTensor params on a
                 (1, 1) mesh bit-equal to the plain loss; ``remesh``.
18. sharded      every LM family's train (loss, gradients, one AdamW
                 step), prefill and two decode steps through
                 ``launch.steps.run_sharded`` on a (2, 2) (data, model)
                 mesh, at the smoke configs in fp32 (granite-moe at both
                 dispatches), 4 x 36 positions. (a) Four gloo processes
                 on this machine's CPU (``--sharded-child``), under its
                 torch: the loss, gradients, params and moments, logits
                 and token ids against one process within the tests'
                 tolerances, outputs laid out by ``out_shardings``, no
                 KV cache gathered in decode; collectives counted. (b)
                 This process as rank 0 of 4 through torch's fake process
                 group, on the card: each family's steps on CUDA
                 DTensors, every op accepted and every param's block of
                 ``shard_shape``; the fake collectives carry no data, so
                 no value is checked there.
19. four_cards   (named only; 4 cards) four rank processes, one a card,
                 in an NCCL group, polled by ``run_ranks`` (at the first
                 that fails the rest are killed and its error printed).
                 (e) ``ef_int8_psum`` and ``make_crosspod_grad_sync``
                 over the four against the mean of their ``ef_compress``
                 in one process, ``remesh`` (2, 2) -> (1, 2), a
                 checkpoint restored onto (2, 2). (c) every sharded case
                 on a (2, 2) NCCL mesh, each rank against one process on
                 its card, the sharded phase's tolerances. (a) the
                 sharded search at Deep1B's width: each rank builds a
                 262,144 x 96 graph (131,072 cache slots) on its card;
                 layouts (4,) data, (2, 2) pod x data, (2, 2) data x
                 query, 1,024 queries (and 10,240 on (4,)); every rank's
                 answer equal to rank 0's one-process merge of the
                 shards' searches with the same entries; recall@10, step
                 ms (CUDA events after a barrier, the max over the
                 ranks), l2_gather launches a rank, all-gathers. (b)
                 svfusion-msturing search_1k at its h100x4 shape, 200M x
                 100, each rank drawing its own 50M-row shard: the bundle
                 against the direct step, step ms beside the h100x4
                 bound, peak bytes a card, l2_gather at the 50M-row
                 table. (d) SmolLM-135M train_4k at batch 32 (8 a card)
                 on (1, 4) and (2, 2): the loss against one process,
                 step ms beside the h100x4 dry run's bound.

Then the kernels line, the card line, and the final status line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import signal
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
PHASES = ("kernels", "parity", "write_parity", "durability", "main",
          "tiered", "consolidation", "partitioned", "distributed",
          "baselines", "calibrate", "serve", "families", "train", "launch",
          "sharded")
EXTRA_PHASES = ("four_cards",)   # run only when named in --only


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
    512] with -1 lanes, duplicates and the boundary ids; bf16 once; the
    device-mode insert's candidate search, ids [512, 512]; and the RAG
    index's retrieval (serve phase): table [2^18, 576], ids [1024, beam x
    degree], which takes the kernel's ROWS_VEC path."""
    import torch
    rag = rag_index_config("cpu", 0)
    rows = {}
    for label, n, D, dtype, B, C in (
            ("capacity", 1 << 20, 96, torch.float32, 1024, 512),
            ("cache", 131_072, 96, torch.float32, 1024, 512),
            ("capacity_bf16", 1 << 20, 96, torch.bfloat16, 1024, 512),
            ("insert", 1 << 20, 96, torch.float32, 512, 512),
            ("rag", rag.capacity, 576, torch.float32, RAG_BATCH,
             rag.search.beam * rag.degree)):
        q = torch.randn(B, D, generator=gen, device=dev)
        table = torch.randn(n, D, generator=gen, device=dev).to(dtype)
        ids = torch.randint(0, n, (B, C), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[torch.rand(B, C, generator=gen, device=dev) < 0.1] = -1
        ids[:, C // 2:C // 2 + 64] = ids[:, :64]          # duplicates
        ids[0, :4] = torch.tensor([0, n - 1, 0, -1], device=dev)
        rows[label] = l2_gather_case(label, table, ids, q)
        del table, ids, q
    if rows["rag"]["path"] != "rows_vec":
        raise AssertionError(f"the RAG shape took {rows['rag']['path']}")
    return rows


def l2_gather_case(label, table, ids, q):
    """l2_gather on the card against its plain version on ``table`` [n,
    D], ``ids`` [B, C] (-1 lanes +inf) and ``q`` [B, D]: checked within
    TOL of the dtype, timed beside the plain version and the bound;
    emitted and returned as a row."""
    import torch
    from repro_torch.kernels.l2_gather import kernel as K
    from repro_torch.kernels.l2_gather.ref import l2_gather_ref
    (n, D), (B, C) = table.shape, ids.shape
    out = K.l2_gather(table, ids, q)
    ref = l2_gather_ref(table, ids, q)
    torch.cuda.synchronize()
    tol = TOL[str(table.dtype).split(".")[1]]
    bad = ids < 0
    if not (torch.isinf(out[bad]).all() and (out[bad] > 0).all()):
        raise AssertionError(f"{label}: invalid lanes are not +inf")
    err = (out[~bad] - ref[~bad]).abs()
    max_abs = err.max().item()
    max_rel = (err / ref[~bad].abs().clamp_min(1e-30)).max().item()
    if not bool((err <= tol * ref[~bad].abs() + tol * D).all()):
        raise AssertionError(f"{label}: max abs err {max_abs} above "
                             f"rtol={tol}, atol={tol * D}")
    bound_ms, bound_by = l2_gather_bound_ms(table, ids)
    geo = K.launch_geometry(B, C, D, table.element_size())
    row = dict(shape=[n, D, B, C], dtype=str(table.dtype),
               path=("rows", "rows_vec", "groups")[geo.path],
               max_abs_err=max_abs, max_rel_err=max_rel, tol=tol,
               ms=cuda_ms(lambda: K.l2_gather(table, ids, q), 30),
               plain_ms=cuda_ms(lambda: l2_gather_ref(table, ids, q), 10),
               bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel", kernel="l2_gather", table=label, **row)
    return row


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


def scan_ids(gen, dev, B, Mp, n, matched):
    """The filtered scan's id matrix: ``matched`` sorted distinct ids
    below ``n``, padded with -1 to ``Mp`` and repeated for each of the
    ``B`` queries as one contiguous [B, Mp] int32 matrix."""
    import torch
    row = torch.full((Mp,), -1, dtype=torch.int32, device=dev)
    pick = torch.randperm(n, generator=gen, device=dev)[:matched]
    row[:matched] = pick.sort().values.to(torch.int32)
    return row.expand(B, Mp).contiguous()


def phase_kernel_pq(gen, dev, n=1 << 20, m=16, K=256, B=1024):
    """pq_adc against its plain version at the tiered path's shapes: codes
    [2^20, 16] u8, LUT [1024, 16, 256], ids [1024, 512] (a round) and
    [1024, 64] (the entry pool); and at the filtered scan's shape, one
    row of matched ids padded with -1 to a power-of-four bucket Mp and
    repeated for every query: Mp = 32,768 (20,000 matches, ~2% of 1M)
    and 131,072 (100,000 matches), with the peak device memory of the
    call beside the inputs'. Tolerance rtol 1e-5, atol 1e-4."""
    import torch
    from repro_torch.kernels.pq_adc import kernel as K_
    from repro_torch.kernels.pq_adc.ref import pq_adc_ref
    codes = torch.randint(0, K, (n, m), generator=gen, device=dev,
                          dtype=torch.uint8)
    lut = torch.rand(B, m, K, generator=gen, device=dev) * 100
    rows = {}
    for label, C, matched in (("round", 512, None), ("entry", 64, None),
                              ("scan_32768", 32_768, 20_000),
                              ("scan_131072", 131_072, 100_000)):
        if matched is None:
            ids = ids_with_holes(gen, dev, B, C, n)
        else:
            ids = scan_ids(gen, dev, B, C, n, matched)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = K_.pq_adc(codes, lut, ids)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
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
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            valid_lanes=int((~bad).sum()), ids_bytes=ids.numel() * 4,
            out_bytes=out.numel() * 4, call_peak_bytes=peak)
        emit("kernel", kernel="pq_adc", ids=label, **rows[label])
        del ids, out, ref, bad, err
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


def phase_kernel_e_in(gen, dev, cap=1 << 21, R=32, live=(262_144, 700_000),
                      odd=100_003):
    """e_in_count against its plain version (the hot bin), exact, at the
    benchmark cells' table [2^21, 32] with 262,144 (the built index) and
    700,000 (after the writes) rows of ids below the live count, 20% of
    their slots -1 and every row after them -1; and at an odd shape,
    [100,003, 7] (N*R not a multiple of 4) viewed 4 bytes past a 16-byte
    boundary. Timed beside its bound (the table read and the output
    zeroed, over HBM bandwidth) and the plain version. Returns the
    262,144-row row."""
    import torch
    from repro_torch.kernels.e_in_count import kernel as K_
    from repro_torch.kernels.e_in_count.ref import e_in_count_ref
    rows = {}
    for label, n, width, n_live, offset in (
            ("built", cap, R, live[0], 0), ("grown", cap, R, live[1], 0),
            ("odd", odd, 7, odd, 1)):
        flat = torch.full((n * width + offset,), -1, dtype=torch.int32,
                          device=dev)
        table = flat[offset:].view(n, width)
        ids = torch.randint(0, n_live, (n_live, width), generator=gen,
                            device=dev, dtype=torch.int32)
        ids[torch.rand(n_live, width, generator=gen, device=dev) < 0.2] = -1
        table[:n_live] = ids
        out = K_.e_in_count(table, n)
        ref = e_in_count_ref(table, n)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"e_in_count {label} differs from its "
                                 "plain version")
        nbytes = table.numel() * 4 + n * 4
        rows[label] = dict(
            shape=[n, width], n_max=n, live_rows=n_live,
            slots_with_ids=int((table >= 0).sum()),
            misaligned=table.data_ptr() % 16 != 0, max_abs_err=0.0,
            exact=True, ms=cuda_ms(lambda: K_.e_in_count(table, n), 30),
            plain_ms=cuda_ms(lambda: e_in_count_ref(table, n), 10),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        emit("kernel", kernel="e_in_count", case=label, **rows[label])
        del flat, table, ids, out, ref
    return rows["built"]


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


FILTER_CASES = (        # tests/test_filters.py: 100%, 50%, ~1%, none
    ("all", dict(ranges={"score": (None, None)})),
    ("half", dict(tags={"cat": {0, 1}})),
    ("one_pct", dict(ranges={"score": (0.0, 0.011)})),
    ("none", dict(ranges={"score": (2.0, 3.0)})),
)


def phase_filtered_parity(gen, dev, sp, n=20_000, d=96, b=128):
    """Filtered ``search_tiered`` on the CPU (plain versions) and on the
    card (kernels) over one integer-valued index with attributes cat =
    i % 4 and score = i / n: every spec of the reference's filter suite,
    on the graph path (threshold 0) and the brute-force path (threshold
    1.1), in the exact lane and in the PQ lane (integer-rounded
    codebook, full topology cache, speculation on). Every field of the
    results must be equal; the card's PQ graph path must launch pq_adc
    and row_gather, and its scan pq_adc wherever a match exists."""
    import torch
    from repro_torch import convert
    from repro_torch.core import cache as Cache
    from repro_torch.core import quant
    from repro_torch.core.build import build_tiered_backend
    from repro_torch.core.filters import AttributeSchema, FilterSpec
    from repro_torch.core.search import search_tiered
    from repro_torch.core.tiers import AttributeStore
    from repro_torch.kernels.pq_adc import kernel as PK
    from repro_torch.kernels.row_gather import kernel as RK
    vecs = int_vectors(gen, n, d, dev).cpu().numpy()
    queries = int_vectors(gen, b, d, dev).cpu().numpy()
    schema = AttributeSchema(tag_fields=("cat",), num_fields=("score",))
    tags = (np.arange(n) % 4)[:, None].astype(np.int32)
    nums = (np.arange(n) / n)[:, None].astype(np.float32)
    out = []
    with tempfile.TemporaryDirectory() as td:
        be = build_tiered_backend(vecs, 32, td, device=dev)
        cb = quant.train_codebook(vecs, 16, 8, iters=10, device=dev)
        cents = quant.codebook_to_array(cb).round()
        codes = quant.encode(quant.codebook_from_array(cents, dev), vecs)
        try:
            hp = Cache.HostPlacement(n, 2048, d, dtype=torch.bfloat16)
            hot = np.argsort(-be.e_in[:n], kind="stable")[:2048]
            hp.warm(hot, vecs[hot])
            f_lam = hp.scores(be.e_in)
            for lane in ("exact", "pq"):
                for path, thresh in (("graph", 0.0), ("fallback", 1.1)):
                    for name, spec in FILTER_CASES:
                        res = {}
                        for where in ("cpu", dev):
                            be.attach_attrs(AttributeStore(
                                schema, n, tags=tags, nums=nums,
                                device=where))
                            kw = {}
                            if lane == "pq":
                                kw = dict(
                                    pq=convert.pq_codes_from_arrays(
                                        cents, codes, n, where),
                                    topo=Cache.warm_topo_cache(
                                        be, 0, device=where),
                                    rerank_depth=32)
                            l0 = (PK.launches, RK.launches)
                            t0 = time.perf_counter()
                            res[str(where)] = search_tiered(
                                be, hp, queries, 7, sp, f_lam=f_lam,
                                speculate=True, filter=FilterSpec(**spec),
                                filter_fallback_selectivity=thresh,
                                device=where, **kw)
                            secs = time.perf_counter() - t0
                            launched = (PK.launches - l0[0],
                                        RK.launches - l0[1])
                        cpu_res, card_res = res["cpu"], res[str(dev)]
                        for f in cpu_res._fields:
                            if not np.array_equal(getattr(cpu_res, f),
                                                  getattr(card_res, f)):
                                raise AssertionError(
                                    f"filtered {lane}/{path}/{name}: card "
                                    f"and CPU differ in {f}")
                        if card_res.filter_path != path:
                            raise AssertionError(
                                f"filtered {lane}/{path}/{name} took the "
                                f"{card_res.filter_path} path")
                        # the PQ graph path scores its entry pool with
                        # pq_adc; rows are gathered once a frontier exists
                        want = (0, 0) if lane == "exact" else \
                            (int(name != "none"), 0) \
                            if path == "fallback" else \
                            (1, int(name != "none"))
                        if any(w and not g for w, g in zip(want,
                                                           launched)):
                            raise AssertionError(
                                f"filtered {lane}/{path}/{name}: launches "
                                f"(pq_adc, row_gather) = {launched}")
                        out.append(dict(
                            lane=lane, path=path, spec=name,
                            selectivity=card_res.filter_selectivity,
                            found=int((card_res.ids >= 0).sum()),
                            card_s=secs, pq_adc_launches=launched[0],
                            row_gather_launches=launched[1]))
        finally:
            be.close()
    emit("filtered_parity", n=n, d=d, queries=b,
         identical=list(cpu_res._fields), cases=out)


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
        merged = mvcc.merge_consolidated(cons, st, snap_n, [rev2])
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


DURABLE_N, DURABLE_ROWS = 20_000, 512
CRASH_COMBOS = (("post_wal_append", 1), ("mid_memmap_write", 4),
                ("pre_manifest_rename", 3), ("mid_consolidation_merge", 6))


def durable_config(path, dev, cap=DURABLE_N + 4 * DURABLE_ROWS):
    """The durability phase's three-tier engine: Deep1B's width, the PQ
    lane on a full topology cache, attributes (cat, score), the WAL at
    its defaults, snapshots only where the stream asks, no background
    work (coalescer, prefetcher, automatic consolidation) and the
    deterministic frontier predictor."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.filters import AttributeSchema
    from repro_torch.core.types import SearchParams
    return EngineConfig(
        degree=32, cache_slots=2048, capacity=cap,
        search=SearchParams(k=10, pool=64, max_iters=64, beam=16), seed=0,
        disk_path=str(path), disk_capacity=cap, host_window=cap // 4,
        pq_enabled=True, pq_m=16, pq_bits=8, rerank_depth=32,
        topo_cache_slots=0, coalesce=False, prefetch=False, speculate=True,
        spec_rank="flam", consolidate_threshold=2.0,
        snapshot_every_epochs=0, device=str(dev),
        attributes=AttributeSchema(tag_fields=("cat",),
                                   num_fields=("score",)))


def durable_stream(seed, n=DURABLE_N, d=96, rows=DURABLE_ROWS):
    """The durability phase's update stream, a function of ``seed`` alone
    (the crash child rebuilds it): four inserts of ``rows`` integer
    vectors with attributes, two deletes, a checkpoint and a
    consolidation; every op but the checkpoint is one WAL record."""
    rng = np.random.default_rng(seed + 17)
    new = rng.integers(-8, 9, (4 * rows, d)).astype(np.float32)
    attrs = {"cat": rng.integers(0, 4, 4 * rows),
             "score": rng.random(4 * rows).astype(np.float32)}
    ops = [("insert", 0), ("insert", 1),
           ("delete", rng.choice(n, 300, replace=False)),
           ("checkpoint", None), ("insert", 2),
           ("delete", rng.choice(n + 2 * rows, 300, replace=False)),
           ("consolidate", None), ("insert", 3)]
    return new, attrs, ops


def run_durable_stream(eng, stream, crash=None, after_record=None,
                       rows=DURABLE_ROWS):
    """Drive ``stream`` through the engine's entry points; ``crash`` =
    (point, op) arms a kill at that crash point just before op ``op``."""
    new, attrs, ops = stream
    for i, (kind, arg) in enumerate(ops):
        if crash is not None and i == crash[1]:
            arm_crash(crash[0])
        if kind == "insert":
            sl = slice(arg * rows, (arg + 1) * rows)
            eng.insert(new[sl], attributes={k: v[sl]
                                            for k, v in attrs.items()})
        elif kind == "delete":
            eng.delete(arg)
        elif kind == "checkpoint":
            eng.checkpoint()
        else:
            if eng.consolidate_async(wait=True) is None:
                raise AssertionError("the consolidation was deferred")
        if kind != "checkpoint" and after_record is not None:
            after_record(eng)


def arm_crash(point):
    """Kill this process (exit code 137, as kill -9) the first time it
    passes the named crash point."""
    import os

    from repro_torch.core import wal

    def hook(name):
        if name == point:
            os._exit(137)
    wal.set_crash_hook(hook)


def tiered_probe(eng, queries, specs, dev):
    """``search_tiered`` of the engine's backend on fixed inputs: seed 5,
    no speculation and an empty fp32 exact cache, so that the result is
    a function of the durable state alone (what a reopened engine must
    reproduce). One result per spec (None: unfiltered)."""
    from repro_torch.core import cache as Cache
    from repro_torch.core.search import search_tiered
    be = eng._backend
    hp = Cache.HostPlacement(be.capacity, 1, be.dim)
    return [search_tiered(be, hp, queries, 5, eng.cfg.search, pq=be.pq,
                          topo=be.topo, rerank_depth=eng.cfg.rerank_depth,
                          speculate=False, filter=spec,
                          filter_fallback_selectivity=(
                              eng.cfg.filter_fallback_selectivity),
                          device=dev) for spec in specs]


def durable_digest(eng, queries, dev):
    """The logical state recovery must rebuild: rows, vectors, alive,
    e_in, version, n, PQ codes and attribute columns over [0, n), and
    ``tiered_probe`` unfiltered, on the graph path and on the brute-force
    path."""
    from repro_torch.core.filters import FilterSpec
    be = eng._backend
    n = be.n
    out = {}
    specs = (None, FilterSpec(tags={"cat": {0, 1}}),
             FilterSpec(ranges={"score": (0.0, .02)}))
    for name, r in zip(("all", "graph", "scan"),
                       tiered_probe(eng, queries, specs, dev)):
        out[f"{name}_ids"], out[f"{name}_dists"] = r.ids, r.dists
        out[f"{name}_path"] = np.asarray(r.filter_path)
    ids = np.arange(n)
    tags, nums = be.attrs.snapshot(n)
    out.update(nbr=be.store.peek_rows(ids), vec=be.store.peek(ids)[0],
               alive=be.alive[:n].copy(), e_in=be.e_in.copy(),
               version=be.version.copy(), n=np.int64(n),
               codes=be.pq.codes[:n].copy(), tags=tags, nums=nums)
    return out


def _same_arrays(a, b, what):
    """Raise unless ``a`` and ``b`` (arrays, or lists of arrays) are equal
    in shape, dtype and value."""
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            raise AssertionError(f"{what}: lengths differ")
        for x, y in zip(a, b):
            _same_arrays(x, y, what)
        return
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or not np.array_equal(a, b):
        raise AssertionError(f"{what}: {a.dtype}{a.shape} and "
                             f"{b.dtype}{b.shape} differ")


def durable_files(path):
    """(manifest without its snapshot CRC, snapshot arrays, WAL records)
    of the epoch a directory's manifest names. The CRC is left out: the
    npz's zip headers carry the time they were written."""
    from repro_torch.core import wal
    man = wal.load_manifest(str(path))
    with np.load(Path(path) / man["snapshot"]) as z:
        snap = {k: z[k] for k in z.files}
    recs, valid = wal.read_records(str(Path(path) / man["wal"]))
    return ({k: v for k, v in man.items() if k != "snapshot_crc"}, snap,
            recs, valid)


def _same_files(a, b, what):
    man_a, snap_a, recs_a, _ = a
    man_b, snap_b, recs_b, _ = b
    if man_a != man_b:
        raise AssertionError(f"{what}: manifests differ")
    if set(snap_a) != set(snap_b):
        raise AssertionError(f"{what}: snapshot arrays differ")
    for k in snap_a:
        _same_arrays(snap_a[k], snap_b[k], f"{what}, snapshot {k}")
    if [r[:2] for r in recs_a] != [r[:2] for r in recs_b]:
        raise AssertionError(f"{what}: WAL record types or seqs differ")
    for (rt, seq, pa), (_, _, pb) in zip(recs_a, recs_b):
        if set(pa) != set(pb):
            raise AssertionError(f"{what}: record {seq} keys differ")
        for k in pa:
            _same_arrays(pa[k], pb[k], f"{what}, record {seq} {k}")


def make_durable_base(path, vecs, dev, cap):
    """Epoch 0 of the durability phase's index in ``path``: the graph
    built on the card, an integer-rounded PQ codebook (every ADC sum is
    exact), attribute columns cat = i % 4 and score = (i % 97) / 97,
    published by ``wal.publish_snapshot``."""
    from repro_torch import convert
    from repro_torch.core import quant, wal
    from repro_torch.core.build import build_tiered_backend
    from repro_torch.core.filters import AttributeSchema
    from repro_torch.core.tiers import AttributeStore
    n = len(vecs)
    be = build_tiered_backend(vecs, 32, str(path), disk_capacity=cap,
                              host_window=cap // 4, device=dev)
    cb = quant.train_codebook(vecs, 16, 8, iters=10, device=dev)
    cents = quant.codebook_to_array(cb).round()
    codes = quant.encode(quant.codebook_from_array(cents, dev), vecs)
    be.attach_pq(convert.pq_codes_from_arrays(cents, codes, cap, "cpu"))
    be.attach_attrs(AttributeStore(
        AttributeSchema(tag_fields=("cat",), num_fields=("score",)), cap,
        tags=(np.arange(n) % 4)[:, None],
        nums=((np.arange(n) % 97) / 97)[:, None], device="cpu"))
    man, log = wal.publish_snapshot(str(path), be, None)
    log.close()
    be.close()
    return man


def crash_child(args):
    """The crash slice's child (``--crash-child DIR``): recover DIR on the
    card, run the durability stream with a kill armed at
    ``--crash-point`` before op ``--crash-op``. Exit code 137 is the
    kill; 3 means the armed point was never reached."""
    import torch
    from repro_torch.core.engine import SVFusionEngine
    eng = SVFusionEngine(None, durable_config(args.crash_child,
                                              torch.device("cuda", 0)))
    run_durable_stream(eng, durable_stream(args.seed),
                       crash=(args.crash_point, args.crash_op))
    sys.exit(3)


def phase_durability(gen, dev, seed, n=DURABLE_N, d=96, q_rows=256):
    """The WAL, snapshots and recovery on the write-parity index size
    (integer data): epoch 0 published once, then the same stream of
    inserts with attributes, deletes, a checkpoint and a consolidation
    through ``SVFusionEngine`` on the CPU and on the card, each from its
    own copy of epoch 0. Manifests (but the snapshot CRC), snapshot
    arrays and WAL record payloads must be equal, before and after
    ``close()``. Then the crash slice: a child process per crash point,
    killed there by ``os._exit(137)``, reopened on the card; its digest
    must equal the card run's digest after the same number of durable
    records."""
    import shutil

    from repro_torch.core.engine import SVFusionEngine
    from repro_torch.kernels.pq_adc import kernel as PK
    from repro_torch.kernels.row_gather import kernel as RK
    cap = n + 4 * DURABLE_ROWS
    vecs = int_vectors(gen, n, d, dev).cpu().numpy()
    queries = int_vectors(gen, q_rows, d, dev).cpu().numpy()
    stream = durable_stream(seed, n, d)
    record_ops = [k for k, _ in stream[2] if k != "checkpoint"]
    out = {}
    procs = []
    with tempfile.TemporaryDirectory() as td:
        base = Path(td) / "base"
        t0 = time.perf_counter()
        make_durable_base(base, vecs, dev, cap)
        out["base_s"] = time.perf_counter() - t0
        try:
            # the crash children run while the parent runs the streams
            for point, op in CRASH_COMBOS:
                path = Path(td) / f"crash-{point}"
                shutil.copytree(base, path)
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--seed", str(seed), "--crash-child", str(path),
                     "--crash-point", point, "--crash-op", str(op)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            runs, digests = {}, []
            for tag, where in (("cpu", "cpu"), ("card", dev)):
                path = Path(td) / tag
                shutil.copytree(base, path)
                t0 = time.perf_counter()
                eng = SVFusionEngine(None, durable_config(path, where, cap))
                open_s = time.perf_counter() - t0
                on_card = tag == "card"
                if on_card:
                    PK.launches = RK.launches = 0
                    digests.append(durable_digest(eng, queries, dev))
                t0 = time.perf_counter()
                run_durable_stream(
                    eng, stream, after_record=(lambda e: digests.append(
                        durable_digest(e, queries, dev))) if on_card
                    else None)
                secs = time.perf_counter() - t0
                if on_card:
                    launched = (PK.launches, RK.launches)
                log = eng._wal
                runs[tag] = dict(
                    files=durable_files(path), open_s=open_s, stream_s=secs,
                    wal_bytes=log.bytes, wal_fsyncs=log.fsyncs,
                    wal_records=log.appended, epoch=eng._durable_epoch)
                t0 = time.perf_counter()
                eng.close()
                runs[tag]["close_s"] = time.perf_counter() - t0
                runs[tag]["closed"] = durable_files(path)
            cpu, card = runs["cpu"], runs["card"]
            _same_files(cpu["files"], card["files"], "durable stream")
            _same_files(cpu["closed"], card["closed"], "after close")
            if len(card["files"][2]) != 4 or card["closed"][2] or \
                    min(launched) == 0:
                raise AssertionError(
                    f"durable stream: {len(card['files'][2])} records in "
                    f"the last segment, {len(card['closed'][2])} after "
                    f"close, launches {launched}")
            crashes = []
            for (point, op), p in zip(CRASH_COMBOS, procs):
                _, err = p.communicate(timeout=900)
                if p.returncode != 137:
                    raise AssertionError(f"crash child at {point}: exit "
                                         f"{p.returncode}\n{err[-2000:]}")
                path = Path(td) / f"crash-{point}"
                t0 = time.perf_counter()
                eng = SVFusionEngine(None, durable_config(path, dev, cap))
                reopen_s = time.perf_counter() - t0
                st = eng.stats()
                k = st["recovered_to_seq"]
                want = sum(1 for kind, _ in stream[2][:op]
                           if kind != "checkpoint") + int(
                               point != "pre_manifest_rename")
                if k != want:
                    raise AssertionError(f"crash at {point}: {k} durable "
                                         f"records, expected {want}")
                dig = durable_digest(eng, queries, dev)
                eng.close()
                for key, v in digests[k].items():
                    _same_arrays(dig[key], v, f"crash at {point}, {key}")
                crashes.append(dict(
                    point=point, op=op, exit=p.returncode, records=k,
                    replayed=st["recovered_replayed"],
                    truncated_bytes=st["recovered_truncated_bytes"],
                    epoch=st["recovered_epoch"], reopen_s=reopen_s,
                    identical=sorted(dig)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    emit("durability", n=n, d=d, cap=cap, base_s=out["base_s"],
         record_ops=record_ops,
         **{f"{w}_{k}": runs[w][k] for w in runs
            for k in ("open_s", "stream_s", "close_s", "wal_bytes",
                      "wal_fsyncs", "wal_records", "epoch")},
         pq_adc_launches=launched[0], row_gather_launches=launched[1],
         identical=["manifest (without snapshot_crc)", "snapshot arrays",
                    "WAL records"], crashes=crashes)
    return launched


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
                 for name in ("l2_gather", "pq_adc", "row_gather",
                              "e_in_count")
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
    after which no edge reaches any dead vertex. Returns the e_in_count
    launches of the steps' inserts."""
    import torch
    from repro_torch.core import mvcc, update
    from repro_torch.core.build import compute_e_in
    from repro_torch.core.search import brute_force_topk, recall_at_k
    from repro_torch.kernels.e_in_count import kernel as EK
    from repro_torch.kernels.l2_gather import kernel as K
    deleted, oldest = [], 0
    e_in_launches = 0

    def step(i, phase="write_step"):
        nonlocal oldest, e_in_launches
        new = draw(rows).cpu().numpy()
        l0, e0 = K.launches, EK.launches
        t = time.perf_counter()
        ids = eng.insert(new)
        torch.cuda.synchronize()
        ins_s = time.perf_counter() - t
        launched = K.launches - l0
        e_launched = EK.launches - e0
        e_in_launches += e_launched
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
             l2_gather_launches_by_inserts=launched,
             e_in_count_launches_by_inserts=e_launched, recall_at_10=rec,
             read_after_write=raw, deleted_ids_returned=leaked,
             n=int(eng.state.graph.n), alive=int(eng.state.graph.alive.sum()))
        if launched == 0 or e_launched == 0 or raw < min_raw or leaked or \
                not np.isfinite(dists).all():
            raise AssertionError(f"write step {i}: l2_gather launches "
                                 f"{launched}, e_in_count launches "
                                 f"{e_launched}, read-after-write {raw}, "
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
    return e_in_launches


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
    ``state`` holds the vectors on the card, the deleted ids, the oldest
    live id and, optionally, ``attrs``: a function of a row count giving
    the inserted rows' attribute columns."""
    import torch
    from repro_torch.core.search import recall_at_k
    from repro_torch.kernels.pq_adc import kernel as PK
    from repro_torch.kernels.row_gather import kernel as RK
    be = eng._backend
    new_t = draw(rows)
    new = new_t.cpu().numpy()
    attrs = state["attrs"](rows) if "attrs" in state else None
    t = time.perf_counter()
    ids = eng.insert(new, attributes=attrs)
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
               + (10_240,), recall_q=1024, min_recall=0.5, write=True,
               keep=None):
    """The device-mode engine at Deep1B's published width
    (configs/svfusion_deep1b.py: D=96, degree 32, pool 64, k=10, 64 hops,
    131,072 cache slots), N cut to 262,144 so that this build and the
    tiered path's 1M build fit the run's time, requests through the
    coalescer. Returns the l2_gather launches made by the requests (not
    by the profiled batches after them). Then, with ``write``, the
    sliding-window write stream (``phase_write_stream``). ``keep``, when
    a dict, receives the vectors, the requests, their recall@10 and the
    engine's ``modeled_us_per_access`` for the later phases."""
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
        recalls = []
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
            recalls.append(rec)
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
        if keep is not None:
            keep.update(vecs=vecs, queries=queries, recall=recalls,
                        modeled_us_per_access=st["modeled_us_per_access"])
        phase_profile(eng, queries[:3])
        phase_knn_chunk(vecs)
        if write:
            e_in_launches = phase_write_stream(eng, draw, dev)
            if keep is not None:
                keep["e_in_count_launches"] = e_in_launches
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


def tiered_config(td, seed, cap=1 << 20, attributes=None):
    """The three-tier configuration of the tiered phases, on a disk tier
    of ``cap`` rows in the directory ``td``, with the write-ahead log at
    its defaults (on, group commit 8, a snapshot every 512 update
    batches) and the attribute schema ``attributes``."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.types import SearchParams
    return EngineConfig(
        degree=32, cache_slots=131_072, capacity=cap,
        search=SearchParams(k=10, pool=64, max_iters=64, beam=16),
        seed=seed, disk_path=td, disk_capacity=cap, pq_enabled=True,
        pq_m=16, pq_bits=8, rerank_depth=32, topo_cache_slots=0,
        fused_rounds=0, speculate=True, prefetch=True, spec_rank="auto",
        cache_dtype="bf16", attributes=attributes)


def filtered_requests(eng, vecs, queries, specs, dev, k=10):
    """Filtered requests through ``engine.search``: per request its path,
    the sampled selectivity, latency, recall@10 against an exact scan of
    the alive matched set on the card, the (pq_adc, row_gather) launches
    and the request's peak device memory above what was allocated."""
    import torch
    from repro_torch.core.filters import compile_filter, host_pass
    from repro_torch.core.search import brute_force_topk, recall_at_k
    from repro_torch.core.types import GraphState
    from repro_torch.kernels.pq_adc import kernel as PK
    from repro_torch.kernels.row_gather import kernel as RK
    be = eng._backend
    n = be.n
    rows = []
    for name, spec in specs:
        cf = compile_filter(spec, be.attrs.schema)
        ok = host_pass(cf, be.attrs.tags[:n], be.attrs.nums[:n]) \
            & be.alive[:n]
        g = GraphState(vecs[:n], None, torch.as_tensor(ok, device=dev),
                       None, None, None)
        for q in queries:
            truth = brute_force_topk(g, q, k)[0]
            q_host = q.cpu().numpy()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            l0 = (PK.launches, RK.launches)
            t = time.perf_counter()
            ids, dists = eng.search(q_host, filter=spec)
            dt = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() - base
            st = eng.stats()
            rec = float(recall_at_k(torch.as_tensor(ids, device=dev), truth))
            live = ids[ids >= 0]
            row = dict(spec=name, path=st["filter_last_path"],
                       selectivity=st["filter_last_selectivity"],
                       matched=int(ok.sum()), queries=len(q_host),
                       latency_s=dt, qps=len(q_host) / dt,
                       recall_at_10=rec,
                       pq_adc_launches=PK.launches - l0[0],
                       row_gather_launches=RK.launches - l0[1],
                       peak_bytes=peak)
            emit("tiered_filtered_request", **row)
            rows.append(row)
            if not ok[live].all() or not np.isfinite(dists[ids >= 0]).all():
                raise AssertionError(f"filtered request {name}: an id "
                                     "that fails the filter, or a non-"
                                     "finite distance")
    return rows


def phase_tiered_main(gen, dev, seed, n=1_000_000, d=96, sizes=(1024,) * 8
                      + (10_240,), recall_q=1024, min_recall=0.5,
                      write_steps=2, write_rows=2048, filtered_q=3,
                      min_graph_filter_recall=0.2, keep=None):
    """The three-tier engine at Deep1B's published width
    (configs/svfusion_deep1b.py: D=96, degree 32, pool 64, k=10, 64 hops
    at beam 16, 131,072 exact-cache slots in bf16) with the PQ lane (m=16,
    8 bits, re-rank depth 32), the topology cache at full residency, no
    K-round cap, speculation and prefetch on, the WAL at its defaults and
    an attribute schema of one 16-value tag and one uniform score (drawn
    from the seed); N cut to 1M synthetic rows on a 2^20-row disk tier in
    a temporary directory. Returns the (pq_adc, row_gather) launches of
    the unfiltered requests and of the filtered ones. After the
    requests: stats, a profile, a wall-time split by stage,
    ``filtered_q`` 1,024-query requests at ~50% selectivity (graph path)
    and at ~2% (brute-force scan), the sliding-window write stream
    (``write_steps`` steps of ``write_rows`` with attributes; WAL bytes
    and fsyncs), the profile of one 512-row insert; then ``close()`` (the
    final publish), a reopen with ``init_vectors=None`` and the same
    unfiltered and filtered ``search_tiered`` calls, which must return
    identical ids and distances. The consolidation runs on a smaller
    index (``phase_tiered_consolidation``). ``keep``, when a dict,
    receives the engine's ``modeled_us_per_access``."""
    import os

    import torch
    from repro_torch.core import wal
    from repro_torch.core.engine import SVFusionEngine
    from repro_torch.core.filters import AttributeSchema, FilterSpec
    from repro_torch.core.search import brute_force_topk, recall_at_k
    from repro_torch.core.types import GraphState
    from repro_torch.kernels.pq_adc import kernel as PK
    from repro_torch.kernels.row_gather import kernel as RK
    draw = synthetic_descriptors(gen, n, d, dev)
    vecs = draw(n)
    queries = [draw(b) for b in sizes]
    fq = [draw(1024) for _ in range(filtered_q)]
    rng = np.random.default_rng(seed + 1)

    def attrs(m):
        return {"tag": rng.integers(0, 16, m),
                "score": rng.random(m).astype(np.float32)}
    schema = AttributeSchema(tag_fields=("tag",), num_fields=("score",),
                             tag_domain=16)
    specs = (("half", FilterSpec(tags={"tag": set(range(8))})),
             ("two_pct", FilterSpec(ranges={"score": (0.0, 0.02)})))
    with tempfile.TemporaryDirectory() as td:
        cfg = tiered_config(td, seed, attributes=schema)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = SVFusionEngine(vecs.cpu().numpy(), cfg, init_attrs=attrs(n))
        torch.cuda.synchronize()
        emit("build_tiered", n=n, d=d, build_s=time.perf_counter() - t0,
             **eng.build_timings,
             peak_device_bytes=torch.cuda.max_memory_allocated(),
             durable_epoch=eng.stats()["durable_epoch"],
             disk_bytes=sum(f.stat().st_size for f in Path(td).iterdir()))
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
            if keep is not None:
                keep["modeled_us_per_access"] = st["modeled_us_per_access"]
            phase_profile(eng, queries[:3], phase="tiered_profile")
            phase_tiered_stages(eng, queries[:3])
            # the filtered path, counted alone
            PK.launches = RK.launches = 0
            frows = filtered_requests(eng, vecs, fq, specs, dev)
            f_launched = (PK.launches, RK.launches)
            paths = {r["spec"]: {x["path"] for x in frows
                                 if x["spec"] == r["spec"]} for r in frows}
            # recall floors that catch a broken lane: the graph path's
            # walk only crosses vertices that pass the filter (the
            # reference's in-scan masking), so at 50% selectivity it
            # reaches less than the unfiltered walk; the card equals the
            # CPU and the reference there (parity phase)
            floors = {"graph": min_graph_filter_recall,
                      "fallback": min_recall}
            if paths != {"half": {"graph"}, "two_pct": {"fallback"}} or \
                    min(f_launched) == 0 or min(
                        r["pq_adc_launches"] for r in frows) == 0 or any(
                        r["recall_at_10"] < floors[r["path"]]
                        for r in frows):
                raise AssertionError(
                    f"filtered requests: paths {paths}, launches "
                    f"{f_launched}, recall@10 "
                    f"{[round(r['recall_at_10'], 3) for r in frows]}")
            state = dict(vecs=vecs, deleted=[], oldest=0, attrs=attrs)
            log = eng._wal
            w0 = (log.bytes, log.fsyncs, log.appended)
            # the log's own time inside the stream: appends (pickling,
            # the unbuffered write, the group-commit fsyncs) and fsyncs
            acc = {}
            undo = [_timed(wal.WriteAheadLog, "append", acc),
                    _timed(os, "fsync", acc)]
            t0 = time.perf_counter()
            try:
                for i in range(write_steps):
                    tiered_stream_step(eng, state, draw, dev, i, write_rows)
            finally:
                for u in undo:
                    u()
            stream_s = time.perf_counter() - t0
            if eng._wal is not log:
                raise AssertionError("a checkpoint rotated the WAL mid-"
                                     "stream; its counts would be cut")
            emit("tiered_wal", steps=write_steps, rows=write_rows,
                 stream_s=stream_s, append_s=acc.get("append", 0.0),
                 fsync_s=acc.get("fsync", 0.0),
                 append_share=acc.get("append", 0.0) / stream_s,
                 records=log.appended - w0[2], bytes=log.bytes - w0[0],
                 fsyncs=log.fsyncs - w0[1],
                 group_commit=log.group_commit,
                 bytes_per_inserted_row=(log.bytes - w0[0])
                 / (write_steps * write_rows))
            prof_rows = draw(512)
            device_profile(lambda: eng.insert(prof_rows.cpu().numpy(),
                                              attributes=attrs(512)),
                           "write_profile", mode="three-tier",
                           inserted=len(prof_rows))
            probe_q = fq[0].cpu().numpy()
            probe_specs = (None,) + tuple(sp for _, sp in specs)
            before = tiered_probe(eng, probe_q, probe_specs, dev)
            n_live = eng._backend.n
        finally:
            t0 = time.perf_counter()
            eng.close()
            close_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng = SVFusionEngine(None, cfg)
        torch.cuda.synchronize()
        reopen_s = time.perf_counter() - t0
        try:
            after = tiered_probe(eng, probe_q, probe_specs, dev)
            for spec, a, b in zip(("none", "half", "two_pct"), before,
                                  after):
                if not (np.array_equal(a.ids, b.ids)
                        and np.array_equal(a.dists, b.dists)
                        and a.filter_path == b.filter_path):
                    raise AssertionError(f"reopened engine answers {spec} "
                                         "differently")
            st = eng.stats()
            ids, dists = eng.search(queries[0].cpu().numpy())
            rec = float(recall_at_k(torch.as_tensor(
                ids[:recall_q], device=dev), truth[0]))
            emit("tiered_reopen", close_s=close_s, reopen_s=reopen_s,
                 recover_s=eng.build_timings.get("recover_s"),
                 n=st["n"], recovered_epoch=st["recovered_epoch"],
                 recovered_replayed=st["recovered_replayed"],
                 identical=["ids", "dists", "filter_path"],
                 paths=[r.filter_path for r in after],
                 request_recall_at_10=rec, n_before_close=n_live)
            if st["n"] != n_live or st["recovered_replayed"] != 0 or \
                    rec < min_recall:
                raise AssertionError(f"reopen: n {st['n']} vs {n_live}, "
                                     f"replayed {st['recovered_replayed']}"
                                     f", recall {rec}")
        finally:
            eng.close()
    return launched, f_launched


def phase_tiered_consolidation(gen, dev, seed, n=65_536, d=96, steps=2,
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


# ---------------------------------------------------------------------------
# The rest of core/: the partitioned build, the sharded search, the
# baselines and the cost model
# ---------------------------------------------------------------------------

def _same(a, b, what):
    """Raise unless tensors ``a`` and ``b`` (any devices) are equal."""
    import torch
    if not torch.equal(a.cpu(), b.cpu()):
        raise AssertionError(f"{what} differ")


def _partitioned_config(dev, **kw):
    """The main phase's configuration, built in 4 partitions with 256
    cross samples unless ``kw`` says otherwise."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.types import SearchParams
    return EngineConfig(**{
        "degree": 32, "build_partitions": 4, "build_cross_samples": 256,
        "search": SearchParams(k=10, pool=64, max_iters=64, beam=16),
        "device": str(dev), **kw})


def phase_partitioned_parity(gen, dev, n=20_000, d=96, b=256):
    """The partitioned build (4 partitions, 256 cross samples) of an
    integer-valued index on the CPU (plain l2_gather) and on the card
    (kernel), in both engine modes: the graph, the in-degrees, the warm
    cache's ids and the answers must be identical."""
    import torch
    from repro_torch.core.engine import SVFusionEngine
    from repro_torch.core.search import frontier_search
    from repro_torch.kernels.l2_gather import kernel as K
    vecs = int_vectors(gen, n, d, dev).cpu().numpy()
    q = int_vectors(gen, b, d, dev)
    entries = torch.randint(0, n, (b, 64), generator=gen, device=dev,
                            dtype=torch.int32)
    out = {}
    engines = {}
    for tag, where in (("cpu", "cpu"), ("card", dev)):
        l0 = K.launches
        t0 = time.perf_counter()
        engines[tag] = SVFusionEngine(vecs, _partitioned_config(
            where, cache_slots=2048, capacity=n, coalesce=False))
        out[f"build_s_{tag}"] = time.perf_counter() - t0
        if tag == "card":
            out["card_build_launches"] = K.launches - l0
    cpu, card = engines["cpu"], engines["card"]
    try:
        for part, fields in (("graph", ("nbrs", "e_in")),
                             ("cache", ("slot_hid", "h2d"))):
            for f in fields:
                _same(getattr(getattr(card.state, part), f),
                      getattr(getattr(cpu.state, part), f),
                      f"partitioned device mode, card and CPU: {part}.{f}")
        sp = card.cfg.search
        a = frontier_search(card.state, q, entries, sp)
        b_ = frontier_search(cpu.state, q.cpu(), entries.cpu(), sp)
        for f in ("ids", "dists", "acc_ids"):
            _same(getattr(a, f), getattr(b_, f),
                  f"partitioned device mode, card and CPU: {f}")
    finally:
        cpu.close()
        card.close()
    if out["card_build_launches"] == 0:
        raise AssertionError("the card's partitioned build launched no "
                             "l2_gather")
    qn = q.cpu().numpy()
    with tempfile.TemporaryDirectory() as td:
        res = {}
        for tag, where in (("cpu", "cpu"), ("card", dev)):
            eng = SVFusionEngine(vecs, _partitioned_config(
                where, cache_slots=2048, capacity=n,
                disk_path=f"{td}/{tag}", disk_capacity=n, coalesce=False,
                prefetch=False, spec_rank="flam", cache_dtype="fp32"))
            try:
                be = eng._backend
                res[tag] = (np.array(be.store.disk.nbr[:n]),
                            be.e_in[:n].copy(), *eng.search(qn))
            finally:
                eng.close()
        for name, x, y in zip(("nbrs", "e_in", "ids", "dists"), res["cpu"],
                              res["card"]):
            if not np.array_equal(x, y):
                raise AssertionError(f"three-tier partitioned build: card "
                                     f"and CPU differ in {name}")
    emit("partitioned_parity", n=n, d=d, queries=b, partitions=4,
         cross_samples=256, **out,
         identical=["device mode: nbrs, e_in, cache slot_hid and h2d, "
                    "ids, dists, acc_ids",
                    "three-tier: disk nbrs, e_in, ids, dists"])


def l2_gather_build_shape(vecs, nbrs, gen, rows=2048, cross=256):
    """l2_gather at the partitioned merge's shape: ids [rows, 64] (a
    row's 32 graph neighbours and its 32 nearest of 256 sampled global
    columns, as the merge's [local | cross] candidates), queries the
    rows themselves, the whole table. Kernel against its plain version,
    with times and the bound."""
    import torch
    from repro_torch.core.build import pairwise_l2
    from repro_torch.core.topk import smallest_k
    from repro_torch.kernels.l2_gather import kernel as K
    from repro_torch.kernels.l2_gather.ref import l2_gather_ref
    n, D = vecs.shape
    s = n // 2
    samp = torch.randperm(n, generator=gen, device=vecs.device)[:cross]
    ci = smallest_k(pairwise_l2(vecs[s:s + rows], vecs[samp]), 32)[1]
    ids = torch.cat([nbrs[s:s + rows], samp[ci].to(torch.int32)], dim=1)
    q = vecs[s:s + rows]
    out = K.l2_gather(vecs, ids, q)
    ref = l2_gather_ref(vecs, ids, q)
    torch.cuda.synchronize()
    ok = ids >= 0
    err = (out[ok] - ref[ok]).abs()
    tol = TOL["float32"]
    if not bool((err <= tol * ref[ok].abs() + tol * D).all()) or \
            not torch.isinf(out[~ok]).all():
        raise AssertionError(f"l2_gather at the build shape: max abs err "
                             f"{err.max().item()}")
    bound_ms, bound_by = l2_gather_bound_ms(vecs, ids)
    row = dict(shape=[n, D, rows, ids.shape[1]], dtype="torch.float32",
               max_abs_err=err.max().item(), tol=tol,
               ms=cuda_ms(lambda: K.l2_gather(vecs, ids, q), 30),
               plain_ms=cuda_ms(lambda: l2_gather_ref(vecs, ids, q), 10),
               bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel", kernel="l2_gather", table="build", **row)
    return row


def phase_partitioned(gen, dev, seed, main=None, n=262_144, d=96,
                      recall_q=1024, min_recall=0.3):
    """A device-mode engine with ``build_partitions=4`` (256 cross samples,
    the reference's Fig. 11 setting in benchmarks/bench_disk.py) on the
    main phase's vectors, capacity and requests (``main``: what
    ``phase_main`` kept; drawn and built here at one partition when the
    main phase did not run). Prints the build's seconds by pass, its peak
    device memory and l2_gather launches, each request's recall@10 beside
    the one-partition engine's, and l2_gather at the merge's shape.
    Returns (l2_gather launches of the build, the build-shape row, the
    engine's state)."""
    import torch
    from repro_torch.core.engine import SVFusionEngine
    from repro_torch.core.search import brute_force_topk, recall_at_k
    from repro_torch.kernels.l2_gather import kernel as K
    phase_partitioned_parity(gen, dev)
    if main is None:
        draw = synthetic_descriptors(gen, n, d, dev)
        vecs = draw(n)
        queries = [draw(b) for b in (1024,) * 8 + (10_240,)]
        single = SVFusionEngine(vecs, _partitioned_config(
            dev, cache_slots=131_072, capacity=1 << 20, seed=seed,
            build_partitions=1))
        try:
            truth = [brute_force_topk(single.state.graph, q[:recall_q],
                                      10)[0] for q in queries]
            main = dict(vecs=vecs, queries=queries, recall=[float(
                recall_at_k(torch.as_tensor(single.search(
                    q.cpu().numpy())[0][:recall_q], device=dev), t))
                for q, t in zip(queries, truth)])
        finally:
            single.close()
    vecs, queries = main["vecs"], main["queries"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    K.launches = 0                     # count the partitioned build alone
    t0 = time.perf_counter()
    eng = SVFusionEngine(vecs, _partitioned_config(
        dev, cache_slots=131_072, capacity=1 << 20, seed=seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = K.launches
    # the share of the graph's edges that join two partitions
    nb = eng.state.graph.nbrs[:n]
    cuts = torch.as_tensor(np.linspace(0, n, 5).astype(int)[1:-1],
                           device=dev)
    part = torch.bucketize(torch.arange(n, device=dev), cuts, right=True)
    cross = (torch.bucketize(nb.clamp(min=0), cuts, right=True)
             != part[:, None]) & (nb >= 0)
    emit("build_partitioned", n=n, d=d, partitions=4, cross_samples=256,
         cross_partition_edge_share=float(cross.sum() / (nb >= 0).sum()),
         build_s=build_s, **eng.build_timings,
         peak_device_bytes=torch.cuda.max_memory_allocated(),
         peak_above_start_bytes=torch.cuda.max_memory_allocated() - base,
         index_bytes=index_bytes(eng.state),
         l2_gather_launches=build_launches)
    if build_launches == 0:
        raise AssertionError("the partitioned build launched no l2_gather")
    try:
        for i, q in enumerate(queries):
            truth = brute_force_topk(eng.state.graph, q[:recall_q], 10)[0]
            t = time.perf_counter()
            ids, dists = eng.search(q.cpu().numpy())
            dt = time.perf_counter() - t
            rec = float(recall_at_k(torch.as_tensor(ids[:recall_q],
                                                    device=dev), truth))
            emit("partitioned_request", i=i, queries=len(q), latency_s=dt,
                 recall_at_10=rec,
                 single_partition_recall_at_10=main["recall"][i])
            if not (np.isfinite(dists).all() and (ids >= 0).all()
                    and (ids < n).all()) or rec < min_recall:
                raise AssertionError(f"partitioned request {i}: recall@10 "
                                     f"{rec} (floor {min_recall}) or ids "
                                     "outside the index")
        row = l2_gather_build_shape(vecs, eng.state.graph.nbrs, gen)
    finally:
        eng.close()
    return build_launches, row, eng.state


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tail(f):
    f.flush()
    f.seek(0)
    return f.read()[-4000:]


def run_ranks(cmds, timeout, env=None, show=None):
    """Start one process a command (a rank each) and wait for all of them,
    polling ten times a second: at the first that exits non-zero,
    or after ``timeout`` seconds, kill every rank still running (its
    whole process group) and raise with that rank's output. The standard
    output of rank ``show`` passes through to this process's; every
    other stream goes to the rank's log. Returns the seconds taken."""
    t0 = time.perf_counter()
    procs = []
    with tempfile.TemporaryDirectory() as td:
        logs = [open(Path(td) / f"rank{r}.log", "w+") for r in
                range(len(cmds))]
        try:
            for r, cmd in enumerate(cmds):
                procs.append(subprocess.Popen(
                    cmd, env=env, stdout=None if r == show else logs[r],
                    stderr=logs[r], start_new_session=True))
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise AssertionError(f"rank {bad[0]} of {len(cmds)} "
                                         f"exited {codes[bad[0]]}:\n"
                                         f"{_tail(logs[bad[0]])}")
                if all(c == 0 for c in codes):
                    return time.perf_counter() - t0
                if time.perf_counter() - t0 > timeout:
                    late = [r for r, c in enumerate(codes) if c is None]
                    raise AssertionError(
                        f"ranks {late} still running after {timeout} s; "
                        f"rank {late[0]}:\n{_tail(logs[late[0]])}")
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
            for f in logs:
                f.close()


def index_arrays(state):
    """The sharded search's arrays (``distributed.INDEX_FIELDS``) of one
    whole index: its first n rows and its cache."""
    g, c = state.graph, state.cache
    n = int(g.n)
    return {"vectors": g.vectors[:n], "nbrs": g.nbrs[:n],
            "alive": g.alive[:n], "e_in": g.e_in[:n],
            "cache_vectors": c.vectors, "slot_hid": c.slot_hid,
            "h2d": c.h2d[:n], "f_recent": c.f_recent[:n]}


def dist_child(args):
    """The gloo group's rank (``--dist-child DIR --dist-rank R``): load
    its shard and the queries from DIR onto the card, join the group
    through a file rendezvous in DIR, run the sharded search with its
    own entry draw, and write the merged answer and its l2_gather
    launches to DIR."""
    import torch
    dist_rank(Path(args.dist_child), args.dist_rank, args.seed,
              torch.device("cuda", 0))
    sys.exit(0)


def dist_rank(root, rank, seed, dev):
    """The body of ``dist_child`` on ``dev``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as SD
    from repro_torch.core.types import SearchParams
    from repro_torch.kernels.l2_gather import kernel as K
    z = np.load(root / f"shard{rank}.npz")
    idx = {f: torch.as_tensor(z[f], device=dev) for f in SD.INDEX_FIELDS}
    q = torch.as_tensor(np.load(root / "queries.npy"), device=dev)
    dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                            world_size=2, rank=rank)
    try:
        mesh = SD.RankMesh((2,), ("data",))
        step = SD.make_distributed_search(
            mesh, SearchParams(k=10, pool=64, max_iters=64, beam=16),
            data_axes=("data",), query_axis=None)
        K.launches = 0
        t0 = time.perf_counter()
        ids, d = step(idx, q, seed=seed)
        torch.cuda.synchronize()
        np.savez(root / f"rank{rank}.npz", ids=ids.cpu().numpy(),
                 dists=d.cpu().numpy(), launches=K.launches,
                 seconds=time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()


def phase_distributed(gen, dev, seed, main=None, state=None, n=262_144,
                      d=96, b=1024, child_timeout=600):
    """The sharded search (``core/distributed.py``):
    1. an NCCL group of one rank over a whole 262,144-row index (the
       partitioned phase's, else a fresh build): equal to
       ``frontier_search`` with the same entries;
    2. a gloo group of two processes on this card, each rank owning one
       half of a 2 x 131,072 x 96 index (a graph built per half) with
       replicated queries: both ranks' answers equal one process's two
       shard searches merged by the same function; recall@10 against
       brute force over the union. NCCL takes one rank per GPU, so the
       two-rank group uses gloo (the results cross on CPU copies)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as SD
    from repro_torch.core.build import build_index
    from repro_torch.core.search import (brute_force_topk, frontier_search,
                                         recall_at_k)
    from repro_torch.core.types import GraphState, SearchParams
    from repro_torch.kernels.l2_gather import kernel as K
    sp = SearchParams(k=10, pool=64, max_iters=64, beam=16)
    draw = synthetic_descriptors(gen, n, d, dev)
    vecs = main["vecs"] if main is not None else draw(n)
    q = draw(b)
    if state is None:
        state = build_index(vecs, degree=32, cache_slots=131_072,
                            n_max=1 << 20, device=dev)
    # 1. NCCL, world 1
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = SD.RankMesh((1,), ("data",))
        step = SD.make_distributed_search(mesh, sp, data_axes=("data",),
                                          query_axis=None)
        entries = SD.shard_entries(seed, 0, b, sp.pool, n, dev)
        K.launches = 0                 # count the sharded step alone
        t0 = time.perf_counter()
        ids, dists = step(index_arrays(state), q, entries)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launched = K.launches
        want = frontier_search(state, q, entries, sp)
        _same(ids, want.ids, "NCCL world 1 and frontier_search: ids")
        _same(dists, want.dists, "NCCL world 1 and frontier_search: dists")
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    truth = brute_force_topk(state.graph, q, 10)[0]
    emit("distributed_nccl", backend=backend, world=1, n=n, queries=b,
         step_s=step_s, l2_gather_launches=launched,
         recall_at_10=float(recall_at_k(ids, truth)),
         identical_to="frontier_search on the same entries")
    if launched == 0:
        raise AssertionError("the NCCL step launched no l2_gather")
    # 2. gloo, world 2, one process a shard
    half = n // 2
    t0 = time.perf_counter()
    shards = [index_arrays(build_index(vecs[s * half:(s + 1) * half],
                                       degree=32, cache_slots=65_536,
                                       device=dev)) for s in range(2)]
    build_s = time.perf_counter() - t0
    merged = SD.merge_shard_results(*(torch.stack(x) for x in zip(*(
        SD.search_shard(shards[s], q, SD.shard_entries(
            seed, s, b, sp.pool, half, dev), sp, offset=s * half)
        for s in range(2)))), sp.k)
    with tempfile.TemporaryDirectory() as td:
        for s, idx in enumerate(shards):
            np.savez(f"{td}/shard{s}.npz",
                     **{f: x.cpu().numpy() for f, x in idx.items()})
        np.save(f"{td}/queries.npy", q.cpu().numpy())
        group_s = run_ranks(
            [[sys.executable, str(ROOT / "chip_smoke.py"), "--dist-child",
              td, "--dist-rank", str(r), "--seed", str(seed)]
             for r in range(2)], child_timeout)
        got = [np.load(f"{td}/rank{r}.npz") for r in range(2)]
    for r, z in enumerate(got):
        for f, want in zip(("ids", "dists"), merged):
            if not np.array_equal(z[f], want.cpu().numpy()):
                raise AssertionError(f"gloo rank {r}: {f} differ from the "
                                     "one-process merge")
        if int(z["launches"]) == 0:
            raise AssertionError(f"gloo rank {r} launched no l2_gather")
    union = GraphState(vecs, None, torch.ones(n, dtype=torch.bool,
                                              device=dev), None, None, None)
    truth = brute_force_topk(union, q, 10)[0]
    emit("distributed_gloo", backend="gloo", world=2, shard_rows=half,
         shards=2, queries=b, shard_build_s=build_s, group_s=group_s,
         step_s=[float(z["seconds"]) for z in got],
         l2_gather_launches=[int(z["launches"]) for z in got],
         recall_at_10=float(recall_at_k(merged[0], truth)),
         identical_to="one process: both shard searches, same merge")


def phase_baselines(gen, dev, n=65_536, d=96, steps=2, rows=2048,
                    q_rows=1024, min_recall=0.5):
    """``CagraStatic`` on the card (degree 32, rebuild every 2,048
    buffered inserts, benchmarks/bench_streaming.py's baseline): built on
    ``n`` rows, then ``steps`` steps of ``rows`` inserts (a full rebuild
    each) and ``rows`` deletes of the oldest live rows, each followed by
    a search. Recall@10 against brute force over the live rows; no
    deleted id may come back."""
    import torch
    from repro_torch.core.baselines import CagraStatic
    from repro_torch.core.search import brute_force_topk, recall_at_k
    from repro_torch.core.types import GraphState
    from repro_torch.kernels.l2_gather import kernel as K
    draw = synthetic_descriptors(gen, n, d, dev)
    idx = CagraStatic(d, degree=32, rebuild_every=rows, device=dev)
    t0 = time.perf_counter()
    idx.insert(draw(n).cpu().numpy())
    rebuild_s = [time.perf_counter() - t0]
    for i in range(steps):
        t0 = time.perf_counter()
        idx.insert(draw(rows).cpu().numpy())
        rebuild_s.append(time.perf_counter() - t0)
        live = np.setdiff1d(np.arange(len(idx.data)), list(idx.deleted))
        idx.delete(live[:rows])
        q = draw(q_rows)
        l0 = K.launches
        t0 = time.perf_counter()
        found = idx.search(q.cpu().numpy())
        search_s = time.perf_counter() - t0
        alive = torch.ones(len(idx.data), dtype=torch.bool, device=dev)
        alive[torch.as_tensor(sorted(idx.deleted), device=dev)] = False
        truth = brute_force_topk(GraphState(
            torch.as_tensor(idx.data, device=dev), None, alive, None, None,
            None), q, 10)[0]
        rec = float(recall_at_k(torch.as_tensor(found, device=dev), truth))
        leaked = int(np.isin(found, list(idx.deleted)).sum())
        emit("baselines", index="CagraStatic", step=i, rows=len(idx.data),
             inserted=rows, deleted=rows, rebuilds=idx.rebuilds,
             rebuild_s=rebuild_s, search_s=search_s,
             l2_gather_launches=K.launches - l0, recall_at_10=rec,
             deleted_ids_returned=leaked)
        if leaked or rec < min_recall or K.launches == l0:
            raise AssertionError(f"CagraStatic step {i}: recall {rec}, "
                                 f"deleted ids returned {leaked}")
    if idx.rebuilds != steps + 1:
        raise AssertionError(f"CagraStatic rebuilt {idx.rebuilds} times")


def phase_calibrate(dev, modeled):
    """``calibrate.measure(dim=96)`` on the card: the per-vector costs of
    the two tiers and of a pageable host-to-device copy, and theta;
    beside them the ``modeled_us_per_access`` of the engines that ran
    (``modeled``: engine -> value)."""
    from repro_torch.core.calibrate import measure
    cm = measure(dim=96, device=dev)
    emit("calibrate", dim=96, n=4096, t_fast=cm.t_fast, t_slow=cm.t_slow,
         t_transfer=cm.t_transfer, theta=cm.theta, batch=cm.batch,
         modeled_us_per_access=modeled)
    if not (cm.t_fast > 0 and cm.t_transfer > 0
            and cm.t_slow >= 1.01 * cm.t_fast):
        raise AssertionError(f"calibrate: {cm}")


# ---------------------------------------------------------------------------
# serve: the LM serving path and RAG over the live index
# ---------------------------------------------------------------------------

RAG_BATCH = 1024                 # prompts per retrieval request
RAG_DOCS, RAG_DOC_LEN = 131_072, 64
RAG_TOPICS, RAG_SLICE, RAG_ZIPF = 1024, 2048, 1.1
RAG_INGEST, RAG_EVICT = 8192, 8192  # documents per ingest call; evicted


def rag_index_config(dev, seed):
    """The RAG index: Deep1B's graph and search settings and the main
    phase's exact-vector cache, on a 2^18-row capacity."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.types import SearchParams
    return EngineConfig(degree=32, capacity=1 << 18, cache_slots=131_072,
                        search=SearchParams(k=10, pool=64, max_iters=64,
                                            beam=16),
                        seed=seed, device=str(dev))


def topic_corpus(rng, vocab, topics=RAG_TOPICS, width=RAG_SLICE,
                 s=RAG_ZIPF, stride=None):
    """Documents as a topic mixture: a document picks one of ``topics``
    topics and draws its tokens independently from that topic's slice of
    the vocabulary, the ``width`` consecutive token ids from topic x
    ``stride`` (default vocab // topics) on (mod vocab), with Zipf(``s``)
    weights in id order. Neighbouring topics share most of their slices but not their
    most frequent tokens. Returns draw(n, length) -> [n, length] int32
    tokens (numpy, from ``rng``)."""
    w = np.arange(1, width + 1, dtype=np.float64) ** -s
    w /= w.sum()
    stride = stride or vocab // topics

    def draw(n, length):
        topic = rng.integers(0, topics, n)
        rank = rng.choice(width, size=(n, length), p=w)
        return ((topic[:, None] * stride + rank) % vocab).astype(np.int32)
    return draw


def _max_err(a, b):
    return (a.float().cpu() - b.float().cpu()).abs().max().item()


def _close(a, b, tol, what):
    a, b = a.float().cpu(), b.float().cpu()
    if not bool(((a - b).abs() <= tol + tol * b.abs()).all()):
        raise AssertionError(f"{what}: max abs err {_max_err(a, b)} above "
                             f"rtol = atol = {tol}")


def doc_ids(rows, ids, dev, k=10):
    """Index ids [len(rows), k] of retrieved Docs (``doc_id`` indexes
    ``ids``), -1 where fewer than k came back."""
    import torch
    out = np.full((len(rows), k), -1, np.int64)
    for i, row in enumerate(rows):
        out[i, :len(row)] = ids[[d.doc_id for d in row]]
    return torch.as_tensor(out, device=dev)


def serve_requests(eng, prompts, max_new):
    """Submit ``prompts`` to a ServeEngine and drain it. Returns (ticks,
    seconds, {rid: tokens}, the ticks' own durations as the engine's
    straggler check read them); the card is synchronised at both ends."""
    import torch
    from repro_torch.serve.engine import Request
    tick_s, observe = [], eng._observe_tick
    eng._observe_tick = lambda dt: (tick_s.append(dt), observe(dt))[1]
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=max_new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = eng.run_until_drained()
    torch.cuda.synchronize()
    del eng._observe_tick       # no cycle keeps the engine's cache alive
    return (ticks, time.perf_counter() - t0,
            {r.rid: r.tokens for r in eng.completed}, tick_s)


def serve_stats(eng, n, max_new, ticks, seconds, out, tick_s):
    """Tick percentiles and generated tokens/s of a drained ServeEngine
    that served ``n`` requests of ``max_new`` new tokens."""
    t = np.array(tick_s) * 1e3
    done = sum(len(v) for v in out.values())
    if len(out) != n or any(len(v) != max_new for v in out.values()):
        raise AssertionError(f"{len(out)} of {n} requests finished")
    return dict(requests=len(out), ticks=ticks, seconds=seconds,
                tick_p50_ms=float(np.percentile(t, 50)),
                tick_p99_ms=float(np.percentile(t, 99)),
                generated_tokens=done, tokens_per_s=done / seconds,
                stragglers=eng.stragglers)


def lm_extra(cfg, rng, B, frames=16, patches=None):
    """What a family's forward takes besides tokens, from ``rng`` on the
    CPU: the vlm's patch embeddings [B, patches (default n_patches), D],
    the enc-dec's frame embeddings [B, frames, D]."""
    import torch
    shape = {"vlm": ("patches", patches or cfg.n_patches),
             "encdec": ("frames", frames)}.get(cfg.family)
    if shape is None:
        return {}
    return {shape[0]: torch.as_tensor(rng.normal(
        size=(B, shape[1], cfg.d_model)).astype(np.float32))}


def lm_forward(cfg, params, tok, extra):
    """forward_encdec for the enc-dec family, else forward_lm (logits of
    the patch positions first for the vlm)."""
    from repro_torch.models import model as M
    if cfg.family == "encdec":
        return M.forward_encdec(cfg, params, extra["frames"], tok)
    return M.forward_lm(cfg, params, tok, extra.get("patches"))


def phase_serve_parity(dev, seed, archs=("smollm_135m", "qwen3_0p6b"),
                       phase="serve_parity", n_req=7):
    """Card against CPU on the smoke configs of ``archs`` (by default
    smollm_135m and qwen3_0p6b: qk_norm, rope_theta 1e6), the same params
    on both: forward and decode_step logits within TOL[dtype], and a
    ServeEngine run (3 slots, 7 requests, no re-dispatch) with identical
    token ids at fp32 (reported at bf16)."""
    import torch
    from repro_torch.configs.base import load_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    from repro_torch.serve.engine import ServeEngine
    rng = np.random.default_rng(seed)
    for arch in archs:
        for dtype in ("float32", "bfloat16"):
            cfg = load_smoke_config(arch).replace(dtype=dtype)
            p_cpu = M.init_params(cfg, torch.Generator().manual_seed(seed))
            p_dev = tree_map(lambda a: a.to(dev), p_cpu)
            tok = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 17),
                                               dtype=np.int32))
            extra = lm_extra(cfg, rng, 3)
            tol = TOL[dtype]
            full = [lm_forward(cfg, p, tok, extra) for p in (p_cpu, p_dev)]
            _close(full[1], full[0], tol, f"{arch} {dtype} forward")
            dec = []
            for p in (p_cpu, p_dev):
                _, cache = M.prefill(cfg, p, {"tokens": tok[:, :16],
                                              **extra}, 32)
                cache["len"] = torch.tensor([16, 9, 3], dtype=torch.int32,
                                            device=cache["len"].device)
                dec.append(M.decode_step(cfg, p, cache, tok[:, 16:])[0])
            _close(dec[1], dec[0], tol, f"{arch} {dtype} decode_step")
            prompts = [rng.integers(0, cfg.vocab, size=n, dtype=np.int32)
                       for n in rng.integers(2, 12, n_req)]
            ids = [serve_requests(ServeEngine(
                cfg, p_cpu, slots=3, max_len=24, device=d,
                straggler_factor=float("inf")), prompts, 6)[2]
                for d in ("cpu", dev)]
            same = sum(ids[0][r] == ids[1][r] for r in ids[0])
            emit(phase, arch=arch, family=cfg.family, dtype=dtype, tol=tol,
                 forward_max_abs_err=_max_err(full[1], full[0]),
                 decode_max_abs_err=_max_err(dec[1], dec[0]),
                 requests=n_req, identical_token_ids=same)
            if dtype == "float32" and same != n_req:
                raise AssertionError(f"{arch}: token ids differ between "
                                     "the CPU and the card")


def serve_prefill_decode(cfg, params, rng, dev, B=8, S=128, max_len=256,
                         extra=None, phase="serve_prefill_decode", note=None):
    """The reference's prefill/decode check (tests/test_models.py) at the
    config's width: prefill over B x S tokens (after the vlm's patches,
    or over the enc-dec's frames) and one decode step, both against the
    forward over the S + 1 tokens. Held in fp32 within TOL["float32"];
    in the config's bf16 the errors are reported beside the reference's
    bound (rtol 2e-2, atol 1e-2), which the reference itself misses at
    SmolLM-135M's width (scripts/reference_cpu_checks.py)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_leaves, tree_map
    extra = tree_map(lambda a: a.to(dev), extra or {})
    off = extra["patches"].shape[1] if "patches" in extra else 0
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + 1),
                                       dtype=np.int32), device=dev)
    for dtype in ("float32", cfg.dtype):
        c = cfg.replace(dtype=dtype)
        full = lm_forward(c, params, tok, extra)
        lg_pre, cache = M.prefill(c, params, {"tokens": tok[:, :S],
                                              **extra}, max_len)
        lg_dec, cache = M.decode_step(c, params, cache, tok[:, S:])
        out = {}
        for a, b, what in ((full[:, off + S - 1], lg_pre[:, 0], "prefill"),
                           (full[:, off + S], lg_dec[:, 0], "decode")):
            a, b = a.float(), b.float()
            err = (a - b).abs()
            out[f"{what}_max_abs_err"] = err.max().item()
            out[f"{what}_over_reference_bound"] = int(
                (err > 1e-2 + 2e-2 * b.abs()).sum())
            if dtype == "float32":
                _close(b, a, TOL["float32"], f"{cfg.name} {what}")
        if int(cache["len"]) != off + S + 1:
            raise AssertionError(f"{cfg.name}: cache len {cache['len']}")
        emit(phase, arch=cfg.name, family=cfg.family, dtype=dtype,
             **(note or {}),
             params=sum(t.numel() for t in tree_leaves(params)),
             tokens=[B, S + 1], max_len=max_len,
             **{k: list(v.shape) for k, v in extra.items()},
             logits=int(full[:, off + S - 1].numel()),
             held_within=TOL["float32"] if dtype == "float32" else None,
             **out)
        del full, lg_pre, lg_dec, cache


def rag_ingest(cfg, params, draw, dev, seed):
    """A RAGPipeline on the card over ``rag_index_config``, fed RAG_DOCS
    documents of RAG_DOC_LEN tokens in ingests of RAG_INGEST. Returns
    (rag, docs [RAG_DOCS, RAG_DOC_LEN], their index ids)."""
    import torch
    from repro_torch.serve.rag import Doc, RAGPipeline
    t0 = time.perf_counter()
    rag = RAGPipeline(cfg, params, rag_index_config(dev, seed))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    docs = draw(RAG_DOCS, RAG_DOC_LEN)
    ids = []
    t0 = time.perf_counter()
    for s in range(0, RAG_DOCS, RAG_INGEST):
        ids.append(rag.ingest([Doc(i, docs[i]) for i in
                               range(s, min(s + RAG_INGEST, RAG_DOCS))]))
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    g, c = rag.index.state.graph, rag.index.state.cache
    emit("serve_rag_ingest", docs=RAG_DOCS, doc_tokens=RAG_DOC_LEN,
         dim=rag.dim, topics=RAG_TOPICS, build_s=build_s, ingest_s=ingest_s,
         docs_per_s=RAG_DOCS / ingest_s,
         ingest_calls=len(range(0, RAG_DOCS, RAG_INGEST)),
         vector_bytes=g.vectors.numel() * g.vectors.element_size(),
         graph_bytes=g.nbrs.numel() * g.nbrs.element_size(),
         cache_bytes=c.vectors.numel() * c.vectors.element_size())
    return rag, docs, np.concatenate(ids)


def serve_lm(cfg, params, rag, draw, rng, dev, seed):
    """ServeEngine at the reference's defaults (8 slots, 256 positions):
    32 prompts of 8-24 tokens, each augmented by retrieval (k=2, budget
    128), 32 new tokens each; then qwen3-0.6B at its published width
    (qk_norm, vocab 151,936), 8 prompts of 8-24 tokens."""
    import torch
    from repro_torch.configs.base import load_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    prompts = [rag.augment(draw(1, int(n))[0], k=2, budget=128)
               for n in rng.integers(8, 25, 32)]
    eng = ServeEngine(cfg, params, slots=8, max_len=256, device=dev)
    st = serve_stats(eng, 32, 32, *serve_requests(eng, prompts, 32))
    emit("serve_lm", arch=cfg.name, slots=8, max_len=256,
         prompt_tokens=[min(len(p) for p in prompts),
                        max(len(p) for p in prompts)], **st)
    del eng
    qcfg = load_config("qwen3_0p6b")
    qparams = M.init_params(qcfg, torch.Generator(device=dev)
                            .manual_seed(seed))
    eng = ServeEngine(qcfg, qparams, slots=8, max_len=256, device=dev)
    st = serve_stats(eng, 8, 32, *serve_requests(
        eng, [rng.integers(0, qcfg.vocab, int(n), dtype=np.int32)
              for n in rng.integers(8, 25, 8)], 32))
    emit("serve_lm", arch=qcfg.name, slots=8, max_len=256, **st)


def rag_retrieval(rag, draw, docs, ids, rng, dev):
    """Eight retrieve_batch requests of RAG_BATCH prompts (fresh
    documents' first 32 tokens; l2_gather launches read around them
    alone) and one retrieve_many of 8 batches of 128, recall@10 against
    brute force over the alive rows; self-retrieval of RAG_BATCH
    ingested documents and the share of documents no row links to; a
    profile of three batches; then the oldest RAG_EVICT documents
    evicted and queried again: none may come back. Returns the
    launches."""
    import torch
    from repro_torch.core.search import brute_force_topk, recall_at_k
    from repro_torch.kernels.l2_gather import kernel as K
    g = rag.index.state.graph
    batches = [draw(RAG_BATCH, RAG_DOC_LEN)[:, :32] for _ in range(8)]
    vecs = [rag.embed(b) for b in batches]
    truth = [brute_force_topk(g, torch.as_tensor(v, device=dev), 10)[0]
             for v in vecs]
    torch.cuda.synchronize()
    K.launches = 0
    ms, found = [], []
    for b in batches:
        t0 = time.perf_counter()
        found.append(rag.retrieve_batch(b, k=10))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = K.launches
    recalls = [float(recall_at_k(doc_ids(rows, ids, dev), t))
               for rows, t in zip(found, truth)]
    split = [batches[0][s:s + 128] for s in range(0, RAG_BATCH, 128)]
    t0 = time.perf_counter()
    many = rag.retrieve_many(split, k=10)
    many_ms = (time.perf_counter() - t0) * 1e3
    emit("serve_rag_retrieval", batches=len(batches), prompts=RAG_BATCH,
         ms=ms, recall_at_10=recalls, l2_gather_launches=launches,
         l2_gather_per_batch=launches / len(batches),
         retrieve_many=dict(batches=len(split), ms=many_ms,
                            recall_at_10=float(recall_at_k(doc_ids(
                                sum(many, []), ids, dev), truth[0]))))
    pick = rng.choice(RAG_DOCS, RAG_BATCH, replace=False)
    own, _ = rag.index.search(rag.embed(docs[pick]))
    e_in = rag.index.state.graph.e_in[torch.as_tensor(ids, device=dev)
                                      .long()]
    phase_profile(rag.index, [torch.as_tensor(v) for v in vecs[:3]],
                  phase="serve_rag_profile")
    gone = ids[:RAG_EVICT]
    rag.evict(gone)
    back, _ = rag.index.search(rag.embed(docs[pick % RAG_EVICT]))
    leaked = int(np.isin(back, gone).sum())
    emit("serve_rag_quality", self_retrieval=float(
        (own[:, 0] == ids[pick]).mean()), docs_without_in_edges=float(
        (e_in == 0).float().mean()), max_in_degree=int(e_in.max()),
         evicted=len(gone), evicted_returned=leaked,
         peak_device_bytes=torch.cuda.max_memory_allocated())
    if leaked or not launches:
        raise AssertionError(f"RAG: {leaked} evicted ids returned, "
                             f"{launches} l2_gather launches")
    return launches


def phase_index_floors(gen, dev, seed, d=576, floors=(0.9, 0.5)):
    """The RAG index's configuration at D = 576 filled with the main
    phase's synthetic descriptors: RAG_DOCS rows inserted in RAG_INGEST
    calls beside the pipeline's 256 seed rows, eight searches of
    RAG_BATCH fresh queries (recall@10 against brute force),
    read-after-write of RAG_BATCH inserted rows, and the oldest
    RAG_EVICT deleted and queried again. The floors (read-after-write
    0.9, recall@10 0.5, no deleted id returned) catch a broken index
    path here; the topic corpus misses the first two in the reference's
    algorithm too (scripts/reference_cpu_checks.py, PERF.md §6)."""
    import torch
    from repro_torch.core.engine import SVFusionEngine
    from repro_torch.core.search import brute_force_topk, recall_at_k
    draw = synthetic_descriptors(gen, RAG_DOCS, d, dev)
    eng = SVFusionEngine(np.random.default_rng(0).normal(
        size=(256, d)).astype(np.float32), rag_index_config(dev, seed))
    try:
        vecs = draw(RAG_DOCS).cpu().numpy()
        t0 = time.perf_counter()
        ids = np.concatenate([eng.insert(vecs[s:s + RAG_INGEST])
                              for s in range(0, RAG_DOCS, RAG_INGEST)])
        insert_s = time.perf_counter() - t0
        recalls = []
        for _ in range(8):
            q = draw(RAG_BATCH)
            found, _ = eng.search(q.cpu().numpy())
            truth = brute_force_topk(eng.state.graph, q, 10)[0]
            recalls.append(float(recall_at_k(
                torch.as_tensor(found, device=dev), truth)))
        pick = np.random.default_rng(seed).choice(RAG_DOCS, RAG_BATCH,
                                                  replace=False)
        own, _ = eng.search(vecs[pick])
        raw = float((own[:, 0] == ids[pick]).mean())
        eng.delete(ids[:RAG_EVICT])
        back, _ = eng.search(vecs[pick % RAG_EVICT])
        leaked = int(np.isin(back, ids[:RAG_EVICT]).sum())
    finally:
        eng.close()
    emit("serve_index_floors", rows=RAG_DOCS, dim=d, insert_s=insert_s,
         recall_at_10=recalls, read_after_write=raw, deleted=RAG_EVICT,
         deleted_returned=leaked, floors=dict(read_after_write=floors[0],
                                              recall_at_10=floors[1]))
    if raw < floors[0] or min(recalls) < floors[1] or leaked:
        raise AssertionError(f"RAG index at D={d}: read-after-write {raw}, "
                             f"recall@10 {min(recalls)}, {leaked} deleted "
                             "ids returned")


def phase_serve(dev, seed):
    """The LM serving path at SmolLM-135M's published width and RAG over a
    live device-mode index of RAG_DOCS documents (its ingest comes
    before the serving requests, whose prompts it augments). Its data
    come from ``seed`` alone, so that it draws the same whether it runs
    alone or after the other phases. Returns the l2_gather launches of
    the retrieval requests."""
    import torch
    from repro_torch.configs.base import load_config
    from repro_torch.models import model as M
    phase_serve_parity(dev, seed)
    rng = np.random.default_rng(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = load_config("smollm_135m")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    serve_prefill_decode(cfg, params, rng, dev)
    draw = topic_corpus(rng, cfg.vocab)
    rag, docs, ids = rag_ingest(cfg, params, draw, dev, seed)
    try:
        serve_lm(cfg, params, rag, draw, rng, dev, seed)
        launches = rag_retrieval(rag, draw, docs, ids, rng, dev)
    finally:
        rag.index.close()
    phase_index_floors(torch.Generator(device=dev).manual_seed(seed), dev,
                       seed)
    return launches


# ---------------------------------------------------------------------------
# families: the MoE, SSM, hybrid, VLM and enc-dec serving paths
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("granite_moe_1b", "grok1_314b", "falcon_mamba_7b",
                "hymba_1p5b", "internvl2_2b", "whisper_medium")
# the reference's prefill/decode check at each published width (grok-1's
# 314B params do not fit one card: it runs at its smoke width only)
FAMILY_CHECKS = (
    ("granite_moe_1b", dict()),
    ("falcon_mamba_7b", dict()),
    # past the 1,024-token window: decode runs on a full ring
    ("hymba_1p5b", dict(B=2, S=1280, max_len=1536)),
    ("internvl2_2b", dict(patches=256, max_len=512)),
    ("whisper_medium", dict(frames=1500, max_len=1536)))
FAMILY_SERVED = ("granite_moe_1b", "falcon_mamba_7b", "hymba_1p5b")
# ROADMAP C.1: their bf16 prefill/decode and serving with cuBLAS's
# reduced-precision bf16 reduction allowed (True, torch's default) and not
FLAG_AB = ("falcon_mamba_7b", "hymba_1p5b")


def bf16_reduction(allowed):
    import torch
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        allowed


def families_moe_capacity(cfg, params, rng, dev):
    """The capacity dispatch (the config's own impl and factor) against
    the dense oracle at full width in fp32, on 8 x 129 tokens: reported,
    since dropped pairs change the output by design."""
    import torch
    from repro_torch.models import model as M
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (8, 129),
                                       dtype=np.int32), device=dev)
    c = cfg.replace(dtype="float32")
    cap = M.forward_lm(c, params, tok)
    dense = M.forward_lm(c.replace(moe_impl="dense"), params, tok)
    err = (cap - dense).abs()
    emit("families_moe_capacity", arch=cfg.name,
         capacity_factor=cfg.capacity_factor, moe_group=cfg.moe_group,
         max_abs_err=err.max().item(),
         over_reference_bound=int((err > 1e-2 + 2e-2 * dense.abs()).sum()),
         logits=int(dense.numel()))


def families_decode(cfg, params, rng, dev, extra, max_len, S=16, steps=32):
    """prefill of 8 prompts of S tokens (after the patches, or over the
    frames) in the config's bf16, then ``steps`` greedy decode_steps, each
    timed on the host clock with its tokens brought to the host (what a
    ServeEngine tick waits for)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    p = M.cast_params(cfg, params)
    extra = tree_map(lambda a: a.to(dev), extra)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (8, S),
                                       dtype=np.int32), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = M.prefill(cfg, p, {"tokens": tok, **extra}, max_len)
    nxt = lg.argmax(-1).int().cpu()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        lg, cache = M.decode_step(cfg, p, cache, nxt)
        nxt = lg.argmax(-1).int().cpu()
        ms.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{cfg.name}: decode logits not finite")
    emit("families_decode", arch=cfg.name, dtype=cfg.dtype, batch=8,
         prompt_tokens=S, max_len=max_len,
         **{k: list(v.shape) for k, v in extra.items()},
         prefill_ms=prefill_ms, steps=steps,
         step_p50_ms=float(np.percentile(ms, 50)),
         step_p99_ms=float(np.percentile(ms, 99)),
         tokens_per_s=8 * steps / (sum(ms) / 1e3))


def family_full_width(arch, kw, rng, dev, seed):
    """One published config, params from the seed (no checkpoint ships):
    the prefill/decode check, then serving in bf16 (a ServeEngine at the
    reference's defaults, 8 requests of 8-24 tokens and 32 new tokens
    each; the vlm and the enc-dec through prefill and decode_step). Its
    params count, and its peak device bytes above what the earlier
    phases left allocated (reported beside it)."""
    import torch
    from repro_torch.configs.base import load_config
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serve.engine import ServeEngine
    kw = dict(kw)
    frames, patches = kw.pop("frames", 16), kw.pop("patches", None)
    cfg = load_config(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    extra = lm_extra(cfg, rng, kw.get("B", 8), frames, patches)
    if cfg.family == "moe":
        families_moe_capacity(cfg, params, rng, dev)
    # FLAG_AB: each setting on the same inputs (rng rewound); the served
    # requests in turns (on, off, off, on), so that warm-up favours none
    ab = arch in FLAG_AB
    drawn = rng.bit_generator.state
    for flag in (True, False) if ab else (False,):
        rng.bit_generator.state = drawn
        bf16_reduction(flag)
        serve_prefill_decode(cfg.replace(moe_impl="dense"), params, rng, dev,
                             extra=extra, phase="families_prefill_decode",
                             note={"bf16_reduced_precision_reduction": flag},
                             **kw)
    if arch in FAMILY_SERVED:
        drawn = rng.bit_generator.state
        for flag in (True, False, False, True) if ab else (False,):
            rng.bit_generator.state = drawn
            eng = ServeEngine(cfg, params, slots=8, max_len=256, device=dev)
            bf16_reduction(flag)        # the engine turned it off
            st = serve_stats(eng, 8, 32, *serve_requests(
                eng, [rng.integers(0, cfg.vocab, int(n), dtype=np.int32)
                      for n in rng.integers(8, 25, 8)], 32))
            emit("families_serve", arch=arch, family=cfg.family,
                 dtype=cfg.dtype, slots=8, max_len=256,
                 bf16_reduced_precision_reduction=flag,
                 **({"moe_impl": cfg.moe_impl} if cfg.family == "moe"
                    else {}), **st)
            del eng
        bf16_reduction(False)
    else:
        families_decode(cfg, params, rng, dev,
                        lm_extra(cfg, rng, 8, frames, patches),
                        max_len=kw.get("max_len", 512))
    emit("families_model", arch=arch, family=cfg.family,
         params=sum(t.numel() for t in tree_leaves(params)),
         peak_device_bytes=torch.cuda.max_memory_allocated() - before,
         allocated_before_bytes=before, seconds=time.perf_counter() - t0)
    del params
    torch.cuda.empty_cache()


def phase_families(dev, seed):
    """The MoE, SSM, hybrid, VLM and enc-dec serving paths: card against
    CPU on the six smoke configs, then each published config that fits
    one card at full width (FAMILY_CHECKS), freed before the next. Data
    from ``seed`` alone."""
    phase_serve_parity(dev, seed, FAMILY_ARCHS, phase="families_parity")
    rng = np.random.default_rng(seed)
    for arch, kw in FAMILY_CHECKS:
        family_full_width(arch, kw, rng, dev, seed)


# ---------------------------------------------------------------------------
# train: the training path (loss, backward, remat, AdamW, data,
# checkpoints, gradient compression, the train loop)
# ---------------------------------------------------------------------------

BF16_FLOPS = 989e12           # H100 SXM dense bf16 (tensor cores, 700 W)
PORTED = ("l2_gather", "pq_adc", "row_gather", "topk_merge", "e_in_count")


def ported_launches():
    import importlib
    return {k: importlib.import_module(f"repro_torch.kernels.{k}.kernel")
            .launches for k in PORTED}


def train_batch(cfg, rng, dev, B=2, S=24):
    """Tokens, next-token labels and a mask with ~20% of positions out
    (the vlm's patches, the enc-dec's 16 frames), from ``rng``, on
    ``dev``."""
    import torch
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b = {"tokens": tok, "labels": np.roll(tok, -1, 1),
         "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    b.update({k: v.numpy() for k, v in lm_extra(cfg, rng, B).items()})
    return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}


def loss_and_grads(cfg, params, batch, dev):
    """The loss and the gradient leaves (sorted-key order) of ``loss_fn``
    on a copy of ``params`` on ``dev``."""
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train import train_loop
    loss, grads = train_loop.loss_and_grads(
        cfg, tree_map(lambda a: a.to(dev, copy=True), params),
        {k: v.to(dev) for k, v in batch.items()})
    return loss, tree_leaves(grads)


def grad_ratio(got, want):
    """max over leaves of max|g - g_ref| / (1e-4 max|g_ref| + 1e-7): at
    most 1 within the gradient tolerance."""
    return max(((g.cpu() - w.cpu()).abs().max()
                / (1e-4 * w.abs().max().cpu() + 1e-7)).item()
               for g, w in zip(got, want))


def train_parity(dev, seed):
    """Card against CPU on every smoke config in fp32 (granite-moe at both
    dispatches, the hybrid over 40 positions, past its window of 16): the
    loss within 1e-5 and every gradient leaf within 1e-4 max|g| + 1e-7."""
    import torch
    from repro_torch.configs.base import ARCH_IDS, load_smoke_config
    from repro_torch.models import model as M
    rng = np.random.default_rng(seed)
    cases = [(a, None) for a in ARCH_IDS] + [("granite_moe_1b", "dense")]
    for arch, impl in cases:
        cfg = load_smoke_config(arch).replace(dtype="float32")
        cfg = cfg.replace(moe_impl=impl) if impl else cfg
        batch = train_batch(cfg, rng, "cpu",
                            S=40 if cfg.family == "hybrid" else 24)
        params = M.init_params(cfg, torch.Generator().manual_seed(seed))
        (l_cpu, g_cpu), (l_dev, g_dev) = (
            loss_and_grads(cfg, params, batch, d) for d in ("cpu", dev))
        loss_err = abs(l_dev.item() - l_cpu.item())
        worst = grad_ratio(g_dev, g_cpu)
        emit("train_parity", arch=arch, family=cfg.family, dtype="float32",
             **({"moe_impl": cfg.moe_impl} if cfg.family == "moe" else {}),
             tokens=list(batch["tokens"].shape), loss_cpu=l_cpu.item(),
             loss_abs_err=loss_err, grad_leaves=len(g_cpu),
             worst_grad_ratio=worst, tol=dict(loss=1e-5, grad_rel=1e-4,
                                              grad_abs=1e-7))
        if loss_err > 1e-5 or worst > 1.0:
            raise AssertionError(f"{arch}: the card's loss or gradients "
                                 "miss the CPU's")


def train_remat(dev, seed, B=2, S=2048):
    """The remat policies: equal gradients on the smollm and hymba smoke
    configs on the card (fp32, held within the gradient tolerance of
    "none"; bit-equality reported), then one AdamW step of each at
    SmolLM-135M's width in bf16 on B x S tokens: peak device bytes above
    what was allocated before, and ms of a second step."""
    import torch
    from repro_torch.configs.base import load_config, load_smoke_config
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as Opt
    from repro_torch.train.train_loop import make_step
    rng = np.random.default_rng(seed)
    for arch in ("smollm_135m", "hymba_1p5b"):
        base = load_smoke_config(arch).replace(dtype="float32")
        batch = train_batch(base, rng, "cpu", S=40)
        params = M.init_params(base, torch.Generator().manual_seed(seed))
        out = {pol: loss_and_grads(base.replace(remat_policy=pol), params,
                                   batch, dev)
               for pol in ("none", "full", "dots")}
        for pol in ("full", "dots"):
            worst = grad_ratio(out[pol][1], out["none"][1])
            emit("train_remat_parity", arch=arch, policy=pol,
                 against="none", worst_grad_ratio=worst,
                 loss_bit_equal=bool(torch.equal(out[pol][0],
                                                 out["none"][0])),
                 grads_bit_equal=all(torch.equal(a, b) for a, b in
                                     zip(out[pol][1], out["none"][1])))
            if worst > 1.0:
                raise AssertionError(f"{arch}: remat {pol} changes the "
                                     "gradients")
    cfg = load_config("smollm_135m")
    adam = Opt.AdamConfig(lr=1e-3, warmup=10, total_steps=40)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + 1),
                                       dtype=np.int32), device=dev)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "mask": torch.ones(B, S, device=dev)}
    for pol in ("none", "full", "dots"):
        c = cfg.replace(remat_policy=pol)
        params = M.init_params(c, torch.Generator(device=dev)
                               .manual_seed(seed))
        state = Opt.init_adam(params, adam)
        step = make_step(c, adam)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        loss = loss.item()
        ms = (time.perf_counter() - t0) * 1e3
        emit("train_remat_peak", arch=cfg.name, policy=pol, dtype=cfg.dtype,
             tokens=[B, S], peak_device_bytes=torch.cuda.max_memory_allocated()
             - before, allocated_before_bytes=before, step_ms=ms, loss=loss)
        del params, state, step
        torch.cuda.empty_cache()


def train_flops(cfg, B, S):
    """Model FLOPs of one training step (3 x the forward's): every product
    with a weight (2 x params x tokens, the tied head included) and the
    attention's two [S x S] products as computed (the whole square)."""
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = 2 * D * H * Dh + 2 * D * Hkv * Dh + 3 * D * cfg.d_ff
    weights = cfg.n_layers * per_layer + D * cfg.padded_vocab
    attn = 4 * cfg.n_layers * S * H * Dh
    return 3 * B * S * (2 * weights + attn)


def train_smollm(dev, seed, ckpt_dir, steps=40, B=8, S=2048):
    """SmolLM-135M at its published width in bf16 (fp32 params and
    moments, remat "full") through ``train_loop.run`` over TokenPipeline,
    ``save_async`` every 20 steps: the loss falls (the mean of the last 5
    below the mean of the first 5), tokens/s and step ms (host clock, a
    step ends with its loss on the host; the first step, which warms the
    allocator and cuBLAS, apart), peak device bytes, and the share of the
    model FLOPs against the card's dense bf16 peak."""
    import torch
    from repro_torch.configs.base import load_config
    from repro_torch.train import train_loop
    cfg = load_config("smollm_135m")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = train_loop.run(cfg, steps=steps, batch=B, seq=S,
                         ckpt_dir=ckpt_dir, ckpt_every=20, seed=seed,
                         device=dev)
    seconds = time.perf_counter() - t0
    losses = res.losses
    ms = np.array(res.step_seconds[1:]) * 1e3
    p50 = float(np.percentile(ms, 50))
    flops = train_flops(cfg, B, S)
    emit("train_smollm", arch=cfg.name, dtype=cfg.dtype,
         param_dtype=cfg.param_dtype, remat=cfg.remat_policy, batch=B,
         seq=S, steps=len(losses), losses=losses,
         first5_mean=float(np.mean(losses[:5])),
         last5_mean=float(np.mean(losses[-5:])),
         first_step_ms=res.step_seconds[0] * 1e3, step_p50_ms=p50,
         step_p99_ms=float(np.percentile(ms, 99)),
         tokens_per_s=B * S / (p50 / 1e3), model_flops_per_step=flops,
         bf16_peak_share=flops / (p50 / 1e3) / BF16_FLOPS,
         peak_device_bytes=torch.cuda.max_memory_allocated() - before,
         allocated_before_bytes=before, seconds=seconds,
         checkpoints=sorted(int(p.name.split("_")[1])
                            for p in Path(ckpt_dir).glob("step_*")),
         card=card_line())
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"train_smollm: losses {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError("train_smollm: the loss did not fall")


def train_checkpoint(dev, seed, ckpt_dir, B=1, S=256):
    """The card's last checkpoint restored on the CPU and on the card;
    two more steps from it on each, in fp32 on B x S tokens: equal losses
    within TOL["float32"]."""
    import torch
    from repro_torch.configs.base import load_config
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train import optimizer as Opt
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import TokenPipeline
    from repro_torch.train.train_loop import make_step
    cfg = load_config("smollm_135m").replace(dtype="float32")
    shapes = tree_map(lambda t: torch.empty(t.shape),
                      M.build_templates(cfg))
    like = (shapes, Opt.AdamState(torch.zeros((), dtype=torch.int32),
                                  shapes, shapes))
    mgr = CheckpointManager(ckpt_dir)
    t0 = time.perf_counter()
    step_cpu, state_cpu = mgr.restore(like)
    restore_s = time.perf_counter() - t0
    step_dev, state_dev = mgr.restore(like, device=dev)
    if step_cpu is None or step_cpu != step_dev:
        raise AssertionError(f"restored steps {step_cpu}, {step_dev}")
    pipe = TokenPipeline(cfg.vocab, B, S, seed=seed + 1)
    batch = next(pipe)
    pipe.close()
    adam = Opt.AdamConfig(lr=1e-3, warmup=10, total_steps=40)
    losses = {}
    for name, d, (params, state) in (("cpu", "cpu", state_cpu),
                                     ("card", dev, state_dev)):
        step = make_step(cfg, adam)
        b = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
        out = []
        for _ in range(2):
            params, state, loss = step(params, state, b)
            out.append(loss.item())
        losses[name] = out
    err = max(abs(a - b) for a, b in zip(losses["card"], losses["cpu"]))
    emit("train_checkpoint", restored_step=step_cpu,
         steps_on_disk=mgr.all_steps(),
         leaves=len(tree_leaves(state_cpu[0])) * 3 + 1,
         cpu_restore_s=restore_s, tokens=[B, S], dtype="float32",
         losses_cpu=losses["cpu"], losses_card=losses["card"],
         max_abs_err=err, tol=TOL["float32"])
    if err > TOL["float32"]:
        raise AssertionError("the restored checkpoint steps differently on "
                             "the CPU and the card")


def train_ssm_layer(dev, seed, B=1, S=2048, reps=3):
    """One mamba_mixer layer at falcon-mamba-7b's width (d_inner 8,192,
    d_state 16, chunks of 256) in bf16 on B x S: forward and backward ms
    (host clock, synchronised; the median of ``reps``), the scan alone on
    one chunk forward and backward, and the peak device bytes of a
    forward and backward."""
    import torch
    from repro_torch.configs.base import load_config
    from repro_torch.models import mamba as Ma
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_from_template
    cfg = load_config("falcon_mamba_7b")
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {k: v.requires_grad_() for k, v in init_from_template(
        gen, Ma.ssm_template(cfg)).items()}
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    gy = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).to(
        torch.bfloat16)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    fwd, bwd, peak = [], [], 0
    for _ in range(reps + 1):              # the first warms up
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        y, f_ms = timed(lambda: Ma.mamba_mixer(M.cast_params(cfg, p), x,
                                               cfg)[0])
        _, b_ms = timed(lambda: y.backward(gy))
        peak = torch.cuda.max_memory_allocated() - before
        fwd.append(f_ms)
        bwd.append(b_ms)
        del y
    C, Din, N = cfg.ssm_chunk, cfg.d_inner, cfg.d_state
    a = torch.rand(B, C, Din, N, generator=gen, device=dev).mul_(0.5).add_(
        0.5).requires_grad_()
    bx = torch.randn(B, C, Din, N, generator=gen, device=dev
                     ).requires_grad_()
    h0 = torch.zeros(B, Din, N, device=dev, requires_grad=True)
    g = torch.ones(B, C, Din, N, device=dev)
    scan_f, scan_b = [], []
    for _ in range(reps + 1):
        hs, f_ms = timed(lambda: Ma._chunk_scan(a, bx, h0)[0])
        _, b_ms = timed(lambda: hs.backward(g))
        scan_f.append(f_ms)
        scan_b.append(b_ms)
    emit("train_ssm_layer", arch=cfg.name, dtype="bfloat16", tokens=[B, S],
         d_inner=Din, d_state=N, chunk=C, chunks=S // C,
         mixer_forward_ms=float(np.median(fwd[1:])),
         mixer_backward_ms=float(np.median(bwd[1:])),
         scan_chunk_forward_ms=float(np.median(scan_f[1:])),
         scan_chunk_backward_ms=float(np.median(scan_b[1:])),
         peak_device_bytes=peak, method="host clock around synchronised "
         f"calls, median of {reps} after one warm-up")


def train_psum(dev, seed):
    """``ef_int8_psum`` and ``make_crosspod_grad_sync`` in an NCCL group of
    one rank: equal to ``ef_compress`` (the mean over one rank)."""
    import torch
    import torch.distributed as dist
    from repro_torch.train.compression import (ef_compress, ef_int8_psum,
                                               make_crosspod_grad_sync)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(1024, 4096, generator=gen, device=dev)
    e = torch.randn(1024, 4096, generator=gen, device=dev) * 1e-3
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        got, got_err = ef_int8_psum(g, e)
        tree, tree_err = make_crosspod_grad_sync()({"w": g}, {"w": e})
        torch.cuda.synchronize()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    want, want_err = ef_compress(g, e)
    same = all(torch.equal(a, b) for a, b in (
        (got, want), (got_err, want_err), (tree["w"], want),
        (tree_err["w"], want_err)))
    emit("train_psum", backend=backend, world=1, shape=list(g.shape),
         equal_to_ef_compress=same)
    if not same:
        raise AssertionError("ef_int8_psum over one rank differs from "
                             "ef_compress")


def phase_train(dev, seed):
    """The training path: card against CPU on the smoke configs, the remat
    policies, SmolLM-135M trained at its width, its checkpoint restored on
    the CPU, the SSM layer at falcon-mamba's width and the compressed
    all-reduce. It launches none of the ported kernels (checked)."""
    t0 = time.perf_counter()
    launched = ported_launches()
    train_parity(dev, seed)
    train_remat(dev, seed)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        train_smollm(dev, seed, ckpt_dir)
        train_checkpoint(dev, seed, ckpt_dir)
    train_ssm_layer(dev, seed)
    train_psum(dev, seed)
    if ported_launches() != launched:
        raise AssertionError("the train phase launched a ported kernel")
    emit("train", seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# launch: the dry run's step bundles run on the card beside their roofline
# ---------------------------------------------------------------------------

# (arch, shape, the cut applied to a copy of its SHAPES / SVF_SHAPES entry,
# why): each bundle is built through launch.steps from that copy
LAUNCH_CELLS = (
    ("smollm_135m", "train_4k", {"global_batch": 8},
     "global batch 256 -> 8 (256 x 4,096 tokens do not fit one card)"),
    ("qwen3_0p6b", "decode_32k", {"global_batch": 8},
     "batch 128 -> 8 (the batch-128 KV cache is 481 GB)"),
    ("falcon_mamba_7b", "decode_32k", {}, None),
    ("granite_moe_1b", "prefill_32k", {"global_batch": 1},
     "batch 32 -> 1 (one card)"),
    ("svfusion_msturing", "search_1k", {"n": 781_250},
     "N 200M -> 781,250 rows: one pod256 shard; synthetic vectors and "
     "neighbour lists from the seed"))


def event_ms(fn, steps):
    """Milliseconds of each of ``steps`` calls of ``fn`` (CUDA events
    around each; the next call starts after the last has finished)."""
    import torch
    times = []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def _equal_trees(a, b, what):
    """Raise unless the trees ``a`` and ``b`` hold equal tensors (compared
    on their device: a decode cache is tens of GB)."""
    import torch
    from repro_torch.utils import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb) or not all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb)):
        raise AssertionError(f"{what}: the bundle's output differs from "
                             "the direct call")


def launch_roofline(rec):
    from repro_torch import roofline
    t = roofline.terms(rec)
    return dict(t_compute_ms=t["t_compute_s"] * 1e3,
                t_memory_lower_ms=t["t_memory_lower_s"] * 1e3,
                t_collective_ms=(t["t_collective_s"] * 1e3
                                 if t["t_collective_s"] != "n/a" else "n/a"),
                bound_ms=t["bound_s"] * 1e3, bound_by=t["dominant"])


def launch_lm_cell(arch, shape, reduced, dev, seed, steps=5):
    """One LM cell: its h100x1 dry run at the cut shape, the bundle's real
    inputs on the card, the bundle's output against the direct call (bit
    for bit), FlopCounterMode on the card against the meta count, and a
    warm-up then ``steps`` timed steps beside the roofline bound."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun, steps as Steps
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    from repro_torch.train.train_loop import make_step
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, "h100x1", write=False)
    if not rec["ok"]:
        raise AssertionError(f"dry run of {arch} {shape.name}: "
                             f"{rec['error']}")
    bundle = Steps.build_bundle(arch, shape)
    cfg = bundle.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(seed)
    args = Steps.materialize(bundle, gen, dev)

    # the direct call on the same inputs (decode writes its cache in
    # place: the direct call gets a copy, the bundle the cache itself,
    # whose later steps go on from there)
    if bundle.kind == "train":
        want = make_step(cfg, Steps.adam_config(cfg))(*args)
    elif bundle.kind == "prefill":
        want = M.prefill(cfg, args[0], args[1], shape.seq_len)
    else:
        want = M.decode_step(cfg, args[0], tree_map(lambda a: a.clone(),
                                                    args[1]), args[2])
    got = bundle.fn(*args)
    _equal_trees(got, want, f"{arch} {shape.name}")
    del got, want
    with FlopCounterMode(display=False) as fc:           # on the card
        bundle.fn(*args)
    card_flops = int(fc.get_total_flops())
    torch.cuda.synchronize()
    state = list(args)

    def step():
        out = bundle.fn(*state)
        if bundle.kind == "train":         # the next step from this one's
            state[0], state[1] = out[0], out[1]
    step()                                                  # warm-up
    times = event_ms(step, steps)
    peak = torch.cuda.max_memory_allocated() - before
    p50 = float(np.percentile(times, 50))
    roof = launch_roofline(rec)
    emit("launch_cell", arch=arch, shape=shape.name, kind=bundle.kind,
         global_batch=shape.global_batch, seq_len=shape.seq_len,
         reduced=[reduced] if reduced else [], notes=bundle.notes,
         step_ms=times, step_p50_ms=p50,
         step_p99_ms=float(np.percentile(times, 99)),
         peak_device_bytes=peak, allocated_before_bytes=before,
         model_flops=rec["model_flops"], flops_counted_meta=rec[
             "flops_counted"], flops_counted_card=card_flops,
         memory=rec["memory"], **roof,
         measured_over_bound=p50 / roof["bound_ms"],
         equal_to_direct_call=True, seconds=time.perf_counter() - t0,
         method=f"CUDA events around each of {steps} steps after a "
         "warm-up", card=card_line())
    if card_flops != rec["flops_counted"]:
        raise AssertionError(f"{arch} {shape.name}: FlopCounterMode counts "
                             f"{card_flops} on the card, {rec['flops_counted']}"
                             " on meta tensors")
    del args, state
    torch.cuda.empty_cache()


def launch_search_cell(arch, shape, reduced, dev, seed, steps=5):
    """The SVFusion cell on one pod256 shard in an NCCL group of one rank:
    its h100x1 dry run, the bundle against the direct sharded step (bit
    for bit), l2_gather launches in the bundle's run, step times beside
    the bound, and l2_gather at D = 100 against its plain version and
    its bound. Returns (launches, the l2_gather row)."""
    import torch
    from repro_torch.core.distributed import (RankMesh,
                                              make_distributed_search)
    from repro_torch.kernels.l2_gather import kernel as K
    from repro_torch.launch import dryrun, steps as Steps
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, "h100x1", write=False)
    if not rec["ok"]:
        raise AssertionError(f"dry run of {arch}: {rec['error']}")
    rmesh = RankMesh((1, 1), ("data", "model"))
    bundle = Steps.build_svfusion_bundle(shape, rmesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx, q, key = Steps.materialize(bundle, gen, dev)
    K.launches = 0                    # the bundle's run alone
    ids, dists = bundle.fn(idx, q, key)
    torch.cuda.synchronize()
    launched = K.launches
    direct = make_distributed_search(
        rmesh, Steps.SVF_PARAMS, data_axes=("data", "model"),
        query_axis=None)(idx, q, seed=0)
    _equal_trees((ids, dists), direct, f"{arch} {shape.name}")
    if launched == 0:
        raise AssertionError("the search bundle launched no l2_gather")
    if not ((ids >= 0) & (ids < shape.n)).all():
        raise AssertionError("the search bundle returned ids outside the "
                             "shard")
    bundle.fn(idx, q, key)                                  # warm-up
    times = event_ms(lambda: bundle.fn(idx, q, key), steps)
    peak = torch.cuda.max_memory_allocated() - before
    p50 = float(np.percentile(times, 50))
    roof = launch_roofline(rec)
    # l2_gather at the step's shape: the shard's table, a round's ids
    kid = ids_with_holes(gen, dev, shape.batch,
                         Steps.SVF_PARAMS.beam * shape.degree, shape.n)
    row = l2_gather_case("msturing_shard", idx["vectors"], kid, q)
    emit("launch_cell", arch=arch, shape=shape.name, kind=bundle.kind,
         rows=shape.n, dim=shape.dim, degree=shape.degree,
         queries=shape.batch, reduced=[reduced], notes=bundle.notes,
         step_ms=times, step_p50_ms=p50,
         step_p99_ms=float(np.percentile(times, 99)),
         peak_device_bytes=peak, allocated_before_bytes=before,
         model_flops=rec["model_flops"],
         flops_per_device=rec["flops_per_device"],
         flops_counted="unavailable: the search syncs the host",
         memory=rec["memory"], collectives=rec["collectives"], **roof,
         measured_over_bound=p50 / roof["bound_ms"],
         l2_gather_launches=launched, equal_to_direct_call=True,
         seconds=time.perf_counter() - t0,
         method=f"CUDA events around each of {steps} steps after a "
         "warm-up", card=card_line())
    del idx, q, kid
    torch.cuda.empty_cache()
    return launched, row


def launch_dtensor(dev, seed):
    """In the NCCL group of one rank: the SmolLM smoke loss with its params
    and batch as DTensors on a (1, 1) (data, model) mesh, bit-equal to
    the plain loss; ``remesh`` of a tree onto that mesh, values equal."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import load_smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as Sh
    from repro_torch.models.layers import tree_map
    from repro_torch.train.compression import remesh
    torch.cuda.set_device(dev)
    mesh = make_test_mesh((1, 1), ("data", "model"))
    cfg = load_smoke_config("smollm_135m")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    tok = torch.randint(0, cfg.vocab, (8, 32), dtype=torch.int32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            seed + 1))
    batch = {"tokens": tok, "labels": tok}
    plain = M.loss_fn(cfg, params, batch)
    with Sh.use_mesh(mesh):
        dp = tree_map(lambda a, s: Sh.NamedSharding(mesh, s).place(a),
                      params, M.param_specs(cfg))
        db = {k: Sh.NamedSharding(mesh, Sh.ax("batch", None)).place(v)
              for k, v in batch.items()}
        sharded = Sh.local(M.loss_fn(cfg, dp, db))
    tree = {"w": torch.randn(8, 8, device=dev), "b": torch.ones(8, device=dev)}
    spec = {"w": (("data",), ("model",)), "b": (("pod", "data"),)}
    moved = remesh(tree, spec, mesh)
    same = all(torch.equal(moved[k].full_tensor(), tree[k]) for k in tree)
    emit("launch_dtensor", backend=dist.get_backend(), mesh=[1, 1],
         plain_loss=plain.item(), dtensor_loss=sharded.item(),
         bit_equal=bool(torch.equal(plain, sharded)),
         dtensor_type=type(dp["tok"]["embed"]).__name__,
         remesh_equal=same, remesh_mesh_size=moved["w"].device_mesh.size())
    if not torch.equal(plain, sharded) or not same:
        raise AssertionError("the DTensor loss or remesh differs on the "
                             "card")


def phase_launch(dev, seed):
    """The launch step builders on the card: each LAUNCH_CELLS cell's
    bundle from ``launch.steps`` at its cut shape, its h100x1 dry run and
    roofline beside its measured step; then, in an NCCL group of one
    rank, the SVFusion cell, the DTensor loss and ``remesh``. Returns
    (l2_gather launches of the search bundle, the l2_gather row at
    D = 100)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import steps as Steps
    t0 = time.perf_counter()
    for arch, name, cut, reduced in LAUNCH_CELLS[:4]:
        # granite's prefill_32k step takes ~8 s: 2 timed steps, not 5
        launch_lm_cell(arch, dataclasses.replace(SHAPES[name], **cut),
                       reduced, dev, seed,
                       steps=2 if name == "prefill_32k" else 5)
    arch, name, cut, reduced = LAUNCH_CELLS[4]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        launched, row = launch_search_cell(
            arch, dataclasses.replace(Steps.SVF_SHAPES[name], **cut),
            reduced, dev, seed)
        launch_dtensor(dev, seed)
    finally:
        dist.destroy_process_group()
    emit("launch", seconds=time.perf_counter() - t0)
    return launched, row


# the sharded phase's (family, MoE dispatch) cases and cell: the tests'
# (tests/test_torch_launch_sharded.py); no smoke width is 36, so a gather
# of a KV cache shows by its length
SHARDED_CASES = (("smollm_135m", None), ("qwen3_0p6b", None),
                 ("phi4_mini_3p8b", None), ("deepseek_7b", None),
                 ("granite_moe_1b", None), ("granite_moe_1b", "dense"),
                 ("grok1_314b", None), ("falcon_mamba_7b", None),
                 ("hymba_1p5b", None), ("internvl2_2b", None),
                 ("whisper_medium", None))
SHARDED_B, SHARDED_S, SHARDED_PROMPT = 4, 36, 28
SHARDED_WORLD = 4


def sharded_bundles(arch, impl, mesh):
    """The fp32 smoke config of ``arch`` (remat "full" for training) and
    its train, prefill and decode bundles at the sharded cell, in one
    process and resolved on ``mesh``."""
    from repro_torch.configs.base import ShapeConfig, load_smoke_config
    from repro_torch.launch import steps as Steps
    base = load_smoke_config(arch).replace(
        dtype="float32", remat_policy="full",
        **({"moe_impl": impl} if impl else {}))
    out = {}
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("smoke_" + kind, SHARDED_S, SHARDED_B, kind)
        cfg = Steps.tune_config(base, shape)
        out[kind] = (cfg, Steps.step_bundle(arch, shape, cfg),
                     Steps.step_bundle(arch, shape, cfg, mesh=mesh))
    return out


def sharded_inputs(cfg, seed, dev=None):
    """Params (fp32, from the seed) and the cell's batches: the train
    batch, the prefill batch, the decode prompt (its first
    SHARDED_PROMPT positions) and a decode token; drawn on the CPU, the
    same in every process, and moved to ``dev`` (default: the CPU)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    rng = np.random.default_rng(seed)
    B, S = SHARDED_B, SHARDED_S
    P = cfg.n_patches if cfg.family == "vlm" else 0
    tok = rng.integers(0, cfg.vocab, (B, S - P)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.normal(size=(B, P, cfg.d_model))
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(size=(B, S, cfg.d_model))

    def batch(**kw):
        return {k: torch.as_tensor(v, dtype=torch.int32 if v.dtype.kind
                                   == "i" else torch.float32, device=dev)
                for k, v in dict(kw, **extra).items()}
    params = tree_map(lambda a: a.to(dev),
                      M.init_params(cfg, torch.Generator().manual_seed(seed)))
    return (params, batch(tokens=tok, labels=np.roll(tok, -1, 1)),
            batch(tokens=tok), batch(tokens=tok[:, :SHARDED_PROMPT - P]),
            torch.as_tensor(rng.integers(0, cfg.vocab, (B, 1)),
                            dtype=torch.int32, device=dev))


def _whole(x):
    from repro_torch.models.sharding import is_dtensor
    return x.full_tensor() if is_dtensor(x) else x


def _tree_ratio(got, want):
    """max over leaves of max|x - x_1| / (1e-4 max|x_1| + 1e-7): at most
    1 within the gradient tolerance."""
    from repro_torch.utils import tree_leaves
    return max(float((_whole(g).float() - w.float()).abs().max()
                     / (1e-4 * w.float().abs().max() + 1e-7))
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def _tree_err(got, want):
    from repro_torch.utils import tree_leaves
    return max(float((_whole(g).float() - w.float()).abs().max())
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def _spec_pairs(tree, specs):
    """(tensor, spec) for every tensor of an output tree."""
    import torch
    if torch.is_tensor(tree):
        return [(tree, specs)]
    if isinstance(tree, dict):
        return [x for k in tree for x in _spec_pairs(tree[k], specs[k])]
    return [x for t, sp in zip(tree, specs) for x in _spec_pairs(t, sp)]


def _laid_out(tree, specs, mesh):
    """Every leaf a DTensor with its spec's placements, its local block of
    ``shard_shape`` (this rank's; the first ranks' on an uneven split)."""
    from repro_torch.models import sharding as Sh
    return all(Sh.is_dtensor(x)
               and list(x.placements) == Sh.placements(sp, mesh)
               and tuple(x.to_local().shape)
               == Sh.shard_shape(x.shape, sp, mesh)
               for x, sp in _spec_pairs(tree, specs))


def _collectives_mode():
    """A dispatch mode that records the collectives DTensor issues (name,
    output shape), not the ``wait_tensor`` that completes each."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Collectives(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented      # DTensor lowers to collectives
            out = func(*args, **(kwargs or {}))
            if (func.namespace == "_c10d_functional"
                    and func.__name__.split(".")[0] != "wait_tensor"):
                self.ops.append([func.__name__.split(".")[0],
                                 list(out.shape)])
            return out
    return Collectives()


def sharded_case(arch, impl, mesh, seed, dev=None):
    """One case on this rank (a gloo rank on the CPU, or an NCCL rank with
    ``dev`` its card): the train step (and its gradients alone), the
    prefill and two decode steps run sharded by ``run_sharded`` against
    the same bundles in one process, on the same device."""
    import dataclasses
    import torch
    from repro_torch.launch import steps as Steps
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    from repro_torch.train import optimizer as Opt
    from repro_torch.train.train_loop import loss_and_grads
    t0 = time.perf_counter()
    bundles = sharded_bundles(arch, impl, mesh)
    cfg, one, sb = bundles["train"]
    params, batch, pbatch, prompt, tok = sharded_inputs(cfg, seed, dev)
    rec = _collectives_mode()
    opt = Opt.init_adam(params, Steps.adam_config(cfg))
    want = one.fn(params, opt, batch)
    with rec:
        got = Steps.run_sharded(sb, (params, opt, batch), mesh)
        grads_b = dataclasses.replace(
            sb, fn=lambda p, o, b: loss_and_grads(cfg, p, b),
            out_shardings=((), sb.in_shardings[0]))
        _, grads = Steps.run_sharded(grads_b, (params, opt, batch), mesh)
    _, w_grads = loss_and_grads(cfg, params, batch)
    loss_one = float(want[2])
    r = dict(loss_one=loss_one, loss_sharded=float(_whole(got[2])),
             loss_gap=abs(float(_whole(got[2])) - loss_one) / abs(loss_one),
             grad_share=_tree_ratio(grads, w_grads),
             param_share=_tree_ratio(got[0], want[0]),
             moment_share=max(_tree_ratio(got[1].mu, want[1].mu),
                              _tree_ratio(got[1].nu, want[1].nu)),
             train_laid_out=_laid_out(got[:2], sb.out_shardings[:2], mesh))
    _, one, sb = bundles["prefill"]
    want = one.fn(params, pbatch)
    with rec:
        got = Steps.run_sharded(sb, (params, pbatch), mesh)
    r.update(prefill_logits_err=_tree_err(got[0], want[0]),
             prefill_cache_err=_tree_err(got[1], want[1]),
             prefill_laid_out=_laid_out(got[1], sb.out_shardings[1], mesh))
    cfg, one, sb = bundles["decode"]
    _, cache = M.prefill(cfg, params, prompt, SHARDED_S)
    w_cache, d_cache = tree_map(lambda a: a.clone(), cache), cache
    errs, same, n_before = [], True, len(rec.ops)
    for _ in range(2):
        w_logits, w_cache = one.fn(params, w_cache, tok)
        with rec:
            logits, d_cache = Steps.run_sharded(sb, (params, d_cache, tok),
                                                mesh)
        errs.append(_tree_err(logits, w_logits))
        same &= bool(torch.equal(_whole(logits).argmax(-1),
                                 w_logits.argmax(-1)))
        tok = w_logits.argmax(-1).to(torch.int32)
    gathers = [shape for op, shape in rec.ops
               if op == "all_gather_into_tensor"]
    r.update(decode_logits_err=max(errs), decode_ids_equal=same,
             decode_cache_err=_tree_err(d_cache, w_cache),
             decode_laid_out=_laid_out(d_cache, sb.out_shardings[1], mesh),
             decode_cache_gathers=sum(SHARDED_S in shape for op, shape
                                      in rec.ops[n_before:]
                                      if op == "all_gather_into_tensor"),
             collectives=len(rec.ops),
             largest_all_gather_elements=max(
                 (math.prod(shape) for shape in gathers), default=0),
             seconds=time.perf_counter() - t0)
    return r


def sharded_child(args):
    """A gloo rank of the sharded phase's part (a) (``--sharded-child DIR
    --sharded-rank R``), on the CPU: join the 4-rank group through a file
    rendezvous in DIR, run every case on a (2, 2) mesh and write its
    record to DIR."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    root = Path(args.sharded_child)
    dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                            world_size=SHARDED_WORLD, rank=args.sharded_rank)
    try:
        mesh = make_test_mesh((2, 2), ("data", "model"))
        res = {}
        for arch, impl in SHARDED_CASES:
            name = arch + ("-" + impl if impl else "")
            res[name] = sharded_case(arch, impl, mesh, args.seed)
        (root / f"rank{args.sharded_rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    sys.exit(0)


def sharded_cpu(seed, timeout=300):
    """Part (a): SHARDED_WORLD gloo processes on this machine's CPU, under
    its torch, every case against one process; one line a case. Fails
    beyond the tests' tolerances."""
    import torch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        run_ranks([[sys.executable, str(ROOT / "chip_smoke.py"),
                    "--sharded-child", td, "--sharded-rank", str(r),
                    "--seed", str(seed)] for r in range(SHARDED_WORLD)],
                  timeout, env=dict(os.environ, OMP_NUM_THREADS="2"))
        ranks = [json.loads((Path(td) / f"rank{r}.json").read_text())
                 for r in range(SHARDED_WORLD)]
    sharded_verdict(ranks, "sharded_family",
                    f"{SHARDED_WORLD} gloo processes on the CPU (not the "
                    f"card), torch {torch.__version__}, a (2, 2) (data, "
                    "model) mesh")
    return time.perf_counter() - t0


def sharded_verdict(ranks, line, where):
    """Every case of ``ranks`` (one {case: sharded_case record} a rank)
    held to the tests' tolerances: one ``line`` a case with the worst
    value over the ranks; raises at the first case beyond them."""
    for name in ranks[0]:
        rs = [rank[name] for rank in ranks]
        worst = {k: max(r[k] for r in rs) for k in rs[0]
                 if isinstance(rs[0][k], float) and k != "seconds"}
        ok = (worst["loss_gap"] <= 1e-4 and worst["grad_share"] <= 1
              and worst["param_share"] <= 1 and worst["moment_share"] <= 1
              and max(worst[k] for k in worst if k.endswith("_err")) <= 1e-4
              and all(r["decode_ids_equal"] and r["train_laid_out"]
                      and r["prefill_laid_out"] and r["decode_laid_out"]
                      and r["decode_cache_gathers"] == 0 for r in rs))
        emit(line, case=name, where=where,
             cell=f"{SHARDED_B} x {SHARDED_S} (decode from {SHARDED_PROMPT})",
             **{k: v for k, v in rs[0].items() if k not in worst},
             **worst, checked=ok)
        if not ok:
            raise AssertionError(f"sharded {name}: beyond the tolerances "
                                 f"or laid out otherwise: {worst}")


def sharded_card(dev):
    """Part (b): this process as rank 0 of 4 through the fake process
    group, a (2, 2) mesh on ``dev``; each family's train, prefill and
    decode step run sharded on DTensors there. DTensor accepts every op
    on the card and each param's block has ``shard_shape``'s shape; the
    fake collectives carry no data, so no value is checked."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import steps as Steps
    from repro_torch.utils import tree_leaves
    t0 = time.perf_counter()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=SHARDED_WORLD)
    try:
        mesh = DeviceMesh(dev.type, torch.arange(SHARDED_WORLD).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        for arch, impl in SHARDED_CASES:
            t1 = time.perf_counter()
            bundles = sharded_bundles(arch, impl, mesh)
            blocks = True
            for kind, (cfg, _, sb) in bundles.items():
                args = Steps.materialize(
                    sb, torch.Generator(device=dev).manual_seed(0), dev)
                out = Steps.run_sharded(sb, args, mesh)
                if kind == "train":
                    blocks = _laid_out(out[0], sb.out_shardings[0], mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            emit("sharded_card", case=arch + ("-" + impl if impl else ""),
                 device=str(tree_leaves(out)[0].to_local().device),
                 steps=list(bundles), ops_accepted=True,
                 param_blocks_match_shard_shape=blocks,
                 values="not checked: the fake process group's "
                 "collectives carry no data",
                 seconds=time.perf_counter() - t1)
            if not blocks:
                raise AssertionError(f"{arch}: a param's block differs "
                                     "from shard_shape")
    finally:
        dist.destroy_process_group()
    return time.perf_counter() - t0


def phase_sharded(dev, seed):
    """Every LM family's train, prefill and decode step through
    ``run_sharded`` on a (2, 2) mesh: (a) on CPU gloo ranks under this
    machine's torch, values against one process; (b) on the card as rank
    0 of a fake process group, ops and blocks only."""
    cpu_s = sharded_cpu(seed)
    card_s = sharded_card(dev)
    emit("sharded", part_a_seconds=cpu_s, part_b_seconds=card_s,
         part_a="CPU gloo ranks: values against one process",
         part_b=f"{dev} through the fake process group: ops and blocks, "
         "no values")


# ---------------------------------------------------------------------------
# four_cards: the sharded paths on four cards of one host over NCCL
# ---------------------------------------------------------------------------

FOUR = 4                      # ranks, one a card
FOUR_GROUP_TIMEOUT_S = 180    # a collective a failed peer holds up
FOUR_TIMEOUT_S = 480          # the four ranks' run, start to end
# part (a)'s layouts, as tests/test_torch_distributed.py's and a plain
# data layout: (name, mesh shape, axes, data axes, query axis)
FOUR_LAYOUTS = (
    ("data4_replicated", (4,), ("data",), ("data",), None),
    ("pod2_x_data2_replicated", (2, 2), ("pod", "data"), ("pod", "data"),
     None),
    ("data2_x_query2", (2, 2), ("data", "model"), ("data",), "model"))


def gather_obj(x):
    """``x`` from every rank of the world, in rank order."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def rank_ms(fn, steps):
    """Milliseconds of each of ``steps`` calls of ``fn``: every rank starts
    a call after a barrier of the world, CUDA events time it on each
    rank, and a step's time is the largest over the ranks."""
    import torch
    import torch.distributed as dist
    times = []
    for _ in range(steps):
        dist.barrier()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return [max(t) for t in zip(*gather_obj(times))]


def _p(times, q):
    return float(np.percentile(times, q))


@contextlib.contextmanager
def counting_all_gathers():
    """Within the block, every all-gather of the sharded search
    (``distributed._all_gather``) as [group size, bytes received]."""
    import torch.distributed as dist
    from repro_torch.core import distributed as SD
    calls, orig = [], SD._all_gather

    def counted(x, group):
        out = orig(x, group)
        calls.append([dist.get_world_size(group),
                      out.numel() * out.element_size()])
        return out
    SD._all_gather = counted
    try:
        yield calls
    finally:
        SD._all_gather = orig


def merge_in_step_order(ids, dists, grid, k):
    """One process's merge of per-shard results [S, B, k'] (shard order,
    row-major over ``grid``, the sizes of the step's data axes) in the
    step's order: over the first data axis, then the next."""
    import torch
    from repro_torch.core.distributed import merge_shard_results
    ids, dists = (x.reshape(*grid, *x.shape[1:]) for x in (ids, dists))
    while ids.dim() > 2:
        rest, (B, kk) = ids.shape[1:-2], ids.shape[-2:]
        fi = ids.reshape(ids.shape[0], -1, B, kk)
        fd = dists.reshape(dists.shape[0], -1, B, kk)
        outs = [merge_shard_results(fi[:, r], fd[:, r], k)
                for r in range(fi.shape[1])]
        ids = torch.stack([o[0] for o in outs]).reshape(*rest, B, k)
        dists = torch.stack([o[1] for o in outs]).reshape(*rest, B, k)
    return ids, dists


def four_search(dev, seed, cards, n=262_144, d=96, b=1024, big=10_240,
                cache_slots=131_072, steps=10):
    """(a) The sharded search at Deep1B's width on graphs built per card:
    rank 0 draws 4 x ``n`` synthetic descriptors and ``big`` queries,
    each rank builds a graph over its own ``n`` rows on its card, and the
    four shards are gathered to every rank. Then each of FOUR_LAYOUTS on
    ``b`` queries (and the (4,) layout on all ``big``): each rank's ids
    and dists against rank 0's one-process merge of the shards'
    ``search_shard`` results with the same entries (bit for bit),
    recall@10 against brute force over the union, step ms (warm-up
    first), l2_gather launches on every rank, all-gathers a step."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as SD
    from repro_torch.core.build import build_index
    from repro_torch.core.search import brute_force_topk, recall_at_k
    from repro_torch.core.types import GraphState, SearchParams
    from repro_torch.kernels.l2_gather import kernel as K
    rank, world = dist.get_rank(), dist.get_world_size()
    sp = SearchParams(k=10, pool=64, max_iters=64, beam=16)
    t0 = time.perf_counter()
    vecs = torch.empty(world * n, d, device=dev)
    queries = torch.empty(big, d, device=dev)
    if rank == 0:
        draw = synthetic_descriptors(
            torch.Generator(device=dev).manual_seed(seed), world * n, d, dev)
        vecs.copy_(draw(world * n))
        queries.copy_(draw(big))
    dist.broadcast(vecs, 0)
    dist.broadcast(queries, 0)
    t1 = time.perf_counter()
    mine = index_arrays(build_index(vecs[rank * n:(rank + 1) * n],
                                    degree=32, cache_slots=cache_slots,
                                    device=dev))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    # every shard on every rank ([world, ...] a field; bool as uint8)
    shards = {f: SD._all_gather(x.to(torch.uint8) if x.dtype == torch.bool
                                else x, None)
              for f, x in mine.items()}
    shards["alive"] = shards["alive"].bool()
    builds = gather_obj(build_s)
    for name, shape, axes, data_axes, qaxis in FOUR_LAYOUTS:
        mesh = SD.RankMesh(shape, axes)
        present = [a for a in data_axes if a in axes]
        grid = [mesh.size(a) for a in present]
        S = math.prod(grid)
        shard = mesh.linear_index(present)
        idx = {f: x[shard] for f, x in shards.items()}
        step = SD.make_distributed_search(mesh, sp, data_axes=data_axes,
                                          query_axis=qaxis)
        for q in ((queries[:b], queries) if name == FOUR_LAYOUTS[0][0]
                  else (queries[:b],)):
            ql = mesh.block(q, qaxis) if qaxis else q
            block = mesh.index(qaxis) if qaxis else 0
            ent = SD.shard_entries(seed, shard, ql.shape[0], sp.pool, n, dev)
            K.launches = 0
            with counting_all_gathers() as gathers:
                ids, dists = step(idx, ql, ent)   # warm-up: communicators
            torch.cuda.synchronize()
            launched = K.launches
            times = rank_ms(lambda: step(idx, ql, ent), steps)
            got = gather_obj(dict(ids=ids.cpu().numpy(),
                                  dists=dists.cpu().numpy(),
                                  entries=ent.cpu().numpy(), shard=shard,
                                  block=block, launches=launched))
            if rank != 0:
                continue
            nb = q.shape[0] // ql.shape[0]
            want = []
            for m in range(nb):
                qm = q[m * ql.shape[0]:(m + 1) * ql.shape[0]]
                res = [SD.search_shard(
                    {f: x[s] for f, x in shards.items()}, qm,
                    torch.as_tensor(next(g["entries"] for g in got
                                         if g["shard"] == s
                                         and g["block"] == m), device=dev),
                    sp, offset=s * n) for s in range(S)]
                want.append(merge_in_step_order(
                    torch.stack([r[0] for r in res]),
                    torch.stack([r[1] for r in res]), grid, sp.k))
            for r, g in enumerate(got):
                wi, wd = (x.cpu().numpy() for x in want[g["block"]])
                if not (np.array_equal(g["ids"], wi)
                        and np.array_equal(g["dists"], wd)):
                    raise AssertionError(
                        f"four_search {name}: rank {r}'s answer differs "
                        "from the one-process merge")
                if g["launches"] == 0:
                    raise AssertionError(f"four_search {name}: rank {r} "
                                         "launched no l2_gather")
            found = torch.cat([w[0] for w in want])
            union = GraphState(vecs[:S * n], None,
                               torch.ones(S * n, dtype=torch.bool,
                                          device=dev), None, None, None)
            truth = torch.cat([brute_force_topk(union, q[i:i + 1024], 10)[0]
                               for i in range(0, q.shape[0], 1024)])
            recall = float(recall_at_k(found, truth))
            emit("four_search", layout=name, mesh=list(shape),
                 axes=list(axes), data_axes=list(present), query_axis=qaxis,
                 shards=S, shard_rows=n, dim=d, degree=32,
                 cache_slots=cache_slots, queries=q.shape[0],
                 queries_a_rank=ql.shape[0], recall_at_10=recall,
                 step_ms=times, step_p50_ms=_p(times, 50),
                 step_p99_ms=_p(times, 99),
                 l2_gather_launches=[g["launches"] for g in got],
                 all_gathers=gathers,
                 all_gather_bytes=sum(x[1] for x in gathers),
                 identical_to="rank 0: the shards' search_shard results "
                 "with the same entries, merged in the step's order",
                 shard_build_s=builds,
                 method=f"CUDA events after a barrier, the max over the "
                 f"ranks, {steps} steps after a warm-up", cards=cards)
            if recall < 0.5:
                raise AssertionError(f"four_search {name}: recall@10 "
                                     f"{recall} below 0.5")
    if rank == 0:
        emit("four_search_done", seconds=time.perf_counter() - t0,
             reduced=[f"rows a shard: Deep1B's ~3.9M a chip -> {n:,} (the "
                      "build's time, ROADMAP E.2); synthetic "
                      "descriptors from the seed"])


def four_msturing(dev, seed, cards, shape=None, steps=5):
    """(b) svfusion-msturing search_1k at its h100x4 shape: the bundle on a
    (1, 4) RankMesh, each rank materializing its own 50M-row shard on its
    card; the bundle's output against the direct step (bit for bit),
    step ms beside the h100x4 dry run's bound, peak bytes a card, and
    l2_gather at D = 100 on each rank's table against its plain version
    and its bound."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import (RankMesh,
                                              make_distributed_search)
    from repro_torch.kernels.l2_gather import kernel as K
    from repro_torch.launch import dryrun, steps as Steps
    rank = dist.get_rank()
    t0 = time.perf_counter()
    shape = shape or Steps.SVF_SHAPES["search_1k"]
    arch = Steps.SVF_ARCH.get(shape.name, "svfusion_msturing")
    rec = dryrun.run_cell(arch, shape, "h100x4", write=False) \
        if rank == 0 else None
    if rec is not None and not rec["ok"]:
        raise AssertionError(f"dry run of {arch}: {rec['error']}")
    rmesh = RankMesh((1, FOUR), ("data", "model"))
    bundle = Steps.build_svfusion_bundle(shape, rmesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx, q, key = Steps.materialize(
        bundle, gen, dev, shard=rmesh.linear_index(("data", "model")))
    q0 = q.clone()
    dist.broadcast(q0, 0)
    K.launches = 0
    with counting_all_gathers() as gathers:
        ids, dists = bundle.fn(idx, q, key)
    torch.cuda.synchronize()
    launched = K.launches
    direct = make_distributed_search(
        rmesh, Steps.SVF_PARAMS, data_axes=("data", "model"),
        query_axis=None)(idx, q, seed=0)
    _equal_trees((ids, dists), direct, f"{arch} {shape.name} on four cards")
    valid = bool(((ids >= 0) & (ids < shape.n)).all())
    times = rank_ms(lambda: bundle.fn(idx, q, key), steps)
    peak = torch.cuda.max_memory_allocated() - before
    n_local = idx["vectors"].shape[0]
    kid = ids_with_holes(gen, dev, shape.batch,
                         Steps.SVF_PARAMS.beam * shape.degree, n_local)
    row = l2_gather_case(f"msturing_h100x4_rank{rank}", idx["vectors"],
                         kid, q)
    got = gather_obj(dict(launches=launched, peak=peak, valid=valid,
                          same_queries=bool(torch.equal(q0, q)), row=row,
                          rows=n_local))
    if rank == 0:
        roof = launch_roofline(rec)
        emit("four_msturing", arch=arch, shape=shape.name, mesh=[1, FOUR],
             rows=shape.n, rows_a_card=[g["rows"] for g in got],
             dim=shape.dim, degree=shape.degree, queries=shape.batch,
             reduced=[], data="synthetic vectors and neighbour lists from "
             "the seed, drawn a shard a card", step_ms=times,
             step_p50_ms=_p(times, 50), step_p99_ms=_p(times, 99),
             **roof, measured_over_bound=_p(times, 50) / roof["bound_ms"],
             collectives_dry_run=rec["collectives"], all_gathers=gathers,
             argument_bytes_dry_run=rec["memory"]["argument_bytes"],
             peak_device_bytes=[g["peak"] for g in got],
             allocated_before_bytes=before,
             l2_gather_launches=[g["launches"] for g in got],
             l2_gather=[g["row"] for g in got],
             queries_equal_on_every_rank=all(g["same_queries"] for g in got),
             ids_valid=all(g["valid"] for g in got),
             equal_to_direct_call=True, seconds=time.perf_counter() - t0,
             method=f"CUDA events after a barrier, the max over the ranks, "
             f"{steps} steps after a warm-up", cards=cards)
        for r, g in enumerate(got):
            if not (g["launches"] and g["valid"] and g["same_queries"]):
                raise AssertionError(f"four_msturing: rank {r}: {g}")
    del idx, q, kid, direct
    torch.cuda.empty_cache()


def four_sharded(dev, seed, cards):
    """(c) Every SHARDED_CASES case on a (2, 2) NCCL mesh, each rank on its
    card against one process on that card, held to the sharded phase's
    tolerances."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    t0 = time.perf_counter()
    mesh = make_test_mesh((2, 2), ("data", "model"))
    res = {}
    for arch, impl in SHARDED_CASES:
        res[arch + ("-" + impl if impl else "")] = sharded_case(
            arch, impl, mesh, seed, dev)
    ranks = gather_obj(res)
    if dist.get_rank() == 0:
        sharded_verdict(ranks, "four_sharded_family",
                        f"{FOUR} {dist.get_backend()} ranks on "
                        f"{dev.type} (one a card under nccl), torch "
                        f"{torch.__version__}, a (2, 2) (data, model) mesh; "
                        f"cards: {cards}")
        emit("four_sharded", cases=len(res),
             seconds=time.perf_counter() - t0)


def four_smollm(dev, seed, cards, batch=32, seq=None, steps=3,
                meshes=((1, FOUR), (2, 2))):
    """(d) SmolLM-135M's train_4k step at its width, global batch ``batch``,
    on each of ``meshes``: the first step's loss against the mean of the
    four one-process losses of each rank's rows, then step ms beside the
    dry run of the cut shape on that mesh, and peak bytes a card."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import SHAPES, load_config
    from repro_torch.launch import dryrun, steps as Steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    from repro_torch.models.sharding import MeshDesc, local
    from repro_torch.train import optimizer as Opt
    rank, world = dist.get_rank(), dist.get_world_size()
    arch = "smollm_135m"
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=batch,
                                **({"seq_len": seq} if seq else {}))
    cfg = Steps.tune_config(load_config(arch), shape)
    for mshape in meshes:
        t0 = time.perf_counter()
        desc = MeshDesc("h100x4" if tuple(mshape) == (1, FOUR)
                        else "h100x4_" + "x".join(map(str, mshape)),
                        ("data", "model"), tuple(mshape))
        rec = dryrun.run_cell(arch, shape, desc, write=False) \
            if rank == 0 else None
        if rec is not None and not rec["ok"]:
            raise AssertionError(f"dry run of {arch}: {rec['error']}")
        mesh = make_test_mesh(mshape, ("data", "model"))
        sb = Steps.step_bundle(arch, shape, cfg, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        # drawn on the CPU: the same inputs on every rank
        params, opt, data = Steps.materialize(
            sb, torch.Generator().manual_seed(seed), "cpu")
        params = tree_map(lambda a: a.to(dev), params)
        opt = Opt.AdamState(opt.step.to(dev),
                            *(tree_map(lambda a: a.to(dev), t)
                              for t in opt[1:]))
        data = tree_map(lambda a: a.to(dev), data)
        rows = batch // world                # rank r's rows: block r
        with torch.no_grad():
            mine = M.loss_fn(cfg, params, {
                k: v[rank * rows:(rank + 1) * rows] for k, v in data.items()})
        one = torch.tensor([float(mine)], device=dev)
        dist.all_reduce(one)
        one = float(one) / world
        state = list(Steps.run_sharded(sb, (params, opt, data), mesh))
        first = float(local(state[2]))
        del params, opt

        def step():
            state[:] = Steps.run_sharded(sb, (state[0], state[1], data),
                                         mesh)
        times = rank_ms(step, steps)
        peak = gather_obj(torch.cuda.max_memory_allocated() - before)
        gap = abs(first - one) / abs(one)
        if rank == 0:
            roof = launch_roofline(rec)
            emit("four_smollm", arch=arch, shape=shape.name, mesh=list(mshape),
                 global_batch=batch, rows_a_card=rows, seq_len=shape.seq_len,
                 reduced=[f"global batch 256 -> {batch} ({rows} a card, the "
                          "one-card launch cell's)"], rules=sb.rules,
                 loss_sharded=first, loss_one_process_mean=one,
                 loss_gap=gap, step_ms=times, step_p50_ms=_p(times, 50),
                 step_p99_ms=_p(times, 99), **roof,
                 measured_over_bound=_p(times, 50) / roof["bound_ms"],
                 model_flops=rec["model_flops"], memory=rec["memory"],
                 peak_device_bytes=peak, allocated_before_bytes=before,
                 seconds=time.perf_counter() - t0,
                 method=f"CUDA events after a barrier, the max over the "
                 f"ranks, {steps} steps after the checked first",
                 cards=cards)
        if gap > 1e-4:
            raise AssertionError(f"four_smollm {mshape}: loss {first} "
                                 f"against {one} one process")
        del state, data
        torch.cuda.empty_cache()


def four_rest(dev, seed, cards, root, rows=1024, cols=4096):
    """(e) ``ef_int8_psum`` and ``make_crosspod_grad_sync`` over the world
    against the mean of every rank's ``ef_compress`` in one process;
    ``remesh`` from a (2, 2) mesh to a 2-rank one; a checkpoint restored
    onto the (2, 2) mesh by ``restore(shardings=)``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sharding import NamedSharding
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.compression import (ef_compress, ef_int8_psum,
                                               make_crosspod_grad_sync,
                                               remesh)
    rank, world = dist.get_rank(), dist.get_world_size()

    def inputs(r):        # rank r's gradient and error, drawn on the CPU
        g = torch.Generator().manual_seed(seed * 1000 + r)
        return (torch.randn(rows, cols, generator=g).to(dev),
                torch.randn(rows, cols, generator=g).to(dev) * 1e-3)
    every = [inputs(r) for r in range(world)]
    g, e = every[rank]
    got, got_err = ef_int8_psum(g, e)
    tree, tree_err = make_crosspod_grad_sync()({"w": g}, {"w": e})
    comp = [ef_compress(*x) for x in every]
    want = torch.stack([c[0] for c in comp]).mean(0)
    scale = float(want.abs().max())
    psum_err = max(float((got - want).abs().max()),
                   float((tree["w"] - want).abs().max())) / scale
    err_equal = bool(torch.equal(got_err, comp[rank][1])
                     and torch.equal(tree_err["w"], comp[rank][1]))

    big = make_test_mesh((2, 2), ("data", "model"))
    small = make_test_mesh((1, 2), ("data", "model"))
    x = {"w": torch.arange(64.0, device=dev).reshape(8, 8),
         "b": torch.ones(8, device=dev)}
    spec = {"w": (("data",), ("model",)), "b": (("data",),)}
    placed = {k: NamedSharding(big, spec[k]).place(v) for k, v in x.items()}
    moved = remesh(placed, spec, small)
    in_small = rank < small.size()
    remesh_equal = (not in_small) or all(
        torch.equal(moved[k].full_tensor(), x[k]) for k in x)

    ckpt = CheckpointManager(str(Path(root) / "ckpt"))
    if rank == 0:
        ckpt.save(3, {k: v.cpu() for k, v in x.items()})
    dist.barrier()
    step, back = ckpt.restore(x, shardings={k: NamedSharding(big, spec[k])
                                            for k in x})
    restore_equal = step == 3 and all(
        torch.equal(back[k].full_tensor(), x[k]) for k in x)
    got = gather_obj(dict(psum_err=psum_err, err_equal=err_equal,
                          remesh_equal=remesh_equal, in_small=in_small,
                          remesh_local=list(moved["w"].to_local().shape),
                          restore_equal=restore_equal,
                          restore_local=list(back["w"].to_local().shape)))
    if rank == 0:
        emit("four_rest", ranks=world, psum_shape=[rows, cols],
             psum_err_over_max=max(r["psum_err"] for r in got),
             psum_tol=1e-6, psum_new_err_equal=[r["err_equal"] for r in got],
             remesh_from=[2, 2], remesh_to=[1, 2],
             remesh_equal=[r["remesh_equal"] for r in got],
             remesh_local=[r["remesh_local"] for r in got],
             restore_equal=[r["restore_equal"] for r in got],
             restore_local=[r["restore_local"] for r in got], cards=cards)
        for r, res in enumerate(got):
            if not (res["psum_err"] <= 1e-6 and res["err_equal"]
                    and res["remesh_equal"] and res["restore_equal"]):
                raise AssertionError(f"four_rest: rank {r}: {res}")


def four_rank(rank, init, seed, root, backend="nccl"):
    """The body of a four_cards rank: its device (``rank_device``: its own
    card under NCCL) made current before it joins the group, a group
    timeout of FOUR_GROUP_TIMEOUT_S, then parts (e), (c), (a), (b), (d)
    and a barrier; rank 0 prints the lines. An NCCL group is left to the
    process's exit (``four_cards_child``): ``destroy_process_group``
    hung on torch 2.11 with NCCL 2.28 after every part had passed."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import rank_device
    dev = rank_device(backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init, world_size=FOUR, rank=rank,
        timeout=datetime.timedelta(seconds=FOUR_GROUP_TIMEOUT_S),
        **({"device_id": dev} if dev.type == "cuda" else {}))
    cards = card_line().splitlines()
    four_rest(dev, seed, cards, root)
    four_sharded(dev, seed, cards)
    four_search(dev, seed, cards)
    four_msturing(dev, seed, cards)
    four_smollm(dev, seed, cards)
    dist.barrier()
    torch.cuda.synchronize()
    if backend != "nccl":
        dist.destroy_process_group()


def four_cards_child(args):
    """A four_cards rank (``--four-child DIR --four-rank R --four-init
    URL``, hidden arguments): exits 0 after ``four_rank``, 1 with its
    traceback if it raised, without tearing its NCCL group down."""
    import traceback
    code = 0
    try:
        four_rank(args.four_rank, args.four_init, args.seed, args.four_child)
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def phase_four_cards(seed, timeout=FOUR_TIMEOUT_S):
    """The sharded paths on FOUR cards of this host over NCCL, one rank
    process a card (``four_rank``), polled by ``run_ranks``: rank 0's
    lines pass through; at the first rank that fails the rest are killed
    and its error raised. Never run on fewer cards."""
    import torch
    if torch.cuda.device_count() < FOUR:
        raise AssertionError(f"four_cards needs {FOUR} cards, this machine "
                             f"has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as td:
        env = dict(os.environ, NCCL_DEBUG="WARN", OMP_NUM_THREADS=str(
            max(1, (os.cpu_count() or FOUR) // FOUR)))
        init = f"tcp://localhost:{_free_port()}"
        seconds = run_ranks(
            [[sys.executable, str(ROOT / "chip_smoke.py"), "--four-child",
              td, "--four-rank", str(r), "--four-init", init, "--seed",
              str(seed)] for r in range(FOUR)], timeout, env=env, show=0)
    emit("four_cards", ranks=FOUR, backend="nccl", seconds=seconds,
         cards=card_line().splitlines())


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated subset of "
                    f"{','.join(PHASES + EXTRA_PHASES)} (default: all but "
                    f"{','.join(EXTRA_PHASES)}; the kernels line is printed "
                    "only when all the default phases run)")
    # the durability phase's crash children (see crash_child)
    ap.add_argument("--crash-child", help=argparse.SUPPRESS)
    ap.add_argument("--crash-point", help=argparse.SUPPRESS)
    ap.add_argument("--crash-op", type=int, help=argparse.SUPPRESS)
    # the distributed phase's gloo ranks (see dist_child)
    ap.add_argument("--dist-child", help=argparse.SUPPRESS)
    ap.add_argument("--dist-rank", type=int, help=argparse.SUPPRESS)
    # the sharded phase's gloo ranks (see sharded_child)
    ap.add_argument("--sharded-child", help=argparse.SUPPRESS)
    ap.add_argument("--sharded-rank", type=int, help=argparse.SUPPRESS)
    # the four_cards phase's NCCL ranks (see four_cards_child)
    ap.add_argument("--four-child", help=argparse.SUPPRESS)
    ap.add_argument("--four-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--four-init", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on the "
                 "card")
    if args.crash_child:
        crash_child(args)
    if args.dist_child:
        dist_child(args)
    if args.sharded_child:
        sharded_child(args)
    if args.four_child:
        four_cards_child(args)
    only = args.only.split(",")
    if set(only) - set(PHASES + EXTRA_PHASES):
        sys.exit("chip_smoke: unknown phases "
                 f"{set(only) - set(PHASES + EXTRA_PHASES)}")
    if "four_cards" in only and torch.cuda.device_count() < FOUR:
        sys.exit(f"chip_smoke: four_cards needs {FOUR} cards; this machine "
                 f"has {torch.cuda.device_count()}")
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
        l2_rows = phase_kernel(gen, dev)
        l2 = l2_rows["capacity"]
        pq_rows = phase_kernel_pq(gen, dev)
        pq = pq_rows["round"]
        rows = phase_kernel_rows(gen, dev)
        topk, topk_launches = phase_kernel_topk_merge(gen, dev)
        e_in = phase_kernel_e_in(gen, dev)
    if "parity" in only:
        phase_parity(gen, dev, sp)
        phase_tiered_parity(gen, dev, sp)
        phase_filtered_parity(gen, dev, sp)
    if "write_parity" in only:
        phase_write_parity_device(gen, dev, sp)
        phase_write_parity_tiered(gen, dev, sp)
    if "durability" in only:
        phase_durability(gen, dev, args.seed)
    main_kept, tiered_kept, part_state = {}, {}, None
    if "main" in only:
        l2_launches = phase_main(gen, dev, args.seed, keep=main_kept)
    if "tiered" in only:
        (pq_launches, row_launches), (pq_filtered, row_filtered) = \
            phase_tiered_main(gen, dev, args.seed, keep=tiered_kept)
    if "consolidation" in only:
        phase_tiered_consolidation(gen, dev, args.seed)
    if "partitioned" in only:
        l2_build_launches, l2_build, part_state = phase_partitioned(
            gen, dev, args.seed, main=main_kept or None)
    if "distributed" in only:
        phase_distributed(gen, dev, args.seed, main=main_kept or None,
                          state=part_state)
    if "baselines" in only:
        phase_baselines(gen, dev)
    if "calibrate" in only:
        phase_calibrate(dev, {name: kept["modeled_us_per_access"]
                              for name, kept in (("main", main_kept),
                                                 ("tiered", tiered_kept))
                              if kept})
    if "serve" in only:
        l2_rag_launches = phase_serve(dev, args.seed)
    if "families" in only:
        phase_families(dev, args.seed)
    if "train" in only:
        phase_train(dev, args.seed)
    if "launch" in only:
        l2_launch_launches, l2_msturing = phase_launch(dev, args.seed)
    if "sharded" in only:
        phase_sharded(dev, args.seed)
    if "four_cards" in only:
        phase_four_cards(args.seed)
    emit("phases", ran=only, seconds=time.perf_counter() - t_run)

    if only == list(PHASES):
        src = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
        scan = {f"{k}_scan_{c}": pq_rows[f"scan_{c}"][k]
                for c in (32_768, 131_072)
                for k in ("ms", "plain_ms", "bound_ms", "call_peak_bytes")}
        kernels = [
            dict(name="l2_gather", replaces="src/repro/kernels/l2_gather/"
                 "kernel.py:54", launches=l2_launches, row=l2,
                 extra=dict(launches_build=l2_build_launches,
                            launches_rag=l2_rag_launches,
                            launches_launch=l2_launch_launches,
                            **{f"{k}_{shape}": row[k]
                               for shape, row in (("build", l2_build),
                                                  ("rag", l2_rows["rag"]),
                                                  ("msturing", l2_msturing))
                               for k in ("ms", "plain_ms", "bound_ms",
                                         "max_abs_err")})),
            dict(name="pq_adc", replaces="src/repro/kernels/pq_adc/"
                 "kernel.py:74", launches=pq_launches, row=pq,
                 extra=dict(launches_filtered=pq_filtered, **scan)),
            dict(name="row_gather", replaces="src/repro/kernels/row_gather/"
                 "kernel.py:57", launches=row_launches, row=rows,
                 extra=dict(launches_filtered=row_filtered)),
            dict(name="topk_merge", replaces="src/repro/kernels/topk_merge/"
                 "kernel.py:73", launches=topk_launches, row=topk,
                 path="none: no caller in the engine, as in the reference; "
                 "launches are its kernel phase's"),
            dict(name="e_in_count", replaces="none: build.compute_e_in, a "
                 "scatter-add in the reference (src/repro/core/build.py:95)",
                 launches=main_kept["e_in_count_launches"], row=e_in,
                 path="the main phase's write-stream inserts")]
        print(json.dumps({"kernels": [{
            "name": k["name"], "route": "cuda",
            "source": src.format(k["name"]), "replaces": k["replaces"],
            "launches": k["launches"],
            "max_abs_err": k["row"]["max_abs_err"], "ms": k["row"]["ms"],
            "plain_ms": k["row"]["plain_ms"],
            "bound_ms": k["row"]["bound_ms"],
            "bound_by": k["row"]["bound_by"], "launch_floor_ms": floor_ms,
            "library_ms": k["row"].get("library_ms"), "checked": True,
            **({"path": k["path"]} if "path" in k else {}),
            **k.get("extra", {})}
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
