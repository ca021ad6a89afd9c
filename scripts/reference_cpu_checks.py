#!/usr/bin/env python3
"""Checks of the JAX reference on the CPU that explain what the ``serve``
and ``families`` phases of ``chip_smoke.py`` hold and what they only
report.

  prefill  SmolLM-135M at its published width in bf16 (params from
           PRNGKey(0), 2 x 129 tokens): the reference's own
           prefill/decode check (tests/test_models.py), prefill over 128
           tokens and one decode step against forward_lm, with the
           reference's bound (rtol 2e-2, atol 1e-2); then the port on the
           same params on the CPU.
  families the same check for granite-moe-1b (dense oracle),
           falcon-mamba-7b, hymba-1.5b, internvl2-2b and whisper-medium
           at their published depth and token, patch and frame counts
           (2 x 129 tokens; hymba 2 x 1,281; 256 patches; 1,500 frames)
           but narrowed to d_model 512 (8 heads of 64, vocab 8,192), in
           fp32 and bf16, in the reference (jitted) and in the port.
  fresh    the reference's freshness test (tests/test_substrate.py:173)
           at engine seeds 0-7 on both packages with the reference's
           weights: whether document 7 retrieves itself, and the share
           of the 40 documents that do.
  rag      the reference's RAGPipeline and the port's, on the CPU, over
           chip_smoke.py's topic corpus and RAG index configuration, cut
           to the first ``--topics`` topics of the 1,024-topic layout
           with 128 documents each: recall@10 of 512 fresh prompts
           against brute force, self-retrieval of 512 ingested
           documents, and the share of documents no graph row links to.

Usage: PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_cpu_checks.py
       {prefill,families,fresh,rag} [--topics T]
It imports both packages, as the tests do; the port itself imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402
from repro.configs.base import load_config  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core import search as JSearch  # noqa: E402
from repro.core.types import SearchParams as JSearchParams  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import rag as JR  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import load_config as t_load  # noqa: E402
from repro_torch.core.search import brute_force_topk  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import rag as TR  # noqa: E402


def bound_report(full, pre, dec, last=128):
    out = {}
    for a, b, what in ((full[:, last - 1], pre[:, 0], "prefill"),
                       (full[:, last], dec[:, 0], "decode")):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        err = np.abs(a - b)
        out[what] = dict(max_abs_err=float(err.max()), over_reference_bound=int(
            (err > 1e-2 + 2e-2 * np.abs(b)).sum()), logits=int(err.size))
    return out


def check_prefill():
    cfg = load_config("smollm_135m")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (2, 129)).astype(
        np.int32)
    f32 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))  # noqa
    full = f32(JM.forward_lm(cfg, jp, jnp.asarray(tok)))
    pre, cache = JM.prefill(cfg, jp, {"tokens": jnp.asarray(tok[:, :128])},
                            256)
    dec, _ = JM.decode_step(cfg, jp, cache, jnp.asarray(tok[:, 128:]))
    print(json.dumps({"check": "prefill", "package": "reference (JAX, CPU)",
                      "dtype": cfg.dtype,
                      **bound_report(full, f32(pre), f32(dec))}), flush=True)
    tp = convert.model_params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    tc = t_load("smollm_135m")
    t = torch.as_tensor(tok)
    full = TM.forward_lm(tc, tp, t).float().numpy()
    pre, cache = TM.prefill(tc, tp, {"tokens": t[:, :128]}, 256)
    dec, _ = TM.decode_step(tc, tp, cache, t[:, 128:])
    print(json.dumps({"check": "prefill", "package": "port (torch, CPU)",
                      "dtype": tc.dtype, **bound_report(
                          full, pre.float().numpy(), dec.float().numpy())}),
          flush=True)


NARROW = dict(d_model=512, n_heads=8, d_head=64, vocab=8192,
              remat_policy="none")
FAMILY_WIDTHS = {
    "granite_moe_1b": dict(n_kv_heads=4, moe_impl="dense"),
    "falcon_mamba_7b": dict(n_heads=0, d_head=0),
    "hymba_1p5b": dict(n_kv_heads=2, d_ff=1536),
    "internvl2_2b": dict(n_kv_heads=4, d_ff=2048),
    "whisper_medium": dict(n_kv_heads=8, d_ff=2048)}


def check_families(B=2):
    f32 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))  # noqa
    for arch, kw in FAMILY_WIDTHS.items():
        jc = load_config(arch).replace(**{**NARROW, **kw})
        S = 1280 if arch == "hymba_1p5b" else 128
        rng = np.random.default_rng(0)
        tok = rng.integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
        extra = {}
        if jc.family == "vlm":
            extra["patches"] = rng.normal(size=(B, jc.n_patches, jc.d_model))
        if jc.family == "encdec":
            extra["frames"] = rng.normal(size=(B, 1500, jc.d_model))
        extra = {k: v.astype(np.float32) for k, v in extra.items()}
        last = S + (jc.n_patches if jc.family == "vlm" else 0)
        max_len = 1536 if arch in ("hymba_1p5b", "whisper_medium") else 512
        jp = JM.init_params(jc, jax.random.PRNGKey(0))
        tp = convert.model_params_from_arrays(jax.tree.map(np.asarray, jp),
                                              "cpu")
        for dtype in ("float32", "bfloat16"):
            c = jc.replace(dtype=dtype)
            je = {k: jnp.asarray(v) for k, v in extra.items()}
            if c.family == "encdec":
                full = jax.jit(lambda p, f, t: JM.forward_encdec(c, p, f, t))(
                    jp, je["frames"], jnp.asarray(tok))
            else:
                full = jax.jit(lambda p, t, x: JM.forward_lm(c, p, t, x))(
                    jp, jnp.asarray(tok), je.get("patches"))
            pre, cache = jax.jit(lambda p, b: JM.prefill(c, p, b, max_len))(
                jp, {"tokens": jnp.asarray(tok[:, :S]), **je})
            dec, _ = jax.jit(lambda p, k, t: JM.decode_step(c, p, k, t))(
                jp, cache, jnp.asarray(tok[:, S:]))
            print(json.dumps({"check": "families", "arch": arch,
                              "package": "reference (JAX, CPU)",
                              "dtype": dtype, **bound_report(
                                  f32(full), f32(pre), f32(dec), last)}),
                  flush=True)
            tcfg = t_load(arch).replace(**{**NARROW, **kw}, dtype=dtype)
            te = {k: torch.as_tensor(v) for k, v in extra.items()}
            t = torch.as_tensor(tok)
            full = CS.lm_forward(tcfg, tp, t, te).float().numpy()
            pre, cache = TM.prefill(tcfg, tp, {"tokens": t[:, :S], **te},
                                    max_len)
            dec, _ = TM.decode_step(tcfg, tp, cache, t[:, S:])
            print(json.dumps({"check": "families", "arch": arch,
                              "package": "port (torch, CPU)",
                              "dtype": dtype, **bound_report(
                                  full, pre.float().numpy(),
                                  dec.float().numpy(), last)}), flush=True)


def check_fresh(seeds=range(8)):
    from repro.configs.base import load_smoke_config
    from repro.core.engine import EngineConfig as JEngineConfig
    from repro_torch.configs.base import load_smoke_config as t_smoke
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.types import SearchParams
    cfg = load_smoke_config("qwen3_0p6b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = convert.model_params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    docs = rng.integers(0, cfg.vocab, (40, 12)).astype(np.int32)
    kw = dict(degree=8, cache_slots=128, capacity=2048)
    for package in ("reference", "port"):
        doc7, share = [], []
        for seed in seeds:
            if package == "reference":
                rag = JR.RAGPipeline(cfg, jp, JEngineConfig(
                    search=JSearchParams(k=4, pool=32, max_iters=48),
                    seed=seed, **kw))
                ids = rag.ingest([JR.Doc(i, t) for i, t in enumerate(docs)])
            else:
                rag = TR.RAGPipeline(t_smoke("qwen3_0p6b"), tp, EngineConfig(
                    search=SearchParams(k=4, pool=32, max_iters=48),
                    seed=seed, device="cpu", **kw))
                ids = rag.ingest([TR.Doc(i, t) for i, t in enumerate(docs)])
            got = rag.retrieve(docs[7], k=4)
            doc7.append(any(np.array_equal(d.tokens, docs[7]) for d in got))
            found, _ = rag.index.search(rag.embed(docs))
            share.append(float((found == ids[:, None]).any(1).mean()))
            rag.index.close()
        print(json.dumps({"check": "fresh", "package": package,
                          "seeds": list(seeds), "doc7_found": doc7,
                          "self_share_mean": float(np.mean(share))}),
              flush=True)


def check_rag(topics, per_topic=128, queries=512):
    cfg = load_config("smollm_135m")
    embed = (torch.randn(cfg.padded_vocab, cfg.d_model,
                         generator=torch.Generator().manual_seed(0))
             * 0.02).numpy()
    tcfg = CS.rag_index_config("cpu", 0)
    n = topics * per_topic
    for package in ("reference", "port"):
        rng = np.random.default_rng(0)
        draw = CS.topic_corpus(rng, cfg.vocab, topics=topics,
                               stride=cfg.vocab // CS.RAG_TOPICS)
        docs = draw(n, CS.RAG_DOC_LEN)
        if package == "reference":
            icfg = JE.EngineConfig(
                degree=tcfg.degree, capacity=tcfg.capacity,
                cache_slots=tcfg.cache_slots, seed=tcfg.seed,
                search=JSearchParams(*tcfg.search))
            rag = JR.RAGPipeline(cfg, {"tok": {"embed": jnp.asarray(embed)}},
                                 icfg)
        else:
            rag = TR.RAGPipeline(t_load("smollm_135m"), {"tok": {
                "embed": torch.as_tensor(embed)}}, tcfg)
        t0 = time.perf_counter()
        ids = np.concatenate([
            rag.ingest([(JR if package == "reference" else TR).Doc(i, docs[i])
                        for i in range(s, min(s + CS.RAG_INGEST, n))])
            for s in range(0, n, CS.RAG_INGEST)])
        ingest_s = time.perf_counter() - t0
        q = rag.embed(draw(queries, CS.RAG_DOC_LEN)[:, :32])
        found, _ = rag.index.search(q)
        pick = rng.choice(n, queries, replace=False)
        own, _ = rag.index.search(rag.embed(docs[pick]))
        g = rag.index.state.graph
        if package == "reference":
            truth = np.asarray(JSearch.brute_force_topk(g, jnp.asarray(q),
                                                        10)[0])
        else:
            truth = brute_force_topk(g, torch.as_tensor(q), 10)[0].numpy()
        e_in = np.asarray(g.e_in)[ids]
        rag.index.close()
        recall = float(np.mean([len(set(f) & set(t)) / 10
                                for f, t in zip(found, truth)]))
        print(json.dumps({
            "check": "rag", "package": package, "topics": topics,
            "docs": n, "ingest_s": ingest_s, "recall_at_10": recall,
            "self_retrieval": float((own[:, 0] == ids[pick]).mean()),
            "docs_without_in_edges": float((e_in == 0).mean())}),
            flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("check", choices=("prefill", "families", "fresh",
                                      "rag"))
    ap.add_argument("--topics", type=int, default=256)
    args = ap.parse_args()
    if args.check == "prefill":
        check_prefill()
    elif args.check == "families":
        check_families()
    elif args.check == "fresh":
        check_fresh()
    else:
        check_rag(args.topics)


if __name__ == "__main__":
    main()
