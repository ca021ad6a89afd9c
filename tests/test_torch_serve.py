"""The port's LM serving engine and RAG pipeline against the reference on
the CPU. Token ids must be equal at fp32 (both engines take the argmax
over the padded vocabulary; ``straggler_factor=inf`` so that wall time
cannot re-dispatch a tick). Retrieval ids are not compared with the
reference's: the device arm draws its entries with ``jax.random``
(ROADMAP C)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import load_smoke_config as j_smoke
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.types import SearchParams as JSearchParams
from repro.models import model as JM
from repro.serve import engine as JS
from repro.serve import rag as JR
from repro_torch import convert
from repro_torch.configs.base import load_smoke_config
from repro_torch.core.engine import EngineConfig
from repro_torch.core.search import brute_force_topk
from repro_torch.core.types import SearchParams
from repro_torch.models import model as TM
from repro_torch.serve import engine as TS
from repro_torch.serve import rag as TR

KEY = jax.random.PRNGKey(0)


def ported_params(jp):
    return convert.model_params_from_arrays(jax.tree.map(np.asarray, jp),
                                            "cpu")


def serve(mod, cfg, params, prompts, max_new, **kw):
    eng = mod.ServeEngine(cfg, params, straggler_factor=float("inf"), **kw)
    for i, p in enumerate(prompts):
        eng.submit(mod.Request(rid=i, prompt=p, max_new=max_new))
    ticks = eng.run_until_drained()
    return ticks, {r.rid: r.tokens for r in eng.completed}


@pytest.mark.parametrize("arch", ["smollm_135m", "qwen3_0p6b",
                                  "granite_moe_1b", "grok1_314b",
                                  "falcon_mamba_7b", "hymba_1p5b",
                                  "internvl2_2b", "whisper_medium"])
def test_token_ids_equal_the_reference(arch):
    """Seven requests of mixed prompt lengths over three slots: lanes are
    refilled at different positions, and one request outgrows max_len so
    its lane keeps writing the last slot. Every family serves tokens
    alone: the vlm without patches, the enc-dec against an empty memory
    (``enc_len`` 0), as the reference's engine does."""
    cfg = j_smoke(arch).replace(dtype="float32")
    jp = JM.init_params(cfg, KEY)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (4, 9, 2, 6, 11, 3, 5)]
    want = serve(JS, cfg, jp, prompts, 6, slots=3, max_len=12)
    got = serve(TS, load_smoke_config(arch).replace(dtype="float32"),
                ported_params(jp), prompts, 6, slots=3, max_len=12,
                device="cpu")
    assert got == want
    assert len(got[1]) == 7 and all(len(t) == 6 for t in got[1].values())


def logged_serve(mod, cfg, params, prompts, max_new, monkeypatch, **kw):
    """``serve`` on one slot, recording each tick's logits [V]."""
    logs = []
    if mod is TS:
        step = TM.decode_step
        monkeypatch.setattr(TM, "decode_step", lambda *a: (
            lambda out: (logs.append(out[0][0, 0].numpy().copy()), out)[1])(
                step(*a)))
        serve(mod, cfg, params, prompts, max_new, slots=1, device="cpu",
              **kw)
        return np.stack(logs)
    eng = mod.ServeEngine(cfg, params, slots=1,
                          straggler_factor=float("inf"), **kw)
    dec = eng._decode
    eng._decode = lambda *a: (lambda out: (
        logs.append(np.asarray(out[0][0, 0])), out)[1])(dec(*a))
    for i, p in enumerate(prompts):
        eng.submit(mod.Request(rid=i, prompt=p, max_new=max_new))
    eng.run_until_drained()
    return np.stack(logs)


@pytest.mark.parametrize("arch,gap", [("falcon_mamba_7b", 1e-4),
                                      ("hymba_1p5b", 0.1)])
def test_reused_slot_keeps_the_state_as_the_reference_does(arch, gap,
                                                           monkeypatch):
    """The reference's ``_admit`` resets only ``lane_len``: a reused slot
    keeps the last request's SSM state (``h``, ``conv``) and, in the
    hybrid, its window ring (``kw``, ``vw``, ``wpos``), which the ring's
    ``wpos >= 0`` mask then attends. So one slot serving the same 6-token
    prompt twice gives the second request other logits than the first:
    on these inputs, in fp32, the first ticks differ by 8.9e-4
    (falcon-mamba's smoke config) and 0.50 (hymba's, whose greedy tokens
    differ too) in both packages. The port copies that: its logits equal
    the reference's tick by tick."""
    cfg = j_smoke(arch).replace(dtype="float32")
    jp = JM.init_params(cfg, KEY)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 6).astype(
        np.int32)
    n = len(prompt) + 4 - 1                   # ticks a request takes
    want = logged_serve(JS, cfg, jp, [prompt, prompt], 4, monkeypatch,
                        max_len=32)
    got = logged_serve(TS, load_smoke_config(arch).replace(dtype="float32"),
                       ported_params(jp), [prompt, prompt], 4, monkeypatch,
                       max_len=32)
    assert got.shape == want.shape == (2 * n, cfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for logs in (got, want):
        assert np.abs(logs[n] - logs[0]).max() > gap


def test_serve_engine_continuous_batching():
    """The reference's continuous-batching test, on the port."""
    cfg = load_smoke_config("smollm_135m")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    eng = TS.ServeEngine(cfg, params, slots=3, max_len=48, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(7):
        eng.submit(TS.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, size=4).astype(np.int32), max_new=3))
    eng.run_until_drained()
    assert len(eng.completed) == 7
    assert all(len(r.tokens) == 3 for r in eng.completed)
    assert eng.params["layers"]["attn"]["wq"].dtype == torch.bfloat16


def test_serve_straggler_consecutive_detection():
    """The reference's regression test: both of two consecutive stragglers
    are flagged and neither moves the EWMA."""
    eng = object.__new__(TS.ServeEngine)
    eng.straggler_factor = 8.0
    eng.tick_ewma = None
    eng.stragglers = 0
    assert not eng._observe_tick(0.01)    # seeds the EWMA
    assert eng._observe_tick(0.2)         # straggler #1
    assert eng._observe_tick(0.2)         # straggler #2
    assert eng.stragglers == 2
    assert eng.tick_ewma == pytest.approx(0.01)


def test_straggler_redispatches_the_slot_batch():
    cfg = load_smoke_config("smollm_135m")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    eng = TS.ServeEngine(cfg, params, slots=2, max_len=16, device="cpu",
                         straggler_factor=8.0)
    for i in range(2):
        eng.submit(TS.Request(rid=i, prompt=np.arange(3, dtype=np.int32),
                              max_new=2))
    eng.tick_ewma = 1e-12                 # every tick is a straggler
    eng.tick()
    assert eng.stragglers == 1 and all(r is None for r in eng.active)
    assert eng.admit_q.qsize() == 2
    eng.straggler_factor = float("inf")
    eng.run_until_drained()
    assert sorted(r.rid for r in eng.completed) == [0, 1]
    assert all(r.retries == 1 and len(r.tokens) == 2
               for r in eng.completed)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_smoke_config("smollm_135m")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineConfig(degree=8)            # what RAGPipeline is given


# ---------------------------------------------------------------------------
# RAG
# ---------------------------------------------------------------------------

def index_cfgs():
    kw = dict(degree=8, cache_slots=128, capacity=2048)
    return (JEngineConfig(search=JSearchParams(k=4, pool=32, max_iters=48),
                          **kw),
            EngineConfig(search=SearchParams(k=4, pool=32, max_iters=48),
                         device="cpu", **kw))


@pytest.fixture(scope="module")
def rags():
    cfg = j_smoke("qwen3_0p6b")
    jp = JM.init_params(cfg, KEY)
    jcfg, tcfg = index_cfgs()
    ref = JR.RAGPipeline(cfg, jp, jcfg)
    port = TR.RAGPipeline(load_smoke_config("qwen3_0p6b"),
                          ported_params(jp), tcfg)
    yield ref, port
    port.index.close()


def test_embed_and_seed_rows_equal_the_reference(rags):
    ref, port = rags
    tok = np.random.default_rng(1).integers(
        0, ref.cfg.vocab, (5, 12)).astype(np.int32)
    got, want = port.embed(tok), ref.embed(tok)
    assert got.dtype == np.float32 and got.shape == (5, ref.cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    n = 256                               # max(256, degree * 4) seed rows
    np.testing.assert_array_equal(
        port.index.state.graph.vectors[:n].numpy(),
        np.asarray(ref.index.state.graph.vectors[:n]))
    assert int(port.index.state.graph.n) == int(ref.index.state.graph.n) == n


def test_rag_freshness():
    """The reference's freshness scenario, on the port with the
    reference's weights: 40 documents ingested in one batch are in the
    index at once, retrieval returns them, an augmented prompt carries
    their tokens, and eviction removes them from retrieval.

    The reference asserts that document 7 retrieves itself. That hangs
    on the entry draw: one insert batch links its documents only to the
    256 N(0, 1) seed rows, not to each other, so a document is reachable
    only through a seed row's reverse edge. Over engine seeds 0-7 the
    40 documents retrieve themselves 18.1% of the time in the reference
    and 18.8% in the port, and document 7 does so at 4 of 8 seeds in the
    reference (seed 0 among them) and 1 of 8 in the port
    (``scripts/reference_cpu_checks.py fresh``; ROADMAP C)."""
    cfg = load_smoke_config("qwen3_0p6b")
    params = ported_params(JM.init_params(j_smoke("qwen3_0p6b"), KEY))
    rag = TR.RAGPipeline(cfg, params, index_cfgs()[1])
    try:
        rng = np.random.default_rng(0)
        docs = [TR.Doc(i, rng.integers(0, cfg.vocab, size=12).astype(
            np.int32)) for i in range(40)]
        toks = np.stack([d.tokens for d in docs])
        ids = rag.ingest(docs)
        g = rag.index.state.graph
        np.testing.assert_array_equal(g.vectors[ids].numpy(),
                                      rag.embed(toks))
        assert bool(g.alive[ids].all())
        got = rag.retrieve_batch(toks, k=4)
        assert all(d.doc_id in range(40) for row in got for d in row)
        assert any(docs[i] in row for i, row in enumerate(got))
        aug = rag.augment(docs[7].tokens, k=2, budget=16)
        assert len(docs[7].tokens) < len(aug) <= 16 + len(docs[7].tokens)
        np.testing.assert_array_equal(aug[-12:], docs[7].tokens)
        rag.evict(ids)
        assert not bool(rag.index.state.graph.alive[ids].any())
        assert rag.retrieve(docs[7].tokens, k=4) == []
        assert rag.retrieve_batch(toks, k=4) == [[]] * 40
    finally:
        rag.index.close()


def test_retrieve_many_equals_retrieve_batch():
    """The coalesced path returns what one batch at a time does. The
    documents arrive in ten ingests of 8, so each links to the earlier
    ones, and a pool of 64 over the 336 rows reaches the exact top 4 from
    any entries (held against brute force): the comparison then does not
    hang on how the coalescer groups the batches into dispatches."""
    cfg = load_smoke_config("smollm_135m")
    params = TM.init_params(cfg, torch.Generator().manual_seed(2))
    rag = TR.RAGPipeline(cfg, params, EngineConfig(
        degree=16, cache_slots=128, capacity=2048, device="cpu",
        search=SearchParams(k=4, pool=64, max_iters=48)))
    try:
        rng = np.random.default_rng(3)
        docs = [TR.Doc(i, rng.integers(0, cfg.vocab, size=10).astype(
            np.int32)) for i in range(80)]
        for s in range(0, 80, 8):
            rag.ingest(docs[s:s + 8])
        batches = [np.stack([d.tokens for d in docs[s:s + 8]])
                   for s in range(0, 48, 8)]
        many = rag.retrieve_many(batches, k=4)
        one = [rag.retrieve_batch(b, k=4) for b in batches]
        ids = [[[d.doc_id for d in row] for row in b] for b in many]
        assert ids == [[[d.doc_id for d in row] for row in b] for b in one]
        truth, _ = brute_force_topk(rag.index.state.graph, torch.as_tensor(
            rag.embed(np.concatenate(batches))), 4)
        assert sum(ids, []) == [[rag.docs[int(i)].doc_id for i in row]
                                for row in truth]
    finally:
        rag.index.close()
