"""Retrieval-augmented serving: the paper's motivating workload (twin of
``repro.serve.rag``).

The LM produces query embeddings (mean-pooled bf16 token embeddings, the
standard cheap dual-encoder stand-in); SVFusion retrieves fresh context
ids; retrieved token chunks are prepended to the prompt. New documents
stream into the index online, so retrieval reflects inserts made seconds
earlier (index freshness, paper §1). The model and the index live on
``index_cfg.device``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig, SVFusionEngine
from repro_torch.models import model as Mdl


@dataclass
class Doc:
    doc_id: int
    tokens: np.ndarray      # [T] int32


class RAGPipeline:
    def __init__(self, cfg, params, index_cfg: EngineConfig, dim=None):
        self.cfg = cfg
        self.device = torch.device(index_cfg.device)
        self.params = Mdl.cast_params(cfg, params, self.device)
        self.dim = dim or cfg.d_model
        seed_vecs = np.random.default_rng(0).normal(
            size=(max(256, index_cfg.degree * 4), self.dim)).astype(np.float32)
        self.index = SVFusionEngine(seed_vecs, index_cfg)
        self.docs: dict[int, Doc] = {}

    def embed(self, tokens: np.ndarray) -> np.ndarray:
        """[B, T] tokens -> [B, dim] fp32: the mean of their bf16
        embeddings, taken in fp32."""
        t = torch.as_tensor(np.asarray(tokens, np.int32), device=self.device)
        emb = Mdl.embed_tokens(self.params["tok"], t, torch.bfloat16)
        return emb.float().mean(1).cpu().numpy()

    # ------------------------------------------------------------------
    def ingest(self, docs: list[Doc]):
        """Stream new documents into the live index."""
        toks = np.stack([d.tokens for d in docs])
        vecs = self.embed(toks)
        ids = self.index.insert(vecs)
        for i, d in zip(ids, docs):
            self.docs[int(i)] = d
        return ids

    def evict(self, ids):
        self.index.delete(np.asarray(ids))
        for i in ids:
            self.docs.pop(int(i), None)

    def retrieve(self, prompt_tokens: np.ndarray, k=4) -> list[Doc]:
        return self.retrieve_batch(prompt_tokens[None, :], k)[0]

    def _docs_of(self, ids, k) -> list[list[Doc]]:
        return [[self.docs[int(i)] for i in row[:k] if int(i) in self.docs]
                for row in ids]

    def retrieve_batch(self, prompt_tokens: np.ndarray,
                       k=4) -> list[list[Doc]]:
        """Batched retrieval for a [B, T] prompt batch: every prompt rides
        the same executor dispatches."""
        ids, _ = self.index.search(self.embed(prompt_tokens))
        return self._docs_of(ids, k)

    def retrieve_many(self, prompt_batches: list, k=4) -> list:
        """Pipelined retrieval for independently arriving prompt batches:
        all are submitted to the engine's coalescing scheduler up front,
        so batches that arrive within its window share one executor
        invocation. Returns one ``retrieve_batch``-shaped list per
        batch."""
        futs = [self.index.submit_search(self.embed(toks))
                for toks in prompt_batches]
        return [self._docs_of(fut.result()[0], k) for fut in futs]

    def augment(self, prompt_tokens: np.ndarray, k=4, budget=128):
        """Prepend retrieved chunks (truncated to the context budget)."""
        docs = self.retrieve(prompt_tokens, k)
        ctx = [d.tokens for d in docs]
        flat = np.concatenate(ctx)[:budget] if ctx else np.zeros(0, np.int32)
        return np.concatenate([flat.astype(np.int32), prompt_tokens])
