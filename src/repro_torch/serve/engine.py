"""LM serving engine: continuous batching and straggler mitigation (twin
of ``repro.serve.engine``).

Continuous batching: a fixed pool of decode slots; finished or empty
slots are refilled from the admission queue each tick, so a long
generation blocks no other request. Prompts are fed one token per tick
(prefill by decode), each lane at its own position. Straggler
mitigation: a tick slower than ``straggler_factor`` x the EWMA tick time
re-enqueues its requests for a second dispatch.

The model runs on ``device`` (the card unless the caller asks for the
CPU); the params are moved there and cast to ``cfg.dtype`` once, when
the engine is built.
"""
from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import model as Mdl


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int = 16
    submitted: float = field(default_factory=time.perf_counter)
    tokens: list = field(default_factory=list)
    done: bool = False
    finished_at: float = 0.0
    retries: int = 0


class ServeEngine:
    """Batched incremental decoding over every model family."""

    def __init__(self, cfg, params, *, slots=8, max_len=256,
                 straggler_factor=8.0, max_retries=1, device="cuda"):
        self.cfg = cfg.replace(remat_policy="none")
        self.device = resolve_device(device, "ServeEngine")
        # bf16 products accumulate in fp32, as the reference's dots do
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        self.params = Mdl.cast_params(self.cfg, params, self.device)
        self.slots = slots
        self.max_len = max_len
        self.straggler_factor = straggler_factor
        self.max_retries = max_retries
        self.admit_q: "queue.Queue[Request]" = queue.Queue()
        self.active: list[Optional[Request]] = [None] * slots
        self.completed: list[Request] = []
        self.tick_ewma = None
        self.stragglers = 0
        self.cache = Mdl.init_cache(self.cfg, slots, max_len,
                                    device=self.device)
        # per-lane positions (continuous batching): a fresh request restarts
        # its lane at position 0; stale cache beyond lane_len is never
        # unmasked because attention caps at the lane's own length
        self.lane_len = np.zeros(slots, np.int32)
        self.tokens = np.zeros((slots, 1), np.int32)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.admit_q.put(req)

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is not None:
                continue
            try:
                req = self.admit_q.get_nowait()
            except queue.Empty:
                return
            self.active[s] = req
            req._feed = list(req.prompt)
            self.lane_len[s] = 0
            self.tokens[s, 0] = req._feed.pop(0)

    def _observe_tick(self, dt) -> bool:
        """Classify a tick duration against the EWMA and fold it in.

        The straggler comparison uses the EWMA *before* this tick, and a
        flagged tick never updates the EWMA: a straggler folded into its
        own threshold inflates it, making the next straggler invisible.
        """
        ewma = self.tick_ewma
        if ewma is not None and dt > self.straggler_factor * ewma:
            self.stragglers += 1
            return True
        self.tick_ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        return False

    def tick(self):
        """One decode step for the whole slot pool. Returns #active."""
        self._admit()
        if all(r is None for r in self.active):
            return 0
        t0 = time.perf_counter()
        self.cache = dict(self.cache, len=torch.as_tensor(
            self.lane_len, device=self.device))
        logits, self.cache = Mdl.decode_step(
            self.cfg, self.params, self.cache,
            torch.as_tensor(self.tokens, device=self.device))
        active_mask = np.array([r is not None for r in self.active])
        self.lane_len = np.where(active_mask,
                                 np.minimum(self.lane_len + 1,
                                            self.max_len - 1),
                                 self.lane_len)
        # fp32 holds every bf16 value exactly: the argmax below is the
        # one over the padded vocabulary in the model's dtype
        logits = logits[:, 0].float().cpu().numpy()
        dt = time.perf_counter() - t0

        # straggler check (re-dispatch the slot batch)
        if self._observe_tick(dt):
            for s, req in enumerate(self.active):
                if req is not None and req.retries < self.max_retries:
                    req.retries += 1
                    req._feed = list(req.prompt)
                    req.tokens = []
                    self.admit_q.put(req)
                    self.active[s] = None
            return sum(r is not None for r in self.active)

        for s, req in enumerate(self.active):
            if req is None:
                continue
            if req._feed:                      # still feeding the prompt
                self.tokens[s, 0] = req._feed.pop(0)
                continue
            nxt = int(np.argmax(logits[s]))
            req.tokens.append(nxt)
            self.tokens[s, 0] = nxt
            if len(req.tokens) >= req.max_new:
                req.done = True
                req.finished_at = time.perf_counter()
                self.completed.append(req)
                self.active[s] = None
        return sum(r is not None for r in self.active)

    def run_until_drained(self, max_ticks=10_000):
        ticks = 0
        while (not self.admit_q.empty() or any(
                r is not None for r in self.active)) and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks
