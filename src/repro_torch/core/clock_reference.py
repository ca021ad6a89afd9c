"""Exact sequential clock-sweep eviction (paper Algorithm 2, lines 3-11;
a numpy copy of ``repro.core.clock_reference``, so that the port stands
without the reference).

NumPy reference used by tests as the semantics oracle for the vectorized
batched clock in cache.py. The paper's procedure: advance the hand; a slot
with ref=1 gets its bit cleared (second chance); a slot with ref=0 whose
predicted frequency equals the current minimum among ref=0 slots is the
victim.
"""
from __future__ import annotations

import numpy as np


class SequentialClock:
    def __init__(self, n_slots: int):
        self.n = n_slots
        self.hand = 0
        self.ref = np.zeros(n_slots, np.int8)
        self.occupant = np.full(n_slots, -1, np.int64)

    def access(self, slot: int):
        self.ref[slot] = 1

    def admit(self, new_id: int, f_lambda: np.ndarray) -> int:
        """Evict-and-place per Algorithm 2. f_lambda indexed by host id.
        Returns the slot used."""
        empty = np.where(self.occupant < 0)[0]
        if empty.size:
            s = int(empty[0])
            self.occupant[s] = new_id
            self.ref[s] = 1
            return s
        # min F_lambda among ref==0 occupants (recomputed as bits clear)
        for _ in range(2 * self.n + 1):
            zero = self.ref == 0
            if zero.any():
                fmin = f_lambda[self.occupant[zero]].min()
            else:
                fmin = None
            s = self.hand
            if self.ref[s] == 0 and fmin is not None \
                    and f_lambda[self.occupant[s]] == fmin:
                self.occupant[s] = new_id
                self.ref[s] = 1
                self.hand = (s + 1) % self.n
                return s
            if self.ref[s] == 1:
                self.ref[s] = 0
            self.hand = (self.hand + 1) % self.n
        raise RuntimeError("clock failed to find a victim")

    def victims_for(self, new_ids, f_lambda):
        """Admit a batch; returns evicted host ids (order of admission)."""
        evicted = []
        for nid in new_ids:
            s_prev = None
            full = (self.occupant >= 0).all()
            old = self.occupant[self.hand] if full else -1
            s = self.admit(nid, f_lambda)
            evicted.append(int(old) if full else -1)
        return evicted
