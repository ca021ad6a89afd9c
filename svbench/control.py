"""The control of the comparison: the reference put in the program's
place, computed in the nearest precision below the one the configuration
states, and driven through the same run. Its answers have to come out
as not correct; ``svbench/tests/test_svbench_control.py`` keeps it at a
test size.

``tf32``  (a configuration that states float32): queries and rows
          rounded to TF32's 10 mantissa bits, the float32 GEMM expansion
          over the rounded operands, as a TF32 tensor-core GEMM computes.
``fp8``   (a configuration that states a bfloat16 payload): rows stored
          as float8 e4m3, distances in float32 over the stored rows.

Run it on the card at a cell's own size: ``python3 svbench/control.py
--workload <cell> --seed <n> --seconds <s> --trace 0``; it prints the
run's numbers and limits as a run does, with ``correct`` expected false.
The module is the run's system under test (``build``, ``settle``,
``read_back``, as ``svbench/system.py``).
"""
from __future__ import annotations

import sys
import threading
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]
from svbench.reference.exact import full_fp32  # noqa: E402

BELOW = {"float32": "tf32", "bfloat16": "fp8"}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest value with 10 mantissa bits (ties
    away from zero), as TF32 holds it."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


class ExactControl:
    """Exact top-k search with inserts and deletes, in ``precision``; the
    same ``search``/``insert``/``delete``/``close`` entry as the engine.
    Ids are handed out in order, as the engine's are."""

    def __init__(self, vectors, capacity: int, k: int, precision: str,
                 device):
        self.k, self.precision = k, precision
        self.dev = torch.device(device)
        v = torch.as_tensor(np.asarray(vectors, np.float32), device=self.dev)
        self.rows = torch.zeros((capacity, v.shape[1]), device=self.dev)
        self.alive = torch.zeros(capacity, dtype=torch.bool, device=self.dev)
        self.n = 0
        self._lock = threading.Lock()
        self._put(v)

    def _store(self, v):
        if self.precision == "fp8":
            return v.to(torch.float8_e4m3fn).float()
        return v

    def _put(self, v):
        if self.n + len(v) > len(self.rows):
            raise ValueError(f"index full: {self.n}+{len(v)} > "
                             f"{len(self.rows)}")
        ids = torch.arange(self.n, self.n + len(v), device=self.dev)
        self.rows[ids] = self._store(v)
        self.alive[ids] = True
        self.n += len(v)
        return ids

    def search(self, queries):
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.dev)
        with self._lock:
            x, alive = self.rows[:self.n], self.alive[:self.n]
            if self.precision == "tf32":
                q, x = round_tf32(q), round_tf32(x)
            with full_fp32():
                d = ((q ** 2).sum(1, keepdim=True) - 2.0 * (q @ x.T)
                     + (x ** 2).sum(1)[None, :])
            d = d.masked_fill(~alive[None, :], float("inf"))
            dist, ids = torch.topk(d, self.k, dim=1, largest=False)
        return ids.cpu().numpy(), dist.cpu().numpy()

    def insert(self, vectors):
        v = torch.as_tensor(np.asarray(vectors, np.float32), device=self.dev)
        with self._lock:
            return self._put(v).cpu().numpy()

    def delete(self, ids):
        with self._lock:
            i = torch.as_tensor(np.asarray(ids, np.int64), device=self.dev)
            self.alive[i[(i >= 0) & (i < self.n)]] = False

    def close(self):
        pass


def build(cfg: dict, vectors, seed, device, disk_path=None):
    return ExactControl(vectors, cfg.get("capacity") or cfg["disk_capacity"],
                        cfg["search"]["k"], BELOW[cfg["precision"]], device)


def settle(target) -> None:
    pass


def read_back(cfg, target, disk_path, device, inserted, deleted):
    """The control holds no index to read back: no number."""
    target.close()
    return None


if __name__ == "__main__":
    from svbench import run
    if run._args(sys.argv[1:]).trace:
        sys.exit("svbench control: runs untraced (--trace 0)")
    sys.exit(run.main(sys.argv[1:], under_test=sys.modules[__name__]))
