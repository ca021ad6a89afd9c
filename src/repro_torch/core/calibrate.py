"""Cost-model calibration for the WAVP gain function (paper §4.3; twin of
``repro.core.calibrate``).

gain(x) = λ_x · (T_CPU − T_GPU) − T_transfer, θ = T_transfer/(T_CPU − T_GPU).

``measure()`` times the three costs on a device: a gather-distance from
a small table (the bandwidth tier), the same from a table 16 times as
large read at a stride of 16 (the capacity tier), and a host-to-device
copy of the small table from pageable host memory. The gather-distance
goes through ``ops.gather_l2``, so on the card it is the ``l2_gather``
kernel. The reference's other source, ``v5e_constants``, holds a TPU
v5e's bandwidths and has no counterpart here: the engine's modeled
per-access time comes from ``measure()`` on the engine's own device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.kernels.ops import gather_l2


@dataclass(frozen=True)
class CostModel:
    t_fast: float      # per-vector distance time on the bandwidth tier (s)
    t_slow: float      # per-vector distance time on the capacity tier (s)
    t_transfer: float  # per-vector transfer cost, amortized over batch (s)
    batch: int = 2048  # paper's transfer amortization batch

    @property
    def theta(self) -> float:
        denom = max(self.t_slow - self.t_fast, 1e-12)
        return self.t_transfer / denom


def _seconds(fn, reps, device):
    """Mean seconds of one call of ``fn`` over ``reps`` calls after a
    warm-up: CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def measure(dim: int = 64, n: int = 4096, reps: int = 5,
            device="cuda") -> CostModel:
    """Microbenchmark ``device``: distance compute from a small 'cache'
    table vs the big table, plus the host->device copy. Per-vector
    seconds; ``t_slow`` is kept at least 1.01 ``t_fast``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    small = torch.randn(n, dim, generator=gen, device=device)
    big = torch.randn(16 * n, dim, generator=gen, device=device)
    q = torch.randn(1, dim, generator=gen, device=device)
    idx = torch.randint(0, n, (1, n), generator=gen, device=device,
                        dtype=torch.int32)
    idx_big = idx * 16
    t_fast = _seconds(lambda: gather_l2(small, idx, q), reps, device) / n
    t_slow = _seconds(lambda: gather_l2(big, idx_big, q), reps, device) / n
    host = small.cpu().numpy()
    # torch.tensor copies from the pageable array, on the CPU as well
    t_transfer = _seconds(lambda: torch.tensor(host, device=device), reps,
                          device) / n
    return CostModel(t_fast, max(t_slow, t_fast * 1.01), t_transfer)
