"""The port's cost model (``repro_torch.core.calibrate``) and the
engine's ``modeled_us_per_access`` against the reference's.

The reference models per-access time with a TPU v5e's constants; the
port measures its own device. With both sources patched to one fixed
``CostModel``, the same requests must give the same modeled time.
"""
import numpy as np
import pytest

from repro.core import calibrate as JCal
from repro.core import engine as JE
from repro.core.types import SearchParams as JaxSearchParams
from repro_torch.core import calibrate as TCal
from repro_torch.core import engine as TE
from repro_torch.core.types import SearchParams

FIXED = (2.5e-9, 7.25e-8, 3.0e-7)


@pytest.mark.parametrize("t", [FIXED, (1e-9, 1e-9, 4e-9), (3e-8, 1e-8, 0.0)],
                         ids=["fixed", "equal_tiers", "slow_below_fast"])
def test_cost_model_and_theta_match(t):
    want, got = JCal.CostModel(*t), TCal.CostModel(*t)
    assert got == TCal.CostModel(*t) and got.batch == want.batch == 2048
    assert got.theta == want.theta


def test_measure_on_the_cpu():
    cm = TCal.measure(dim=16, n=512, reps=3, device="cpu")
    assert cm.t_fast > 0 and cm.t_transfer > 0
    assert cm.t_slow >= 1.01 * cm.t_fast
    assert cm.theta == cm.t_transfer / (cm.t_slow - cm.t_fast)


def _fixed_sources(monkeypatch):
    """Both packages' cost source returns CostModel(*FIXED); returns the
    list of (dim, device) the port measured at."""
    calls = []

    def measure(dim, n=4096, reps=5, device="cuda"):
        calls.append((dim, str(device)))
        return TCal.CostModel(*FIXED)
    monkeypatch.setattr(TCal, "measure", measure)
    monkeypatch.setattr(JCal, "v5e_constants",
                        lambda dim, dtype_bytes=4: JCal.CostModel(*FIXED))
    return calls


def test_modeled_us_per_access_matches_the_reference(monkeypatch, tmp_path):
    """Three-tier engines (numpy entry draws, so both take the same
    path): the same requests, the same counters and the same modeled
    time; the port measures once, at the index's dim, on its device."""
    calls = _fixed_sources(monkeypatch)
    rng = np.random.default_rng(2)
    vecs = rng.integers(-6, 7, (400, 16)).astype(np.float32)
    q = rng.integers(-6, 7, (24, 16)).astype(np.float32)
    kw = dict(degree=8, cache_slots=48, capacity=1024, disk_capacity=1024,
              host_window=100, seed=3, coalesce=False, prefetch=False,
              spec_rank="flam")
    je = JE.SVFusionEngine(vecs, JE.EngineConfig(
        disk_path=str(tmp_path / "j"),
        search=JaxSearchParams(k=8, pool=32, max_iters=48), **kw))
    te = TE.SVFusionEngine(vecs, TE.EngineConfig(
        disk_path=str(tmp_path / "t"),
        search=SearchParams(k=8, pool=32, max_iters=48), device="cpu", **kw))
    try:
        for s in (slice(0, 10), slice(10, 24)):
            je.search(q[s])
            te.search(q[s])
        sj, st = je.stats(), te.stats()
        for k in ("accesses", "hits", "cpu_computed", "transfers"):
            assert st[k] == sj[k], k
        assert sj["accesses"] > 0
        assert st["modeled_us_per_access"] == sj["modeled_us_per_access"]
        te.stats()
        assert calls == [(16, "cpu")]
    finally:
        je.close()
        te.close()


def test_device_mode_modeled_us_per_access(monkeypatch):
    """Device mode: the reference's formula over the port's own counters
    (its entry draws are torch's, so its counters are its own)."""
    _fixed_sources(monkeypatch)
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(300, 12)).astype(np.float32)
    eng = TE.SVFusionEngine(vecs, TE.EngineConfig(
        degree=8, cache_slots=32, capacity=512, coalesce=False,
        search=SearchParams(k=5, pool=16, max_iters=16), device="cpu"))
    try:
        eng.search(rng.normal(size=(9, 12)).astype(np.float32))
        st = eng.stats()
        t_fast, t_slow, t_transfer = FIXED
        want = (st["hits"] * t_fast + st["cpu_computed"] * t_slow
                + st["transfers"] * t_transfer) / st["accesses"] * 1e6
        assert st["accesses"] > 0
        assert st["modeled_us_per_access"] == want
    finally:
        eng.close()
