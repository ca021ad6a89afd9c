"""Vectors, queries and cluster draws made from a run's seed.

``synthetic_descriptors`` is a frozen copy of ``chip_smoke.py``'s
generator of the same name (PR 24 tree, ``chip_smoke.py:1332``): the same
mixture, the same centres and projection from the same generator, and the
same draws. Two things are added and change no draw of the original:
``draw`` takes another generator (so the data, the queries and the writer
each draw from a stream of their own, in an order that thread timing
cannot change) and, for queries, the clusters to draw from.
"""
from __future__ import annotations

import math

import numpy as np
import torch

STREAMS = ("data", "queries", "writer", "sample", "zipf")


def stream_seeds(seed: int) -> dict:
    """One 63-bit seed per named stream, all derived from the run's seed
    (any whole number, negative or past 64 bits included)."""
    ss = np.random.SeedSequence(abs(int(seed)))
    out = {}
    for name, s in zip(STREAMS, ss.spawn(len(STREAMS))):
        hi, lo = (int(x) for x in s.generate_state(2, np.uint32))
        out[name] = (hi >> 1) << 32 | lo
    return out


def generator(seed: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def synthetic_descriptors(gen, n, d, dev, clusters=1024, intrinsic=16,
                          chunk=1 << 18):
    """Vectors with the low intrinsic dimension of image descriptors: a
    ``intrinsic``-dimensional mixture of ``clusters`` unit Gaussians mapped
    to ``d`` dimensions by a fixed random matrix, plus small noise. Returns
    a function drawing ``m`` rows from the same distribution. The centers
    spread as far as the components do, so the components overlap and the
    KNN graph is one connected piece, as on real descriptors; with centers
    3x further apart the graph falls into islands that 64 random entry
    points rarely reach (recall@10 0.07 at 1M).

    ``draw(m, g=None, cluster_ids=None)``: ``g`` draws from another
    generator than ``gen``; ``cluster_ids`` ([m] int64 on ``dev``) fixes
    each row's cluster instead of drawing it uniformly."""
    centers = torch.randn(clusters, intrinsic, generator=gen, device=dev)
    proj = torch.randn(d, intrinsic, generator=gen,
                       device=dev) / math.sqrt(intrinsic)

    def draw(m, g=None, cluster_ids=None):
        g = gen if g is None else g
        out = torch.empty(m, d, device=dev)
        for s in range(0, m, chunk):
            e = min(s + chunk, m)
            if cluster_ids is None:
                c = torch.randint(0, clusters, (e - s,), generator=g,
                                  device=dev)
            else:
                c = cluster_ids[s:e]
            z = centers[c] + torch.randn(e - s, intrinsic, generator=g,
                                         device=dev)
            out[s:e] = z @ proj.T + 0.05 * torch.randn(
                e - s, d, generator=g, device=dev)
        return out
    return draw


def zipf_probs(clusters: int, s: float, seed: int) -> np.ndarray:
    """Popularity of each cluster: weight 1 / rank**s, the ranks a
    permutation drawn from ``seed`` (so which clusters are hot changes
    with the seed, how hot does not)."""
    w = 1.0 / np.arange(1, clusters + 1, dtype=np.float64) ** s
    perm = np.random.default_rng(seed).permutation(clusters)
    p = np.empty(clusters)
    p[perm] = w / w.sum()
    return p


def top_share(probs: np.ndarray, frac: float) -> float:
    """Share of the draws that the hottest ``frac`` of clusters take."""
    k = max(1, int(round(len(probs) * frac)))
    return float(np.sort(probs)[::-1][:k].sum())


def query_clusters(m: int, clusters: int, spec, seeds: dict, dev):
    """Cluster ids of ``m`` queries, or None for the generator's uniform
    draw. ``spec`` is the traffic's ``query_clusters``: "uniform" or
    {"zipf": s}."""
    if spec == "uniform":
        return None
    probs = torch.as_tensor(zipf_probs(clusters, float(spec["zipf"]),
                                       seeds["zipf"]), device=dev)
    return torch.multinomial(probs, m, replacement=True,
                             generator=generator(seeds["zipf"], dev))
