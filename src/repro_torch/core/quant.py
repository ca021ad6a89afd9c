"""Product quantization for the device-resident code lane (twin of
``repro.core.quant``).

D dims split into ``m`` contiguous subspaces of ``dsub = D/m`` dims; each
subspace has its own ``K = 2**bits`` Lloyd codebook, and a vector encodes
to ``m`` uint8 codes. ``adc_lut`` precomputes per query ``lut[s, k] =
||q_s − c_sk||²``; a candidate's distance is then ``Σ_s lut[s, code[x,
s]]`` (``kernels.ops.adc_gather``).

``PQCodes`` is the serving-side lane state: host-truth codes (numpy)
with write-through incremental encoding, and a mirror on the codebook's
device that searches read. Every fp32 contraction here runs with TF32
off.

One difference from the reference: its Lloyd init draws a
``jax.random.permutation``, which torch cannot reproduce; the port
draws from a ``torch.Generator`` seeded alike. The sample draw
(``np.random.default_rng``) and every Lloyd step are the reference's, so
from the same init (``lloyd``) the port trains the same centroids.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch


class PQCodebook(NamedTuple):
    """Per-subspace centroid tables."""
    centroids: torch.Tensor    # [m, K, dsub] float32

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_codes(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub


def choose_m(dim: int, m: int) -> int:
    """Largest divisor of ``dim`` that is <= the requested subspace
    count."""
    m = max(1, min(m, dim))
    while dim % m:
        m -= 1
    return m


def _sqdist_to_centroids(sub, cents):
    """Per-subspace squared distances, shared by training, encoding and
    the ADC LUT so that all three agree: sub [..., m, dsub] vs cents [m,
    K, dsub] -> [..., m, K]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return ((sub * sub).sum(-1)[..., None]
            - 2.0 * torch.einsum("...md,mkd->...mk", sub, cents)
            + (cents * cents).sum(-1))


def lloyd(sub, init, iters: int):
    """Lloyd's k-means from ``init`` [m, K, dsub], vectorized over the m
    subspaces: sub [n, m, dsub]. Empty clusters keep their centroid."""
    c = init
    k = c.shape[1]
    for _ in range(iters):
        assign = _sqdist_to_centroids(sub, c).argmin(-1)        # [n, m]
        onehot = torch.nn.functional.one_hot(assign, k).float()  # [n, m, k]
        cnt = onehot.sum(0)                                      # [m, k]
        sums = torch.einsum("nmk,nmd->mkd", onehot, sub)
        c = torch.where(cnt[..., None] > 0,
                        sums / cnt.clamp(min=1.0)[..., None], c)
    return c


def train_codebook(vectors, m: int, bits: int, *, iters: int = 20,
                   sample: int = 4096, seed: int = 0,
                   device="cuda") -> PQCodebook:
    """Train per-subspace codebooks on (a sample of) the dataset on
    ``device``. bits <= 8 so codes stay uint8."""
    if not 1 <= bits <= 8:
        raise ValueError(f"pq bits must be in [1, 8], got {bits}")
    vectors = np.asarray(vectors, np.float32)
    n, D = vectors.shape
    if D % m:
        raise ValueError(f"dim {D} not divisible by m={m} "
                         f"(use choose_m to pick a divisor)")
    if sample and n > sample:
        idx = np.random.default_rng(seed).choice(n, sample, replace=False)
        vectors = vectors[np.sort(idx)]
        n = len(vectors)
    k = 1 << bits
    sub = torch.as_tensor(vectors, device=device).reshape(n, m, D // m)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    init = sub[perm[torch.arange(k) % n].to(sub.device)].transpose(0, 1)
    return PQCodebook(centroids=lloyd(sub, init, iters))


def encode(codebook: PQCodebook, vectors, chunk: int = 4096) -> np.ndarray:
    """Vectors [n, D] -> codes [n, m] uint8, in chunks that bound the
    [chunk, m, K] distance tensor."""
    vectors = np.asarray(vectors, np.float32)
    cents = codebook.centroids
    m, _, dsub = cents.shape
    out = np.empty((vectors.shape[0], m), np.uint8)
    for s in range(0, len(vectors), chunk):
        part = torch.as_tensor(vectors[s:s + chunk], device=cents.device)
        sub = part.reshape(len(part), m, dsub)
        out[s:s + chunk] = _sqdist_to_centroids(sub, cents).argmin(-1) \
            .to(torch.uint8).cpu().numpy()
    return out


def codebook_to_array(codebook: PQCodebook) -> np.ndarray:
    """Host array form of the frozen centroid tables."""
    return codebook.centroids.cpu().numpy().astype(np.float32)


def codebook_from_array(centroids, device="cuda") -> PQCodebook:
    """The codebook from a centroid array (the reference's
    ``codebook_to_array`` output included)."""
    return PQCodebook(centroids=torch.tensor(
        np.asarray(centroids, np.float32), device=device))


def decode(codebook: PQCodebook, codes) -> np.ndarray:
    """Codes [n, m] -> reconstructed vectors [n, D] float32."""
    codes = np.asarray(codes)
    cents = codebook_to_array(codebook)                        # [m, K, dsub]
    n, m = codes.shape
    out = cents[np.arange(m)[None, :], codes.astype(np.int64)]  # [n, m, dsub]
    return out.reshape(n, m * cents.shape[2]).astype(np.float32)


def adc_lut(centroids, queries):
    """Per-query ADC lookup tables: queries [B, D] -> lut [B, m, K] with
    ``lut[b, s, k] = ||q_sub[b, s] − centroids[s, k]||²``."""
    m, _, dsub = centroids.shape
    qs = queries.float().reshape(queries.shape[0], m, dsub)
    return _sqdist_to_centroids(qs, centroids).contiguous()


class PQCodes:
    """Serving-side PQ lane state: frozen codebook plus codes over the
    whole id space, host truth (numpy) and a mirror on the codebook's
    device.

    Write-through: ``encode_write`` encodes against the frozen codebook
    into the host array and logs the dirty block; ``synced_codes`` folds
    pending blocks into a fresh mirror under a lock (a search holding the
    previous mirror is never torn) and returns it."""

    def __init__(self, codebook: PQCodebook, capacity: int,
                 codes: np.ndarray = None):
        self.codebook = codebook
        self.codes = np.zeros((capacity, codebook.m), np.uint8)
        if codes is not None:
            self.codes[:len(codes)] = codes
        self._codes_t = torch.tensor(self.codes, device=self.device)
        self._dirty: list = []
        self._lock = threading.Lock()
        self.encoded = 0          # rows encoded incrementally (stats)

    @property
    def device(self) -> torch.device:
        return self.codebook.centroids.device

    @property
    def m(self) -> int:
        return self.codebook.m

    @property
    def bits(self) -> int:
        return int(self.codebook.n_codes - 1).bit_length()

    def encode_write(self, ids, vectors) -> np.ndarray:
        """Incremental write-through encode (update stream only)."""
        c = encode(self.codebook, vectors)
        ids = np.asarray(ids)
        with self._lock:
            self.codes[ids] = c
            self._dirty.append(ids.copy())
            self.encoded += len(ids)
        return c

    def synced_codes(self) -> torch.Tensor:
        """Device mirror with all pending write-through blocks applied, in
        ONE scatter into a copy."""
        with self._lock:
            if self._dirty:
                ids = np.unique(np.concatenate(self._dirty))
                t = self._codes_t.clone()
                t[torch.as_tensor(ids, device=t.device)] = torch.as_tensor(
                    self.codes[ids], device=t.device)
                self._codes_t = t
                self._dirty.clear()
            return self._codes_t

    def snapshot(self, n: int) -> np.ndarray:
        """Copy of the host-truth codes over [0, n) for the durability
        snapshot, taken under the write-through lock so that a concurrent
        ``encode_write`` cannot tear it."""
        with self._lock:
            return self.codes[:n].copy()

    def code_bytes(self, n: int = None) -> int:
        """Device-resident code footprint (bytes) over ``n`` ids (whole
        array when None)."""
        if n is None:
            return self.codes.nbytes
        return int(n) * self.codes.shape[1] * self.codes.itemsize
