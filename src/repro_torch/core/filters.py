"""Filtered search (twin of ``repro.core.filters``): the attribute
schema, filter specs and their compiled predicate forms.

* ``AttributeSchema``: the fixed per-index schema, named tag fields
  (small-domain uints, one uint32 membership bitmask each) and named
  numeric fields (fp32). Attributes live in ``tiers.AttributeStore``
  (host truth and a mirror on the device, as ``quant.PQCodes``).
* ``FilterSpec``: one query's predicate, per-tag-field allowed value
  sets and per-numeric-field ``[lo, hi]`` ranges, ANDed across fields.
  Hashable: the coalescer batches requests by ``key()``.
* ``CompiledFilter``: a uint32 bitmask per tag field (unconstrained: all
  ones) and fp32 bounds per numeric field (unconstrained: -inf, +inf).
  ``device_pass_mask`` evaluates it on the attribute mirror into a
  per-id mask that the executor ANDs into its invalid-lane masking;
  ``host_pass`` is its numpy twin, equal bit for bit.
* ``estimate_selectivity``: the host-side sample that routes a query
  below the threshold to the brute-force scan over the matched ids.

Everything but ``device_pass_mask`` is the reference's numpy, copied.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

MAX_TAG_DOMAIN = 32   # membership bitmask rides one uint32 per field


@dataclass(frozen=True)
class AttributeSchema:
    """Fixed per-index attribute schema. ``tag_fields`` hold integer
    values in ``[0, tag_domain)`` (a set-membership bitmask must fit a
    uint32); ``num_fields`` hold fp32 scalars."""

    tag_fields: tuple = ()
    num_fields: tuple = ()
    tag_domain: int = MAX_TAG_DOMAIN

    def __post_init__(self):
        object.__setattr__(self, "tag_fields", tuple(self.tag_fields))
        object.__setattr__(self, "num_fields", tuple(self.num_fields))
        names = self.tag_fields + self.num_fields
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate attribute field names: {names}")
        if not 1 <= self.tag_domain <= MAX_TAG_DOMAIN:
            raise ValueError(
                f"tag_domain must be in [1, {MAX_TAG_DOMAIN}] (one uint32 "
                f"membership bitmask per field), got {self.tag_domain}")

    @property
    def n_tags(self) -> int:
        return len(self.tag_fields)

    @property
    def n_nums(self) -> int:
        return len(self.num_fields)

    def coerce(self, attributes, m: int):
        """Normalize one batch's attribute payload to the store's column
        form: ``(tags [m, n_tags] int32, nums [m, n_nums] fp32)``.
        ``attributes`` may be None (schema defaults: tag 0 / num 0.0), a
        ``(tags, nums)`` pair of arrays in schema field order, or a dict
        of per-field columns keyed by field name (missing fields
        default). Tag values are validated against the domain."""
        tags = np.zeros((m, self.n_tags), np.int32)
        nums = np.zeros((m, self.n_nums), np.float32)
        if attributes is None:
            return tags, nums
        if isinstance(attributes, dict):
            for f, col in attributes.items():
                col = np.asarray(col)
                if col.shape != (m,):
                    raise ValueError(
                        f"attribute column {f!r} must have shape ({m},), "
                        f"got {col.shape}")
                if f in self.tag_fields:
                    tags[:, self.tag_fields.index(f)] = col
                elif f in self.num_fields:
                    nums[:, self.num_fields.index(f)] = col
                else:
                    raise ValueError(f"unknown attribute field {f!r} "
                                     f"(schema: {self.tag_fields} + "
                                     f"{self.num_fields})")
        else:
            t, v = attributes
            if t is not None:
                t = np.asarray(t)
                if t.shape != (m, self.n_tags):
                    raise ValueError(f"tags must have shape "
                                     f"({m}, {self.n_tags}), got {t.shape}")
                tags[:] = t
            if v is not None:
                v = np.asarray(v, np.float32)
                if v.shape != (m, self.n_nums):
                    raise ValueError(f"nums must have shape "
                                     f"({m}, {self.n_nums}), got {v.shape}")
                nums[:] = v
        if self.n_tags and ((tags < 0) | (tags >= self.tag_domain)).any():
            raise ValueError(
                f"tag values must be in [0, {self.tag_domain})")
        return tags, nums

    def to_meta(self) -> dict:
        """JSON-serializable form for the durability manifest."""
        return {"tag_fields": list(self.tag_fields),
                "num_fields": list(self.num_fields),
                "tag_domain": int(self.tag_domain)}

    @classmethod
    def from_meta(cls, meta: dict) -> "AttributeSchema":
        return cls(tag_fields=tuple(meta["tag_fields"]),
                   num_fields=tuple(meta["num_fields"]),
                   tag_domain=int(meta["tag_domain"]))


class FilterSpec:
    """One query's metadata predicate: AND across constrained fields.

    ``tags``: field -> iterable of allowed tag values (set membership).
    ``ranges``: field -> (lo, hi) inclusive numeric bounds (None in
    either slot = unbounded on that side).

    Instances are immutable, hashable and order-insensitive: ``key()``
    is the canonical form the coalescing scheduler batches by —
    requests whose specs key equal may share one executor dispatch;
    anything else dispatches separately.
    """

    __slots__ = ("tags", "ranges", "_key")

    def __init__(self, tags: Optional[dict] = None,
                 ranges: Optional[dict] = None):
        t = {}
        for f, vals in (tags or {}).items():
            vs = frozenset(int(v) for v in vals)
            if not vs:
                raise ValueError(
                    f"empty tag set for field {f!r}: an always-false "
                    f"predicate must be expressed by the caller, not an "
                    f"empty set (likely a bug)")
            t[str(f)] = vs
        r = {}
        for f, bounds in (ranges or {}).items():
            lo, hi = bounds
            lo = -np.inf if lo is None else float(lo)
            hi = np.inf if hi is None else float(hi)
            r[str(f)] = (lo, hi)
        object.__setattr__(self, "tags", t)
        object.__setattr__(self, "ranges", r)
        object.__setattr__(self, "_key", (
            tuple(sorted((f, tuple(sorted(v))) for f, v in t.items())),
            tuple(sorted((f, b) for f, b in r.items()))))

    def __setattr__(self, *_):
        raise AttributeError("FilterSpec is immutable")

    def key(self) -> tuple:
        return self._key

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, FilterSpec) and self._key == other._key

    def __repr__(self):
        return f"FilterSpec(tags={dict(self.tags)!r}, " \
               f"ranges={dict(self.ranges)!r})"


class CompiledFilter(NamedTuple):
    """Schema-resolved device-evaluable predicate: one uint32 membership
    bitmask per tag field and fp32 bound vectors per numeric field
    (unconstrained fields compile to all-ones / ∓inf, so evaluation is
    branch-free across specs of any shape)."""

    tag_masks: np.ndarray   # [n_tags] uint32
    num_lo: np.ndarray      # [n_nums] fp32
    num_hi: np.ndarray      # [n_nums] fp32


def compile_filter(spec: FilterSpec, schema: AttributeSchema
                   ) -> CompiledFilter:
    """Resolve a spec against the index schema. Raises on unknown
    fields or out-of-domain tag values."""
    all_ones = np.uint32((1 << schema.tag_domain) - 1
                         if schema.tag_domain < 32 else 0xFFFFFFFF)
    masks = np.full((schema.n_tags,), all_ones, np.uint32)
    for f, vals in spec.tags.items():
        if f not in schema.tag_fields:
            raise ValueError(f"unknown tag field {f!r} "
                             f"(schema tag fields: {schema.tag_fields})")
        if any(v < 0 or v >= schema.tag_domain for v in vals):
            raise ValueError(f"tag values for {f!r} must be in "
                             f"[0, {schema.tag_domain}), got {sorted(vals)}")
        m = 0
        for v in vals:
            m |= 1 << v
        masks[schema.tag_fields.index(f)] = np.uint32(m)
    lo = np.full((schema.n_nums,), -np.inf, np.float32)
    hi = np.full((schema.n_nums,), np.inf, np.float32)
    for f, (l, h) in spec.ranges.items():
        if f not in schema.num_fields:
            raise ValueError(f"unknown numeric field {f!r} "
                             f"(schema numeric fields: {schema.num_fields})")
        i = schema.num_fields.index(f)
        lo[i], hi[i] = np.float32(l), np.float32(h)
    return CompiledFilter(masks, lo, hi)


def host_pass(cf: CompiledFilter, tags: np.ndarray, nums: np.ndarray
              ) -> np.ndarray:
    """Host-truth predicate evaluation: ``tags [m, n_tags]`` /
    ``nums [m, n_nums]`` -> bool [m]. The numpy twin of
    ``device_pass_mask``, equal bit for bit (integer bit tests and fp32
    compares)."""
    ok = np.ones(len(tags), bool)
    if tags.shape[1]:
        bits = (cf.tag_masks[None, :] >> tags.astype(np.uint32)) & 1
        ok &= (bits != 0).all(axis=1)
    if nums.shape[1]:
        ok &= ((nums >= cf.num_lo) & (nums <= cf.num_hi)).all(axis=1)
    return ok


def device_pass_mask(attrs, cf: CompiledFilter) -> torch.Tensor:
    """Per-id predicate mask evaluated on the attribute store's mirror:
    bool [capacity] on the store's device, which the executor ANDs with
    ``alive``. The reference shifts a uint32 mask right by a uint32 tag;
    torch's uint32 has few CUDA ops, so the masks and tags are widened
    to int64 (the masks fit in 32 bits, the tags are below 32) and the
    result equals ``host_pass`` bit for bit."""
    tags_t, nums_t = attrs.synced()
    dev = tags_t.device
    ok = torch.ones((tags_t.shape[0],), dtype=torch.bool, device=dev)
    if tags_t.shape[1]:
        masks = torch.as_tensor(cf.tag_masks.astype(np.int64), device=dev)
        bits = (masks[None, :] >> tags_t.long()) & 1
        ok &= (bits != 0).all(dim=1)
    if nums_t.shape[1]:
        lo = torch.as_tensor(cf.num_lo, device=dev)
        hi = torch.as_tensor(cf.num_hi, device=dev)
        ok &= ((nums_t >= lo) & (nums_t <= hi)).all(dim=1)
    return ok


def estimate_selectivity(cf: CompiledFilter, attrs, alive, n: int,
                         sample: int = 1024, seed: int = 0) -> float:
    """Cheap host-side selectivity estimate at admission: the passing
    fraction of a uniform sample of alive ids (host truth columns; no
    device round-trip). Deterministic in ``seed``. Returns 1.0 for an
    empty index (nothing to route on)."""
    n = int(n)
    if n <= 0:
        return 1.0
    if n <= sample:
        ids = np.arange(n)
    else:
        ids = np.random.default_rng(seed).integers(0, n, sample)
    live = np.asarray(alive[:n])[ids] if np.ndim(alive) else None
    ok = host_pass(cf, attrs.tags[ids], attrs.nums[ids])
    if live is not None:
        k = int(live.sum())
        if k == 0:
            return 1.0
        return float((ok & live).sum() / k)
    return float(ok.mean())
