"""Plain PyTorch version of the topk_merge kernel (twin of
``repro.kernels.topk_merge.ref.topk_merge_ref``)."""
import torch


def topk_merge_ref(pool_d, pool_i, pool_v, new_d, new_i):
    """Merge a candidate pool (d [B, L] fp32, id [B, L] int32, visited
    [B, L] bool) with new candidates (d [B, R], id [B, R]) and keep the
    best L by (d, id): a stable lexicographic sort over [pool | new], so
    a full tie on (d, id) keeps the earlier lane first. New lanes carry
    visited=False. No dedup and no padding. Returns (d, id, visited)
    [B, L] each."""
    d = torch.cat([pool_d, new_d], dim=1).float()
    i = torch.cat([pool_i, new_i], dim=1).to(torch.int32)
    v = torch.cat([pool_v.bool(), torch.zeros(new_i.shape, dtype=torch.bool,
                                              device=new_i.device)], dim=1)
    L = pool_d.shape[1]
    # stable lexsort: by id, then stably by distance
    by_id = torch.sort(i, dim=1, stable=True).indices
    by_d = torch.sort(d.gather(1, by_id), dim=1, stable=True).indices
    order = by_id.gather(1, by_d)[:, :L]
    return d.gather(1, order), i.gather(1, order), v.gather(1, order)
