"""Plain PyTorch version of the l2_gather kernel (twin of
``repro.kernels.l2_gather.ref.l2_gather_ref``)."""
import torch


def l2_gather_ref(table, ids, queries):
    """table [N,D]; ids [B,K] (-1 = invalid lane); queries [B,D] ->
    squared L2 dists [B,K] fp32, +inf on invalid lanes. Ids are clipped
    to the table before the gather, as the reference's gather clamps."""
    x = table[ids.clamp(0, table.shape[0] - 1)]        # [B, K, D]
    d = x - queries[:, None, :].to(table.dtype)
    out = (d.float() ** 2).sum(-1)
    return torch.where(ids >= 0, out, torch.inf)
