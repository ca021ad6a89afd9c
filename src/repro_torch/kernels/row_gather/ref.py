"""Plain PyTorch version of the row_gather kernel (twin of
``repro.kernels.row_gather.ref.row_gather_ref``)."""
import torch


def row_gather_ref(table, h2s, ids):
    """table [S, R] int32 cached adjacency rows; h2s [N] int32 id->slot
    directory (-1 = non-resident); ids [B, W] int32 (-1 = idle lane) ->
    rows [B, W, R] int32, every lane of a non-resident or idle id set to
    the -1 sentinel. Ids and slots are clipped before each gather."""
    slot = h2s[ids.clamp(0, h2s.shape[0] - 1)]
    ok = (ids >= 0) & (slot >= 0)
    rows = table[slot.clamp(0, table.shape[0] - 1)]
    return torch.where(ok[..., None], rows, -1)
