"""Plain PyTorch version of the e_in_count kernel: the port's
``compute_e_in`` formula (twin of ``repro.core.build.compute_e_in``)."""
import torch


def e_in_count_ref(nbrs, n_max):
    """nbrs int32 ids (-1 = empty slot), any shape -> [n_max] int32, the
    number of slots that hold each id. Every -1 lane is clamped to id 0
    and adds 0 there, as in the reference."""
    flat = nbrs.reshape(-1)
    valid = flat >= 0
    return torch.zeros((n_max,), dtype=torch.int32, device=nbrs.device) \
        .index_add_(0, flat.clamp(0, n_max - 1), valid.to(torch.int32))
