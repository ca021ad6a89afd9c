"""Plain PyTorch version of the pq_adc kernel (twin of
``repro.kernels.pq_adc.ref.pq_adc_ref``)."""
import torch


def pq_adc_ref(codes, lut, ids):
    """codes [N, m] uint8; lut [B, m, K] fp32 per-query ADC tables; ids
    [B, C] (-1 = invalid lane) -> asymmetric distances [B, C] fp32, +inf
    on invalid lanes: ``d[b, c] = Σ_s lut[b, s, codes[ids[b, c], s]]``.
    Ids are clipped to the table before the gather, and the gathered
    codes become int64 before they index the LUT (a uint8 index tensor
    would be read as a boolean mask)."""
    c = codes[ids.clamp(0, codes.shape[0] - 1)].long()       # [B, C, m]
    d = torch.gather(lut.float(), 2, c.transpose(1, 2))       # [B, m, C]
    return torch.where(ids >= 0, d.sum(1), torch.inf)
