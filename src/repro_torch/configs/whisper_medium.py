"""whisper-medium [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

24 encoder + 24 decoder layers (whisper-medium's published 24/24 stack),
d_model=1024 16H (MHA) d_ff=4096 vocab=51865. The conv frontend is a STUB:
input_specs() provides precomputed frame embeddings [B, S_enc, d_model].
Decoder: causal self-attention + cross-attention over encoder memory. For the
inference shapes, audio is the long modality: prefill_32k encodes a 32k-frame
memory then prefills the decoder; decode_32k decodes one token against a
32k-frame cross-attention memory + decoder self-KV.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_medium", family="encdec",
    n_layers=48, n_enc_layers=24, n_dec_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab=51865,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=4, n_enc_layers=2, n_dec_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
                          d_ff=128, vocab=512, remat_policy="none")
