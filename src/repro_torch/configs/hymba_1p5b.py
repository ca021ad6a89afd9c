"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16. Each layer
runs attention and an SSM head bank in parallel on the same input and
mean-fuses their (per-path RMS-normed) outputs. Sliding-window attention
(window 1024) everywhere except 3 global layers (first / middle / last) --
sub-quadratic => long_500k runs for this arch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba_1p5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab=32001, d_state=16, d_conv=4, expand=2,
    swa_window=1024, n_global_layers=3,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, vocab=512, d_state=4,
                          swa_window=16, remat_policy="none", ssm_chunk=8)
