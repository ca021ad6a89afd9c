"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4_mini_3p8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=200064, rope_theta=10000.0,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, vocab=512, remat_policy="none")
