"""deepseek-7b [dense] — llama-arch [arXiv:2401.02954; hf].

30L d_model=4096 32H (GQA kv=32 == MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
    d_ff=11008, vocab=102400,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_head=16, d_ff=160, vocab=512, remat_policy="none")
