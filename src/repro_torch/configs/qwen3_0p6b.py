"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, head_dim=128 (decoupled
from d_model as in Qwen3), QK-RMSNorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_0p6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=3072, vocab=151936, qk_norm=True, rope_theta=1e6, tie_embeddings=True,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, vocab=512, remat_policy="none")
