"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_1b", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_head=64,
    d_ff=512, vocab=49155, n_experts=32, top_k=8, tie_embeddings=True,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=32, vocab=512, n_experts=8, top_k=2,
                          moe_group=64, remat_policy="none")
