"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. The vision frontend is
a STUB per assignment: input_specs() provides precomputed patch embeddings;
the LM backbone consumes [patches ; tokens].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2_2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=92553, n_patches=256, rope_theta=1e6,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, vocab=512, n_patches=8,
                          remat_policy="none")
