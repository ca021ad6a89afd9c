"""falcon-mamba-7b [ssm] — mamba1 arch [arXiv:2410.05355; unverified].

64L d_model=4096 (attention-free) vocab=65024, ssm_state=16, expand=2
(d_inner=8192), conv k=4. Sub-quadratic => long_500k runs for this arch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon_mamba_7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab=65024, d_state=16, d_conv=4, expand=2, tie_embeddings=True,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=64, vocab=512, d_state=4,
                          remat_policy="none", ssm_chunk=8)
