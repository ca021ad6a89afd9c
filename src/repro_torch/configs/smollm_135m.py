"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm_135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_head=64,
    d_ff=1536, vocab=49152, tie_embeddings=True,
)

def smoke_config() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=48, n_heads=3, n_kv_heads=1,
                          d_head=16, d_ff=96, vocab=512, remat_policy="none")
